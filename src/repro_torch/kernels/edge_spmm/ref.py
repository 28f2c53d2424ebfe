"""Plain PyTorch versions of the incidence SpMM (the kernels' twins)."""
import torch


def edge_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Y = sum_e w_e x_e (x_e^T V) via gather + ``index_add_``."""
    src, dst = src.long(), dst.long()
    diff = v.index_select(0, src) - v.index_select(0, dst)
    wd = w[:, None] * diff
    out = torch.zeros_like(v)
    out.index_add_(0, src, wd)
    out.index_add_(0, dst, -wd)
    return out


def edge_spmm_affine(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     v: torch.Tensor, alpha, beta) -> torch.Tensor:
    """alpha * (L V) + beta * V, the plain form of the fused epilogue."""
    return alpha * edge_spmm(src, dst, w, v) + beta * v


def edge_spmm_blocked(u_local: torch.Tensor, other: torch.Tensor,
                      w: torch.Tensor, block_chunks: torch.Tensor,
                      deg: torch.Tensor, v: torch.Tensor, alpha, beta,
                      *, block_n: int, block_e: int) -> torch.Tensor:
    """Plain twin of the node-blocked kernel over the SAME layout arrays:
    out = alpha * (deg * V - A V) + beta * V, where A V sums, over the real
    chunks of each block (``block_chunks``), w * V[other] into the
    block's row ``u_local``.  Padding chunks are never read."""
    n, k = v.shape
    nb = block_chunks.shape[0] - 1
    counts = (block_chunks[1:] - block_chunks[:-1]).long()
    real = int(block_chunks[-1])
    blk = torch.repeat_interleave(
        torch.arange(nb, device=v.device), counts * block_e)
    ul, ot, wt = (a[: real * block_e] for a in (u_local, other, w))
    dest = blk * block_n + ul.long()
    av = torch.zeros((nb * block_n, k), dtype=v.dtype, device=v.device)
    av.index_add_(0, dest, wt[:, None] * v[ot.long()])
    lv = deg[:n, None] * v - av[:n]
    return alpha * lv + beta * v


def edge_spmm_rows(row_ptr: torch.Tensor, other: torch.Tensor,
                   w: torch.Tensor, v: torch.Tensor, alpha,
                   beta, v_self: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the row-gather kernel over the SAME row CSR:
    out = alpha * (deg * Vs - A V) + beta * Vs, where row i's entries
    ``[row_ptr[i], row_ptr[i+1])`` give both A V (w * V[other] summed into
    row i) and deg_i (their weights summed).  Vs is ``v_self``, the (n, k)
    rows' own terms of a rectangular CSR (a panel shard's owned rows,
    whose neighbours index the whole panel V), or V itself.  Entries past
    ``row_ptr[n]`` are never read."""
    if v_self is None:
        v_self = v
    n = v_self.shape[0]
    live = int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n, device=v.device), (row_ptr[1:] - row_ptr[:-1]).long(),
        output_size=live)
    wt = w[:live]
    av = torch.zeros_like(v_self).index_add_(
        0, rows, wt[:, None] * v[other[:live].long()])
    deg = torch.zeros((n,), dtype=v.dtype, device=v.device).index_add_(0, rows, wt)
    return alpha * (deg[:, None] * v_self - av) + beta * v_self
