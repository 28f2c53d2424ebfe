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
