"""Wrappers of the incidence SpMM and the node-blocked half-edge layout.

The tensor's device picks the path: a CUDA tensor goes through the
hand-written kernel (``kernel.py``) or the call raises; a CPU tensor goes
through the plain PyTorch twin (``ref.py``).

``build_node_blocking`` is the host-side (numpy) layout of the JAX
package, copied so that its arrays come out bitwise equal: edges become
directed half-edges (u <- o, w) bucketed by the node-block of u into a
CSR-style chunk list (block b owns ceil(bucket_b / BE) chunks, min 1),
and only the TOTAL chunk count is pow2-snapped; the padding chunks
extend the last block's run with zero weight.  The port adds one field,
``block_chunks``: the (NB+1,) block -> first-chunk offsets of the REAL
chunks, so the kernel's block b walks ``[block_chunks[b],
block_chunks[b+1])`` and never the padding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import kernel, ref


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def edge_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              v: torch.Tensor, alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha * (sum_e w_e x_e x_e^T V) + beta * V; default plain matvec.

    Accepts (n,) or (n, k) panels (1-D round-trips through a column).  An
    edgeless input returns beta * V on both paths.
    """
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    if v.device.type == "cuda":
        out = kernel.edge_spmm(src, dst, w.float(), v.float().contiguous(),
                               alpha, beta)
    else:
        out = ref.edge_spmm_affine(src, dst, w.float(), v.float(), alpha, beta)
    return out[:, 0] if squeeze else out


class NodeBlocking(NamedTuple):
    """Node-blocked half-edge layout for ``edge_spmm_blocked``.

    The first nine fields are those of the JAX package's NodeBlocking and
    hold the same values; ``block_chunks`` is derived host-side from the
    same per-block chunk counts.
    """

    u_local: torch.Tensor  # (NC*BE,) int32 - dest index local to its block
    other: torch.Tensor  # (NC*BE,) int32 - global source node per half-edge
    weight: torch.Tensor  # (NC*BE,) float32 - 0 => padding slot
    chunk_block: torch.Tensor  # (NC+1,) int32 - block per chunk + tail sentinel
    deg: torch.Tensor  # (NB*block_n,) float32 - weighted degrees, row-padded
    block_n: int  # nodes per block
    block_e: int  # half-edges per chunk
    num_chunks: int  # NC, TOTAL chunks (pow2-snapped)
    num_nodes: int  # real node count n; NB = ceil(n / block_n)
    block_chunks: torch.Tensor  # (NB+1,) int32 - first real chunk per block

    @property
    def num_blocks(self) -> int:
        return self.deg.shape[0] // self.block_n

    @property
    def padded_nodes(self) -> int:
        return self.deg.shape[0]

    @property
    def padded_half_edges(self) -> int:
        """Half-edge slots of the layout (live + padding)."""
        return self.num_chunks * self.block_e


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(np.ceil(np.log2(max(int(x), 1)))), 0)


def _block_sorted_half_edges(src, dst, weight, block_n: int, nb: int):
    """Live edges -> directed half-edges sorted by destination node-block.

    Returns (u, o, w2, counts): half-edge destination/source/weight in
    deterministic block order plus per-block half-edge counts.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    live = weight != 0.0
    src, dst, weight = src[live], dst[live], weight[live]
    u = np.concatenate([src, dst])
    o = np.concatenate([dst, src])
    w2 = np.concatenate([weight, weight])
    blk = u // block_n
    order = np.argsort(blk, kind="stable")  # deterministic layout
    counts = np.bincount(blk[order], minlength=nb)
    return u[order], o[order], w2[order], counts


def _chunk_counts(counts, block_e: int):
    """Per-block chunk counts: ceil(bucket / BE), min 1."""
    counts = np.asarray(counts, np.int64)
    return np.maximum((counts + block_e - 1) // block_e, 1)


def _fill_chunked(u, o, w2, counts, nb: int, nc: int,
                  block_n: int, block_e: int):
    """Scatter block-sorted half-edges into the CSR chunk layout.

    Returns (u_local, other, weight, chunk_block) with flat (nc*BE,)
    half-edge arrays and the (nc+1,) chunk->block map; unfilled slots stay
    zero-weight and padding chunks extend the last block's run.
    """
    cb_counts = _chunk_counts(counts, block_e)
    chunk_off = np.concatenate([[0], np.cumsum(cb_counts)])
    nc_raw = int(chunk_off[-1])
    if nc < nc_raw:
        raise ValueError(f"{nc} chunks cannot hold the {nc_raw} real ones")
    ul = np.zeros((nc * block_e,), np.int32)
    ot = np.zeros((nc * block_e,), np.int32)
    wt = np.zeros((nc * block_e,), np.float32)
    total = u.shape[0]
    if total:
        offs = np.concatenate([[0], np.cumsum(counts)])
        blk_of = np.repeat(np.arange(nb, dtype=np.int64), counts)
        within = np.arange(total, dtype=np.int64) - offs[blk_of]
        slot = chunk_off[blk_of] * block_e + within
        ul[slot] = (u - blk_of * block_n).astype(np.int32)
        ot[slot] = o.astype(np.int32)
        wt[slot] = w2
    chunk_block = np.full((nc + 1,), nb - 1, np.int32)
    chunk_block[:nc_raw] = np.repeat(np.arange(nb, dtype=np.int32), cb_counts)
    return ul, ot, wt, chunk_block


def _weighted_degrees(src, dst, weight, n_pad: int):
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    live = weight != 0.0
    deg = np.zeros((n_pad,), np.float32)
    np.add.at(deg, src[live], weight[live])
    np.add.at(deg, dst[live], weight[live])
    return deg


def block_chunk_offsets(counts, block_e: int) -> np.ndarray:
    """(NB+1,) int32 offsets of each block's real chunks in the layout."""
    return np.concatenate(
        [[0], np.cumsum(_chunk_counts(counts, block_e))]).astype(np.int32)


def build_node_blocking(src, dst, weight, num_nodes: int,
                        *, block_n: int = 512, block_e: int = 128,
                        device=None) -> NodeBlocking:
    """Host-side (numpy) bucketing of edges by destination node-block.

    ``src``/``dst``/``weight`` may be tensors (copied to the host) or numpy
    arrays; the layout lands on ``device`` (``None`` = the CUDA card).
    Zero-weight slots are dropped.
    """
    dev = resolve_device(device)
    src, dst, weight = _host(src), _host(dst), _host(weight)
    nb = max((num_nodes + block_n - 1) // block_n, 1)
    n_pad = nb * block_n
    u, o, w2, counts = _block_sorted_half_edges(src, dst, weight, block_n, nb)
    nc_raw = int(_chunk_counts(counts, block_e).sum())
    nc = next_pow2(nc_raw)
    ul, ot, wt, cb = _fill_chunked(u, o, w2, counts, nb, nc, block_n, block_e)
    deg = _weighted_degrees(src, dst, weight, n_pad)
    return NodeBlocking(
        u_local=torch.from_numpy(ul).to(dev),
        other=torch.from_numpy(ot).to(dev),
        weight=torch.from_numpy(wt).to(dev),
        chunk_block=torch.from_numpy(cb).to(dev),
        deg=torch.from_numpy(deg).to(dev),
        block_n=block_n,
        block_e=block_e,
        num_chunks=nc,
        num_nodes=int(num_nodes),
        block_chunks=torch.from_numpy(block_chunk_offsets(counts, block_e)).to(dev),
    )


def edge_spmm_blocked(nb: NodeBlocking, v: torch.Tensor,
                      alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha * (L V) + beta * V over the node-blocked layout.

    Accepts (n,) or (n, k) with n == nb.num_nodes.
    """
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    if v.shape[0] != nb.num_nodes:
        raise ValueError(
            f"panel rows {v.shape[0]} != blocking num_nodes {nb.num_nodes}")
    args = (nb.u_local, nb.other, nb.weight, nb.block_chunks, nb.deg)
    if v.device.type == "cuda":
        out = kernel.edge_spmm_nb(*args, v.float().contiguous(), alpha, beta,
                                  block_n=nb.block_n, block_e=nb.block_e)
    else:
        out = ref.edge_spmm_blocked(*args, v.float(), alpha, beta,
                                    block_n=nb.block_n, block_e=nb.block_e)
    return out[:, 0] if squeeze else out
