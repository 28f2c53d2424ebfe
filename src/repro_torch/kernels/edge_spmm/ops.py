"""Wrappers of the incidence SpMM and the node-blocked half-edge layout.

The tensor's device picks the path: a CUDA tensor goes through the
hand-written kernel (``kernel.py``) or the call raises; a CPU tensor goes
through the plain PyTorch twin (``ref.py``).

Both kernels (K1, K2) read one layout, the destination-sorted half-edge
CSR (:class:`EdgeRows`): every live edge (s, t, w) becomes the half-edges
(s <- t, w) and (t <- s, w), sorted stably by destination, so row i lists
its neighbours and weights and ``row_ptr`` (n+1,) bounds it.  Rows longer
than ``HUB_THRESHOLD`` are listed in ``hub_rows`` (ascending, padded with
n), and the kernel splits each of them over a whole thread block.

* :func:`build_edge_rows` builds it from an edge list with torch ops on
  the list's device, without a host sync (a stable sort, so the result
  is deterministic); the kernel path builds it once per edge list
  (``backend.fused_step_fn``, ``backend.edge_arrays_matvec_fn``) and the
  raw :func:`edge_spmm` once per call.  :func:`blocking_rows` builds the
  same CSR from a :class:`NodeBlocking`.
* ``build_node_blocking`` is the host-side (numpy) layout of the JAX
  package, copied so that its arrays come out bitwise equal: edges become
  directed half-edges (u <- o, w) bucketed by the node-block of u into a
  CSR-style chunk list (block b owns ceil(bucket_b / BE) chunks, min 1),
  and only the TOTAL chunk count is pow2-snapped; the padding chunks
  extend the last block's run with zero weight.  The port adds
  ``block_chunks``, the (NB+1,) block -> first-real-chunk offsets.  No
  kernel reads this layout: :func:`edge_spmm_blocked` runs K2 over its
  :func:`blocking_rows`.
* Edge shards (``core.distributed``): shard s of a mesh-padded buffer
  owns its s-th contiguous slice, and its K1/K2 read the row CSR of that
  slice (:func:`build_edge_rows`), whose rows give ``deg_s v - A_s v``.
  ``build_sharded_node_blocking`` is the JAX package's per-shard chunk
  layout, bitwise, whose ``shard(s)`` rows give the same matvec.
* Panel shards (``core.program.build_tick_model_sharded``): shard s owns
  the rows ``[s R, (s + 1) R)`` and every half-edge destined there.
  ``build_model_sharded_blocking`` is the JAX package's layout, bitwise;
  :func:`build_model_shard_rows` builds a shard's row CSR on the card,
  and :func:`model_local_rows` runs K2 over it as a RECTANGULAR launch:
  R output rows whose own terms are a row range of the panel
  (``v_self``) and whose neighbours index all of it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import kernel, ref

# Rows with more half-edges than this go to the kernel's hub blocks: below
# it a row's lanes walk at most this many neighbours one after another,
# and on a small graph the longest such walk is the kernel's time (at 128,
# K1 took 14 us on the 4096-node power-law graph on an H100, PERF.md).
# The builders read it when they list the hub rows and the wrappers pass
# it to the kernel, which leaves those rows to its hub blocks.
HUB_THRESHOLD = 32


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EdgeRows(NamedTuple):
    """Destination-sorted half-edge CSR, the layout K1 and K2 read."""

    row_ptr: torch.Tensor  # (n+1,) int32 - row i is [row_ptr[i], row_ptr[i+1])
    other: torch.Tensor  # (S,) int32 - neighbour per entry; S >= row_ptr[n]
    weight: torch.Tensor  # (S,) float32 - entries past row_ptr[n] are dead
    hub_rows: torch.Tensor  # (H+1,) int32 - rows > HUB_THRESHOLD, then n's


def _sorted_rows(u: torch.Tensor, o: torch.Tensor, w: torch.Tensor,
                 n: int) -> EdgeRows:
    """The row CSR of half-edges (u <- o, w), stably sorted by u, with no
    host sync: dead (zero-weight) half-edges sort past the last row, and
    the hub list has room for every row the threshold can admit
    (min(n, S // (threshold + 1)) of them, then one n)."""
    dev = u.device
    key, order = torch.sort(torch.where(w != 0, u.long(), n), stable=True)
    row_ptr = torch.searchsorted(key, torch.arange(n + 1, device=dev))
    hub = (row_ptr[1:] - row_ptr[:-1]) > HUB_THRESHOLD
    cap = min(n, key.shape[0] // (HUB_THRESHOLD + 1))
    hub_rows = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    # non-hub rows all write the sentinel n to the last slot
    hub_rows.scatter_(0, torch.where(hub, torch.cumsum(hub, 0) - 1, cap),
                      torch.where(hub, torch.arange(n, device=dev), n).int())
    return EdgeRows(row_ptr=row_ptr.int(), other=o.int()[order],
                    weight=w.float()[order], hub_rows=hub_rows)


def build_edge_rows(src: torch.Tensor, dst: torch.Tensor,
                    weight: torch.Tensor, num_nodes: int) -> EdgeRows:
    """The row CSR of an edge list, on the list's device."""
    return _sorted_rows(torch.cat([src, dst]), torch.cat([dst, src]),
                        torch.cat([weight, weight]), int(num_nodes))


def _row_spmm(launch, rows: EdgeRows, v: torch.Tensor, alpha, beta,
              v_self: torch.Tensor | None = None) -> torch.Tensor:
    """``launch`` (K1 or K2) on a CUDA panel, the plain twin on a CPU one;
    (n,) panels (and their ``v_self``) round-trip through a column."""
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
        v_self = None if v_self is None else v_self[:, None]
    if v.device.type == "cuda":
        out = launch(rows.row_ptr, rows.other, rows.weight, rows.hub_rows,
                     v.float().contiguous(), alpha, beta,
                     hub_threshold=HUB_THRESHOLD,
                     v_self=None if v_self is None
                     else v_self.float().contiguous())
    else:
        out = ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                 v.float(), alpha, beta,
                                 None if v_self is None else v_self.float())
    return out[:, 0] if squeeze else out


def edge_spmm_rows(rows: EdgeRows, v: torch.Tensor, alpha=1.0, beta=0.0,
                   v_self: torch.Tensor | None = None) -> torch.Tensor:
    """alpha * (L V) + beta * V over a row CSR: K1 on the card, the plain
    twin on the CPU.  Accepts (n,) or (n, k) panels.  ``v_self`` makes
    the launch rectangular (see :func:`edge_spmm_rows_nb`)."""
    return _row_spmm(kernel.edge_spmm, rows, v, alpha, beta, v_self)


def edge_spmm_rows_nb(rows: EdgeRows, v: torch.Tensor, alpha=1.0, beta=0.0,
                      v_self: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`edge_spmm_rows` launched as K2, the node-blocked SpMM's
    counterpart (same body, its own launch count).  With ``v_self`` the
    CSR's R rows are a panel shard's owned rows: ``v_self`` (R, k) holds
    their own terms and ``v`` is the whole panel their neighbours index
    (:func:`model_local_rows`)."""
    return _row_spmm(kernel.edge_spmm_nb, rows, v, alpha, beta, v_self)


def edge_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              v: torch.Tensor, alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha * (sum_e w_e x_e x_e^T V) + beta * V; default plain matvec.

    The raw per-call entry: it builds the row CSR of ``(src, dst, w)``
    (:func:`build_edge_rows`) and runs :func:`edge_spmm_rows` on it.
    Callers that reuse an edge list build the CSR once instead.  Accepts
    (n,) or (n, k) panels.  An edgeless input returns beta * V.
    """
    rows = build_edge_rows(src, dst, w, v.shape[0])
    return edge_spmm_rows(rows, v, alpha, beta)


class NodeBlocking(NamedTuple):
    """Node-blocked half-edge layout of the JAX package.

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


def uniform_chunks_for_counts(counts, block_e: int,
                              snap_chunks: bool = True) -> int:
    """Chunks per block under the LEGACY uniform layout (every block
    pays the worst bucket, pow2-snapped), the JAX package's comparison
    baseline for the skew property tests."""
    c = max(int(np.ceil(counts.max(initial=0) / block_e)), 1)
    return next_pow2(c) if snap_chunks else c


def uniform_padded_half_edges(counts, block_e: int,
                              snap_chunks: bool = True) -> int:
    """Half-edge slots the legacy uniform layout would walk:
    num_blocks * max-chunks * block_e."""
    nb = int(np.asarray(counts).shape[0])
    return nb * uniform_chunks_for_counts(counts, block_e, snap_chunks) \
        * block_e


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


class ShardedNodeBlocking(NamedTuple):
    """Per-shard node-blocked layouts of the JAX package, for a mesh of
    edge shards.

    The edge buffer splits into ``num_shards`` contiguous slices and each
    slice is bucketed on its own, as :func:`build_node_blocking` buckets
    the whole buffer; all shards share ONE pow2-snapped chunk count.
    Shard s computes ``L_s v = deg_s v - A_s v`` from its own edges, so
    the all_reduce of the shards' panels is ``L v``; a shard whose slice
    is all padding gets an all-zero layout of the same shapes.  No kernel
    reads it: a shard's K2 runs over ``blocking_rows(sb.shard(s))``.
    """

    u_local: torch.Tensor  # (S, NC*BE) int32 - dest index local to block
    other: torch.Tensor  # (S, NC*BE) int32 - global source node
    weight: torch.Tensor  # (S, NC*BE) float32 - 0 => padding slot
    chunk_block: torch.Tensor  # (S, NC+1) int32 - per-shard chunk->block map
    deg: torch.Tensor  # (S, NB*block_n) float32 - PER-SHARD weighted degrees
    block_n: int
    block_e: int
    num_chunks: int  # NC, TOTAL chunks, shared across shards
    num_nodes: int  # real node count n
    num_shards: int  # S
    block_chunks: torch.Tensor  # (S, NB+1) int32 - first real chunk per block

    @property
    def num_blocks(self) -> int:
        return self.deg.shape[1] // self.block_n

    @property
    def padded_nodes(self) -> int:
        return self.deg.shape[1]

    def shard(self, s: int) -> NodeBlocking:
        """Shard s's own layout, what its rank computes with."""
        return shard_local_blocking(
            self.u_local[s:s + 1], self.other[s:s + 1], self.weight[s:s + 1],
            self.chunk_block[s:s + 1], self.deg[s:s + 1],
            self.block_chunks[s:s + 1], **self.statics)

    @property
    def statics(self) -> dict:
        """The layout's ints, as kwargs for :func:`shard_local_blocking`."""
        return dict(block_n=self.block_n, block_e=self.block_e,
                    num_chunks=self.num_chunks, num_nodes=self.num_nodes)


def shard_local_blocking(u_local, other, weight, chunk_block, deg,
                         block_chunks, *, block_n: int, block_e: int,
                         num_chunks: int, num_nodes: int) -> NodeBlocking:
    """One shard's NodeBlocking from (1, ...) slices of a
    :class:`ShardedNodeBlocking`'s stacked arrays (leading shard axis of
    size 1, as a shard_map body sees them in the JAX package)."""
    return NodeBlocking(
        u_local=u_local[0], other=other[0], weight=weight[0],
        chunk_block=chunk_block[0], deg=deg[0], block_n=block_n,
        block_e=block_e, num_chunks=num_chunks, num_nodes=num_nodes,
        block_chunks=block_chunks[0])


def build_sharded_node_blocking(src, dst, weight, num_nodes: int,
                                num_shards: int, *, block_n: int = 512,
                                block_e: int = 128, device=None
                                ) -> ShardedNodeBlocking:
    """Host-side per-shard node blockings of a mesh-padded edge buffer,
    bitwise the JAX package's, on ``device`` (``None`` = the card).

    ``len(src)`` must divide by ``num_shards`` (pad with
    ``core.distributed.pad_edges_for_mesh``); shard s owns the s-th
    contiguous slice.  The chunk count is the worst shard's, pow2-snapped,
    so an all-padding shard still has the shared shapes (zero weights and
    degrees)."""
    dev = resolve_device(device)
    src = _host(src).astype(np.int64)
    dst = _host(dst).astype(np.int64)
    weight = _host(weight).astype(np.float32)
    e = src.shape[0]
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if e % num_shards != 0:
        raise ValueError(
            f"edge buffer ({e}) does not divide into {num_shards} shards;"
            " pad with distributed.pad_edges_for_mesh first")
    per = e // num_shards
    nb = max((num_nodes + block_n - 1) // block_n, 1)
    n_pad = nb * block_n
    sl = [slice(s * per, (s + 1) * per) for s in range(num_shards)]
    shards = [_block_sorted_half_edges(src[x], dst[x], weight[x], block_n, nb)
              for x in sl]
    nc = next_pow2(max(int(_chunk_counts(counts, block_e).sum())
                       for _, _, _, counts in shards))
    ul = np.zeros((num_shards, nc * block_e), np.int32)
    ot = np.zeros((num_shards, nc * block_e), np.int32)
    wt = np.zeros((num_shards, nc * block_e), np.float32)
    cb = np.zeros((num_shards, nc + 1), np.int32)
    deg = np.zeros((num_shards, n_pad), np.float32)
    bc = np.zeros((num_shards, nb + 1), np.int32)
    for s, (u, o, w2, counts) in enumerate(shards):
        ul[s], ot[s], wt[s], cb[s] = _fill_chunked(
            u, o, w2, counts, nb, nc, block_n, block_e)
        deg[s] = _weighted_degrees(src[sl[s]], dst[sl[s]], weight[sl[s]], n_pad)
        bc[s] = block_chunk_offsets(counts, block_e)
    return ShardedNodeBlocking(
        u_local=torch.from_numpy(ul).to(dev),
        other=torch.from_numpy(ot).to(dev),
        weight=torch.from_numpy(wt).to(dev),
        chunk_block=torch.from_numpy(cb).to(dev),
        deg=torch.from_numpy(deg).to(dev),
        block_n=block_n,
        block_e=block_e,
        num_chunks=nc,
        num_nodes=int(num_nodes),
        num_shards=int(num_shards),
        block_chunks=torch.from_numpy(bc).to(dev),
    )


class ModelShardedBlocking(NamedTuple):
    """DESTINATION-aligned per-shard layouts of the JAX package, for
    panel (model-axis) sharding.

    Where :class:`ShardedNodeBlocking` splits the edge buffer, this splits
    the node range: shard s owns panel rows ``[s R, (s + 1) R)`` and every
    live half-edge whose destination is one of them, so its rows of ``L
    v`` are final and a collective only assembles disjoint row ranges.
    ``u_local`` and ``chunk_block`` are local to the shard's own blocks,
    ``other`` stays global, ``deg`` holds the full degrees of the shard's
    rows, and all shards share one pow2-snapped chunk count.  No kernel
    reads it: a shard's K2 runs over ``blocking_rows(mb.shard(s))`` (or
    :func:`build_model_shard_rows`, the same rows built on the card).
    """

    u_local: torch.Tensor  # (S, NC*BE) int32 - dest local to its block
    other: torch.Tensor  # (S, NC*BE) int32 - GLOBAL source node
    weight: torch.Tensor  # (S, NC*BE) float32 - 0 => padding slot
    chunk_block: torch.Tensor  # (S, NC+1) int32 - shard-local block map
    deg: torch.Tensor  # (S, R) float32 - full degrees of the shard's rows
    block_n: int
    block_e: int
    num_chunks: int  # NC, shared across shards
    num_nodes: int  # real node count n
    num_shards: int  # S
    block_chunks: torch.Tensor  # (S, NBs+1) int32 - first real chunk per block

    @property
    def rows_per_shard(self) -> int:
        return self.deg.shape[1]

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.deg.shape[1]

    @property
    def num_blocks(self) -> int:
        """Blocks per shard."""
        return self.deg.shape[1] // self.block_n

    @property
    def padded_half_edges(self) -> int:
        """Half-edge slots across shards."""
        return self.num_shards * self.num_chunks * self.block_e

    def shard(self, s: int) -> NodeBlocking:
        """Shard s's layout in its LOCAL node coordinates (``num_nodes``
        is its row count R)."""
        return model_shard_local_blocking(
            self.u_local[s:s + 1], self.other[s:s + 1], self.weight[s:s + 1],
            self.chunk_block[s:s + 1], self.deg[s:s + 1],
            self.block_chunks[s:s + 1], **self.statics)

    @property
    def statics(self) -> dict:
        """The layout's ints, as kwargs for :func:`model_shard_local_blocking`."""
        return dict(block_n=self.block_n, block_e=self.block_e,
                    num_chunks=self.num_chunks, num_nodes=self.num_nodes,
                    num_shards=self.num_shards)


def model_shard_local_blocking(u_local, other, weight, chunk_block, deg,
                               block_chunks, *, block_n: int, block_e: int,
                               num_chunks: int, num_nodes: int,
                               num_shards: int) -> NodeBlocking:
    """One shard's local-coordinate NodeBlocking from (1, ...) slices of a
    :class:`ModelShardedBlocking`'s stacked arrays; ``num_nodes`` of the
    result is the shard's ROW count, not the global n."""
    del num_nodes, num_shards  # the statics travel for key symmetry only
    return NodeBlocking(
        u_local=u_local[0], other=other[0], weight=weight[0],
        chunk_block=chunk_block[0], deg=deg[0], block_n=block_n,
        block_e=block_e, num_chunks=num_chunks, num_nodes=deg.shape[1],
        block_chunks=block_chunks[0])


def model_rows_per_shard(num_nodes: int, num_shards: int,
                         block_n: int = 512) -> int:
    """R, the panel rows each of ``num_shards`` shards owns: the node
    blocks, padded to a multiple of the shards, split evenly."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    nb_real = max((num_nodes + block_n - 1) // block_n, 1)
    return (nb_real + num_shards - 1) // num_shards * block_n


def build_model_sharded_blocking(src, dst, weight, num_nodes: int,
                                 num_shards: int, *, block_n: int = 512,
                                 block_e: int = 128, device=None
                                 ) -> ModelShardedBlocking:
    """Host-side destination-aligned layouts, bitwise the JAX package's,
    on ``device`` (``None`` = the card).  The node blocks are padded to a
    multiple of ``num_shards`` and assigned contiguously; every live
    half-edge lands on the shard owning its destination row.  Any edge
    buffer works (zero-weight slots are dropped)."""
    dev = resolve_device(device)
    src, dst, weight = _host(src), _host(dst), _host(weight)
    rows = model_rows_per_shard(num_nodes, num_shards, block_n)
    nb_per = rows // block_n
    nb_total = nb_per * num_shards
    n_pad = nb_total * block_n
    u, o, w2, counts = _block_sorted_half_edges(src, dst, weight, block_n,
                                                nb_total)
    deg_full = _weighted_degrees(src, dst, weight, n_pad)
    offs = np.concatenate([[0], np.cumsum(counts)])
    per = [counts[s * nb_per:(s + 1) * nb_per] for s in range(num_shards)]
    nc = next_pow2(max(int(_chunk_counts(c, block_e).sum()) for c in per))
    ul = np.zeros((num_shards, nc * block_e), np.int32)
    ot = np.zeros((num_shards, nc * block_e), np.int32)
    wt = np.zeros((num_shards, nc * block_e), np.float32)
    cb = np.zeros((num_shards, nc + 1), np.int32)
    bc = np.zeros((num_shards, nb_per + 1), np.int32)
    for s in range(num_shards):
        lo, hi = offs[s * nb_per], offs[(s + 1) * nb_per]
        ul[s], ot[s], wt[s], cb[s] = _fill_chunked(
            u[lo:hi] - s * rows, o[lo:hi], w2[lo:hi], per[s], nb_per, nc,
            block_n, block_e)
        bc[s] = block_chunk_offsets(per[s], block_e)
    return ModelShardedBlocking(
        u_local=torch.from_numpy(ul).to(dev),
        other=torch.from_numpy(ot).to(dev),
        weight=torch.from_numpy(wt).to(dev),
        chunk_block=torch.from_numpy(cb).to(dev),
        deg=torch.from_numpy(deg_full.reshape(num_shards, rows)).to(dev),
        block_n=block_n,
        block_e=block_e,
        num_chunks=nc,
        num_nodes=int(num_nodes),
        num_shards=int(num_shards),
        block_chunks=torch.from_numpy(bc).to(dev),
    )


def build_model_shard_rows(src: torch.Tensor, dst: torch.Tensor,
                           weight: torch.Tensor, num_nodes: int,
                           num_shards: int, shard: int, *,
                           block_n: int = 512) -> EdgeRows:
    """The row CSR of shard ``shard``'s owned rows, built on the edge
    list's device with no host round trip: the half-edges whose
    destination lies in ``[shard R, (shard + 1) R)``
    (:func:`model_rows_per_shard`), in local row coordinates, with global
    neighbours.  Its live entries equal ``blocking_rows`` of the JAX
    layout's ``shard(shard)``; the other half-edges sort past the last
    row as dead slots."""
    rows = model_rows_per_shard(num_nodes, num_shards, block_n)
    start = shard * rows
    u = torch.cat([src, dst]).long()
    w = torch.cat([weight, weight])
    owned = (u >= start) & (u < start + rows)
    return _sorted_rows(u - start, torch.cat([dst, src]),
                        torch.where(owned, w, torch.zeros_like(w)), rows)


def model_local_rows(rows: EdgeRows, v_full: torch.Tensor, alpha, beta,
                     row_start: int, *, use_kernel: bool = True
                     ) -> torch.Tensor:
    """This shard's (R, k) OWNED rows of ``alpha * (L V) + beta * V``.

    ``rows`` is the shard's row CSR (local rows, global neighbours:
    ``blocking_rows(mb.shard(s))`` or :func:`build_model_shard_rows`),
    ``v_full`` the whole replicated panel and ``row_start`` the first
    global row the shard owns (rows past ``v_full``'s end are zero
    padding).  The rows are final, so the epilogue's AXPY applies here:
    on the card one rectangular K2 launch with ``v_self =
    v_full[row_start : row_start + R]``, as the JAX package always takes
    its node-blocked kernel here; on the CPU, or with ``use_kernel=False``
    (the JAX package's segment form) on any device, the plain twin."""
    r = rows.row_ptr.shape[0] - 1
    short = row_start + r - v_full.shape[0]
    if short > 0:
        v_full = torch.cat([v_full, v_full.new_zeros(
            (short,) + tuple(v_full.shape[1:]))])
    v_self = v_full[row_start:row_start + r]
    if not use_kernel:
        return ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                  v_full.float(), alpha, beta,
                                  v_self.float())
    return edge_spmm_rows_nb(rows, v_full, alpha, beta, v_self=v_self)


def blocking_rows(nb: NodeBlocking) -> EdgeRows:
    """The row CSR of a blocking's live half-edges, on its device.  The
    slots hold the edge list's half-edges in block order, and a stable
    sort by destination undoes that order, so this equals
    :func:`build_edge_rows` of the edge list on the live entries."""
    slot_block = nb.chunk_block[:nb.num_chunks].long().repeat_interleave(
        nb.block_e)
    return _sorted_rows(slot_block * nb.block_n + nb.u_local, nb.other,
                        nb.weight, nb.num_nodes)


def edge_spmm_blocked(nb: NodeBlocking, v: torch.Tensor,
                      alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha * (L V) + beta * V over the blocking's row CSR
    (:func:`blocking_rows`, built per call): K2 on the card, the plain row
    twin on the CPU.  Callers that reuse a blocking build its rows once
    and call :func:`edge_spmm_rows_nb`.

    Accepts (n,) or (n, k) with n == nb.num_nodes.
    """
    if v.shape[0] != nb.num_nodes:
        raise ValueError(
            f"panel rows {v.shape[0]} != blocking num_nodes {nb.num_nodes}")
    return edge_spmm_rows_nb(blocking_rows(nb), v, alpha, beta)
