"""Mutable edge store with padded capacity classes.

The streaming session's ground truth for each graph.  Shapes never
depend on the live edge count: the edge buffer is padded to a CAPACITY
CLASS (a power of two), and mutations are fixed-size batched upserts.

Slot convention: ``weight == 0``  <=>  the slot is free.  A free slot
contributes nothing to any edge-wise computation (the contract of
:func:`repro_torch.core.laplacian.pad_edge_list`), so
``as_edge_list(store)`` feeds every operator of the port unchanged.

Degrees are cached and recomputed lazily: mutations only set
``deg_dirty``; :func:`refresh_degrees` recomputes the next time degrees
are needed (spectral-radius bound, dilation scale).  The row CSR the
kernels read (:func:`edge_rows`), the row CSR of a rank's shard of the
buffer (:func:`shard_edge_rows`) and of a rank's owned panel rows
(:func:`model_shard_rows`), are cached per store the same way; every
mutation returns a new store whose cache is empty.

:func:`apply_edge_batch` gives the JAX package's results bit for bit
without its (B, capacity) match: it sorts the live slots' keys
``src * n + dst`` once (stable, so the lowest slot of equal keys comes
first) and looks the batch's keys up by binary search, O(capacity) work
and memory per batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.core import backend as backend_mod
from repro_torch.core.laplacian import EdgeList
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import ops as es_ops

# Edge-buffer capacity ladder (powers of two), the JAX package's: few
# classes keep shapes few; the top rungs (2^25, 2^26) hold a streamed
# million-node power-law graph.
CAPACITY_CLASSES = tuple(2 ** p for p in range(8, 27))


def capacity_class(num_edges: int, headroom: float = 1.5) -> int:
    """Smallest ladder capacity >= num_edges * headroom."""
    want = max(int(np.ceil(num_edges * headroom)), 1)
    for c in CAPACITY_CLASSES:
        if c >= want:
            return c
    raise ValueError(f"{num_edges} edges exceeds the capacity ladder")


@dataclasses.dataclass(frozen=True)
class GraphStore:
    """Fixed-capacity mutable graph."""

    src: torch.Tensor  # (cap,) int32, src < dst for live slots
    dst: torch.Tensor  # (cap,) int32
    weight: torch.Tensor  # (cap,) float32; 0 => slot free
    deg: torch.Tensor  # (num_nodes,) float32 cached weighted degrees
    deg_dirty: bool  # True => deg is stale
    num_nodes: int  # may itself be a padded node capacity
    # derived layouts of these buffers (the row CSR); a new store starts empty
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device


class EdgeBatch(NamedTuple):
    """A fixed-size batch of edge mutations (canonicalized on build).

    mode="set": upsert the edge (src, dst) to ``weight``; 0 deletes.
    mode="add": add ``weight`` to the current weight (inserting if
    absent; reaching exactly 0 deletes).  Entries must have UNIQUE
    canonical pairs (:func:`coalesce_batch` for raw streams).  Padding
    entries (0, 0, 0) are no-ops and sit at the END of the batch.
    """

    src: torch.Tensor  # (B,) int32
    dst: torch.Tensor  # (B,) int32
    weight: torch.Tensor  # (B,) float32


def make_edge_batch(edges, weights, pad_to: int | None = None,
                    device=None) -> EdgeBatch:
    """Canonicalize and zero-pad an update batch to a fixed size, on
    ``device`` (None = the CUDA card).  Self-loop entries are dropped: a
    self loop adds nothing to a Laplacian, and a live (0, 0) slot would
    collide with the padding sentinel."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    proper = edges[:, 0] != edges[:, 1]
    edges, weights = edges[proper], weights[proper]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    b = len(weights)
    size = b if pad_to is None else pad_to
    if size < b:
        raise ValueError(f"pad_to {pad_to} < batch size {b}")
    src = np.zeros((size,), np.int32)
    dst = np.zeros((size,), np.int32)
    w = np.zeros((size,), np.float32)
    src[:b], dst[:b], w[:b] = lo, hi, weights
    return EdgeBatch(torch.from_numpy(src).to(dev),
                     torch.from_numpy(dst).to(dev),
                     torch.from_numpy(w).to(dev))


def coalesce_batch(edges, weights, mode: str = "set",
                   pad_to: int | None = None, device=None) -> EdgeBatch:
    """Collapse duplicate pairs of a raw update stream (host side).

    mode="set": last write wins;  mode="add": deltas sum.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    out: dict[tuple[int, int], float] = {}
    for s, d, w in zip(lo, hi, weights):
        if s == d:
            continue  # self-loops are no-ops on a Laplacian
        key = (int(s), int(d))
        if mode == "add":
            out[key] = out.get(key, 0.0) + float(w)
        else:
            out[key] = float(w)
    pairs = np.asarray(list(out.keys()), np.int64).reshape(-1, 2)
    vals = np.asarray(list(out.values()), np.float32)
    return make_edge_batch(pairs, vals, pad_to=pad_to, device=device)


def _degrees(src, dst, weight, n: int) -> torch.Tensor:
    """Weighted degrees of the live slots.  The free slots are left out
    (they add 0): kept in, each is an atomic add to node 0, which at
    capacity 2^24 took 28 ms instead of 0.85 ms on an H100 (700 W)."""
    live = weight != 0.0
    src, dst, weight = src[live].long(), dst[live].long(), weight[live]
    deg = torch.zeros((n,), dtype=torch.float32, device=src.device)
    deg.index_add_(0, src, weight)
    deg.index_add_(0, dst, weight)
    return deg


def _pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, torch.zeros((pad,), dtype=x.dtype, device=x.device)])


def from_edge_list(g: EdgeList, capacity: int | None = None,
                   num_nodes: int | None = None) -> GraphStore:
    """Admit a graph: pad its edges into a capacity-class buffer on the
    graph's device.  ``num_nodes`` may exceed g.num_nodes to place the
    graph in a padded node capacity (the extra nodes are isolated)."""
    n = g.num_nodes if num_nodes is None else num_nodes
    if n < g.num_nodes:
        raise ValueError("num_nodes below the graph's node count")
    cap = capacity_class(g.num_edges) if capacity is None else capacity
    if cap < g.num_edges:
        raise ValueError(f"capacity {cap} < num_edges {g.num_edges}")
    pad = cap - g.num_edges
    src, dst, w = _pad(g.src, pad), _pad(g.dst, pad), _pad(g.weight, pad)
    return GraphStore(src=src, dst=dst, weight=w, deg=_degrees(src, dst, w, n),
                      deg_dirty=False, num_nodes=n)


def as_edge_list(store: GraphStore) -> EdgeList:
    """Zero-copy padded EdgeList view; free slots are inert."""
    return EdgeList(src=store.src, dst=store.dst, weight=store.weight,
                    num_nodes=store.num_nodes)


def num_edges(store: GraphStore) -> torch.Tensor:
    """Live edge count (a 0-dim device tensor)."""
    return torch.sum(store.weight != 0.0)


def grow(store: GraphStore, capacity: int | None = None) -> GraphStore:
    """Move to the next capacity class (or to ``capacity``)."""
    old = store.capacity
    if capacity is None:
        bigger = [c for c in CAPACITY_CLASSES if c > old]
        if not bigger:
            raise ValueError("already at the top capacity class")
        capacity = bigger[0]
    pad = capacity - old
    if pad < 0:
        raise ValueError(f"cannot shrink {old} -> {capacity}")
    return dataclasses.replace(store, src=_pad(store.src, pad),
                               dst=_pad(store.dst, pad),
                               weight=_pad(store.weight, pad))


class BatchStats(NamedTuple):
    matched: torch.Tensor  # () int32 - entries that updated an existing edge
    inserted: torch.Tensor  # () int32 - entries that claimed a free slot
    dropped: torch.Tensor  # () int32 - inserts lost to a full buffer


def _scatter_drop(buf: torch.Tensor, slot: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with ``buf[slot] = vals``, writes to slot == cap
    dropped: they land in one extra slot that is cut off (``index_put_``
    refuses out-of-range indices, and a boolean mask would sync)."""
    out = _pad(buf, 1)
    out.index_put_((slot,), vals.to(buf.dtype))
    return out[:-1]


def _apply(store: GraphStore, batch: EdgeBatch, add: bool):
    cap = store.capacity
    n = store.num_nodes
    b = batch.src.shape[0]
    dev = store.device
    occ = store.weight != 0.0
    # Sorted keys of the live slots; free slots key past every pair and,
    # the sort being stable, follow in ascending slot order.
    dead = n * n
    key = torch.where(occ, store.src.long() * n + store.dst.long(), dead)
    skey, order = torch.sort(key, stable=True)
    bkey = batch.src.long() * n + batch.dst.long()
    pos = torch.searchsorted(skey, bkey)
    # the lowest matching slot, as the JAX package's argmax over its match
    found = (pos < cap) & (skey[pos.clamp(max=cap - 1)] == bkey)
    match_idx = order[pos.clamp(max=cap - 1)]
    # No-op entries (padding, deletes of absent edges) write nothing: they
    # neither consume a free slot nor count as drops.
    noop = (batch.weight == 0.0) & ~found
    needs_slot = ~found & ~noop
    # i-th entry needing a slot gets the i-th free slot in ascending order;
    # cap when the buffer runs out, and that write is dropped below
    free_at = occ.sum() + torch.arange(b, device=dev)
    free_idx = torch.where(free_at < cap, order[free_at.clamp(max=cap - 1)], cap)
    new_rank = torch.cumsum(needs_slot, 0) - 1
    slot = torch.where(
        found, match_idx,
        torch.where(needs_slot, free_idx[new_rank.clamp(0, b - 1)], cap))
    in_range = slot < cap
    old_w = torch.where(found, store.weight[slot.clamp(0, cap - 1)], 0.0)
    new_w = old_w + batch.weight if add else batch.weight
    applied_w = torch.where(in_range, new_w, 0.0)
    dw = applied_w - torch.where(in_range, old_w, 0.0)  # realized deltas
    stats = BatchStats(
        matched=found.sum(dtype=torch.int32),
        inserted=(needs_slot & in_range).sum(dtype=torch.int32),
        dropped=(needs_slot & ~in_range).sum(dtype=torch.int32))
    new_store = dataclasses.replace(
        store, src=_scatter_drop(store.src, slot, batch.src),
        dst=_scatter_drop(store.dst, slot, batch.dst),
        weight=_scatter_drop(store.weight, slot, new_w), deg_dirty=True)
    return new_store, dw, stats


def apply_edge_batch(store: GraphStore, batch: EdgeBatch, mode: str = "set"):
    """Apply a batched upsert; returns (store', dw, stats).

    ``dw`` is the REALIZED per-entry weight delta (0 for dropped and no-op
    entries), the ΔL description the incremental eigen-update consumes
    (:mod:`repro_torch.stream.updates`).  Where a store holds duplicate
    live pairs the lowest slot is updated; free slots are claimed in
    ascending order.
    """
    if mode not in ("set", "add"):
        raise ValueError(f"unknown mode {mode!r}")
    return _apply(store, batch, mode == "add")


def refresh_degrees(store: GraphStore) -> GraphStore:
    """Lazy degree recomputation: pays the O(capacity) scatter only when
    the cache is stale.  The edges are unchanged, so the row-CSR cache
    carries over."""
    if not store.deg_dirty:
        return store
    out = dataclasses.replace(
        store, deg=_degrees(store.src, store.dst, store.weight, store.num_nodes),
        deg_dirty=False)
    out._cache.update(store._cache)
    return out


def spectral_radius_upper_bound(store: GraphStore
                                ) -> tuple[GraphStore, torch.Tensor]:
    """(refreshed store, 2 * max weighted degree): the Sec. 5.4 bound."""
    store = refresh_degrees(store)
    return store, 2.0 * torch.max(store.deg)


def edge_rows(store: GraphStore) -> es_ops.EdgeRows:
    """The row CSR of the store's live edges, the layout K1/K2 read, built
    on the store's device at the first call and cached on the store (the
    port's counterpart of the JAX package's ``node_blocking``).  Free
    slots have zero weight and sort past the last row, so the rows equal
    those of the live edges alone.  A mutation returns a new store, whose
    rows are built anew."""
    if "rows" not in store._cache:
        store._cache["rows"] = es_ops.build_edge_rows(
            store.src, store.dst, store.weight, store.num_nodes)
    return store._cache["rows"]


def shard_edge_rows(store: GraphStore, mesh, edge_axes=("data",)
                    ) -> es_ops.EdgeRows:
    """The row CSR of this rank's contiguous slice of the store's edge
    buffer (``parallel.shard_bounds``; the capacity must divide by the
    mesh's edge shards, as ``stream.sharded.balanced_capacity`` keeps
    it): what the rank's K1/K2 read in an edge-sharded tick.  Cached on
    the store like :func:`edge_rows`, so a mutation, which returns a new
    store, empties it."""
    lo, hi = parallel.shard_bounds(store.capacity, mesh, edge_axes)
    key = ("shard_rows", lo, hi)
    if key not in store._cache:
        store._cache[key] = es_ops.build_edge_rows(
            store.src[lo:hi], store.dst[lo:hi], store.weight[lo:hi],
            store.num_nodes)
    return store._cache[key]


def sharded_node_blocking(store: GraphStore, num_shards: int,
                          *, block_n: int = 512, block_e: int = 128
                          ) -> es_ops.ShardedNodeBlocking:
    """The JAX package's per-shard node blockings of the store's edge
    buffer (host-side, bitwise), on the store's device.  The capacity
    must divide into ``num_shards``.  No kernel reads it: the sharded
    tick reads :func:`shard_edge_rows`."""
    return es_ops.build_sharded_node_blocking(
        store.src, store.dst, store.weight, store.num_nodes, num_shards,
        block_n=min(block_n, store.num_nodes), block_e=block_e,
        device=store.device)


def model_sharded_blocking(store: GraphStore, num_shards: int,
                           *, block_n: int = 512, block_e: int = 128
                           ) -> es_ops.ModelShardedBlocking:
    """The JAX package's destination-aligned (panel-sharded) layouts of
    the store's live edges (host-side, bitwise), on the store's device.
    Any capacity works on any shard count.  No kernel reads it: the
    panel-sharded tick reads :func:`model_shard_rows`."""
    return es_ops.build_model_sharded_blocking(
        store.src, store.dst, store.weight, store.num_nodes, num_shards,
        block_n=min(block_n, store.num_nodes), block_e=block_e,
        device=store.device)


def model_shard_rows(store: GraphStore, mesh, model_axes=("model",),
                     *, block_n: int = 512) -> es_ops.EdgeRows:
    """The row CSR of this rank's OWNED panel rows
    (``ops.build_model_shard_rows``: every half-edge destined to the
    rank's row range of :func:`model_sharded_blocking`'s split, local
    rows, global neighbours), built on the store's device: what the
    rank's K2 reads in a panel-sharded tick and probe.  Cached on the store like
    :func:`edge_rows`, so a mutation, which returns a new store, empties
    it."""
    num_shards = parallel.num_model_shards(mesh, model_axes)
    sidx = parallel.model_shard_index(mesh, model_axes)
    bn = min(block_n, store.num_nodes)
    key = ("model_rows", num_shards, sidx, bn)
    if key not in store._cache:
        store._cache[key] = es_ops.build_model_shard_rows(
            store.src, store.dst, store.weight, store.num_nodes, num_shards,
            sidx, block_n=bn)
    return store._cache[key]


def fused_step(store: GraphStore, backend: str = "auto"
               ) -> backend_mod.FusedStep:
    """fused_step(u, alpha, beta) = alpha * L u + beta * u over the store's
    live edges: on the kernel path K1/K2 over the cached
    :func:`edge_rows`, on segment the plain matvec of the buffers.  The
    step a streaming session hands to
    ``operators.dilated_step_operator`` and ``updates.anchor_estimate``."""
    if backend_mod.resolve_backend(backend, store.device) == "segment":
        return backend_mod.buffers_fused_step(
            store.src, store.dst, store.weight, store.num_nodes, "segment")
    return backend_mod.rows_fused_step(edge_rows(store))
