"""Matvec backend selection: plain segment gather/scatter vs the kernels.

  * ``backend="segment"`` - the plain gather + ``index_add_`` matvec of
    :mod:`repro_torch.core.laplacian`, on whatever device the graph is.
    Series then run their classic recurrences.
  * ``backend="kernel"`` - the hand-written CUDA kernels, with each series
    step fused into the SpMM epilogue, over a row CSR built once per edge
    list on the card: K1 up to ``ONE_HOT_NODE_LIMIT`` nodes, K2 past it.
    A CPU graph raises.
  * ``backend="auto"`` - ``kernel`` for a graph on the card, ``segment``
    for a graph on the CPU.

There is no environment override and no fallback: a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.kernels.edge_spmm.ops import (  # noqa: F401  (re-exported)
    ModelShardedBlocking,
    NodeBlocking,
    ShardedNodeBlocking,
    build_model_sharded_blocking,
    build_node_blocking,
    build_sharded_node_blocking,
)

MatVec = Callable[[torch.Tensor], torch.Tensor]
# fused_step(u, alpha, beta) -> alpha * (L @ u) + beta * u
FusedStep = Callable[[torch.Tensor, float, float], torch.Tensor]

BACKENDS = ("auto", "segment", "kernel")

# The JAX package's node limit of its one-hot kernel; the port keeps the
# same n-based choice of K1 (n <= limit) or K2 (n > limit).  Both launch
# the same body over the same layout, so the choice only names the launch.
ONE_HOT_NODE_LIMIT = 4096

# Default node-block size of blockings built here (the JAX package's).
DEFAULT_BLOCK_N = 512


def resolve_backend(backend: str, device) -> str:
    """'auto' -> 'kernel' on CUDA, 'segment' on the CPU; 'kernel' on a
    CPU device raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    dev = torch.device(device)
    if backend == "auto":
        return "kernel" if dev.type == "cuda" else "segment"
    if backend == "kernel" and dev.type != "cuda":
        raise ValueError(
            "backend='kernel' runs the CUDA kernels and needs tensors on a "
            f"CUDA device, got {dev}; use backend='segment' on the CPU")
    return backend


def blocking_for(g: lap.EdgeList, *, block_n: int | None = None,
                 block_e: int = 128) -> NodeBlocking:
    """The JAX package's node-blocked layout of an EdgeList (built on the
    host), on the graph's device.  The kernel path does not read it."""
    return build_node_blocking(
        g.src, g.dst, g.weight, g.num_nodes,
        block_n=block_n or DEFAULT_BLOCK_N, block_e=block_e, device=g.device)


def sharded_blocking_for(g: lap.EdgeList, num_shards: int,
                         *, block_n: int | None = None,
                         block_e: int = 128) -> ShardedNodeBlocking:
    """The JAX package's per-shard node-blocked layouts of a mesh-padded
    EdgeList (built on the host), on the graph's device: the layout of
    ``distributed.sharded_blocked_matvec``."""
    return build_sharded_node_blocking(
        g.src, g.dst, g.weight, g.num_nodes, num_shards,
        block_n=block_n or DEFAULT_BLOCK_N, block_e=block_e, device=g.device)


def model_blocking_for(g: lap.EdgeList, num_shards: int,
                       *, block_n: int | None = None,
                       block_e: int = 128) -> ModelShardedBlocking:
    """The JAX package's destination-aligned (panel-sharded) layouts of an
    EdgeList (built on the host), on the graph's device.  A shard's K2
    reads the row CSR of its ``shard(s)`` (``ops.blocking_rows``)."""
    return build_model_sharded_blocking(
        g.src, g.dst, g.weight, g.num_nodes, num_shards,
        block_n=block_n or DEFAULT_BLOCK_N, block_e=block_e, device=g.device)


def fused_step_fn(g: lap.EdgeList, backend: str = "auto") -> FusedStep | None:
    """fused_step(u, alpha, beta) = alpha * L u + beta * u, or None.

    The kernel path builds the row CSR here once, on the card, and
    launches K1 for n <= ``ONE_HOT_NODE_LIMIT``, K2 past it.  Segment
    returns None: callers then use the plain matvec recurrences.
    """
    if resolve_backend(backend, g.device) == "segment":
        return None
    return buffers_fused_step(g.src, g.dst, g.weight, g.num_nodes, "kernel")


def rows_fused_step(rows: es_ops.EdgeRows) -> FusedStep:
    """fused_step(u, alpha, beta) over a built row CSR: K1 for
    n <= ``ONE_HOT_NODE_LIMIT``, K2 past it (the plain twin for a CPU
    panel)."""
    n = rows.row_ptr.shape[0] - 1
    spmm = (es_ops.edge_spmm_rows if n <= ONE_HOT_NODE_LIMIT
            else es_ops.edge_spmm_rows_nb)

    def fused(u, alpha, beta):
        return spmm(rows, u, alpha=alpha, beta=beta)
    return fused


def buffers_fused_step(src: torch.Tensor, dst: torch.Tensor,
                       weight: torch.Tensor, num_nodes: int,
                       backend: str = "auto") -> FusedStep:
    """fused_step(u, alpha, beta) = alpha * L u + beta * u over raw
    (capacity-padded) edge buffers.  Segment runs the plain edge matvec;
    the kernel path builds the buffers' row CSR here, on the card (free
    slots sort past the last row), and launches K1/K2 over it."""
    if resolve_backend(backend, src.device) == "segment":
        return lambda u, alpha, beta: (
            alpha * lap.edge_matvec_arrays(src, dst, weight, u) + beta * u)
    return rows_fused_step(es_ops.build_edge_rows(src, dst, weight, num_nodes))


def laplacian_matvec_fn(g: lap.EdgeList, backend: str = "auto") -> MatVec:
    """V -> L @ V on the resolved backend (V may be (n,) or (n, k))."""
    fused = fused_step_fn(g, backend)
    if fused is None:
        return functools.partial(lap.laplacian_matvec, g)
    return lambda v: fused(v, 1.0, 0.0)


def edge_arrays_matvec_fn(src: torch.Tensor, dst: torch.Tensor,
                          weight: torch.Tensor, backend: str = "auto"
                          ) -> MatVec:
    """Raw-array matvec factory (spectral probes, per-draw matvecs).

    The kernel path runs K1 at any n, over a row CSR built at the first
    call (the panel gives n) and reused: K1 has no node limit on the
    card, so there is no ``num_nodes`` switch to segment past
    ``ONE_HOT_NODE_LIMIT`` as in the JAX package.
    """
    if resolve_backend(backend, src.device) == "segment":
        return functools.partial(lap.edge_matvec_arrays, src, dst, weight)
    built: dict[int, es_ops.EdgeRows] = {}

    def matvec(v):
        n = v.shape[0]
        if n not in built:
            built[n] = es_ops.build_edge_rows(src, dst, weight, n)
        return es_ops.edge_spmm_rows(built[n], v)
    return matvec
