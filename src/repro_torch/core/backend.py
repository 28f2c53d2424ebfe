"""Matvec backend selection: plain segment gather/scatter vs the kernels.

  * ``backend="segment"`` - the plain gather + ``index_add_`` matvec of
    :mod:`repro_torch.core.laplacian`, on whatever device the graph is.
    Series then run their classic recurrences.
  * ``backend="kernel"`` - the hand-written CUDA kernels, with each series
    step fused into the SpMM epilogue.  Up to ``ONE_HOT_NODE_LIMIT`` nodes
    the edge-scatter kernel (K1) runs; past it the node-blocked kernel (K2)
    over a host-built :class:`NodeBlocking`.  A CPU graph raises.
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
    NodeBlocking,
    build_node_blocking,
)

MatVec = Callable[[torch.Tensor], torch.Tensor]
# fused_step(u, alpha, beta) -> alpha * (L @ u) + beta * u
FusedStep = Callable[[torch.Tensor, float, float], torch.Tensor]

BACKENDS = ("auto", "segment", "kernel")

# The JAX package's node limit of its one-hot kernel; the port keeps the
# same n-based choice of K1 (n <= limit) or K2 (n > limit).
ONE_HOT_NODE_LIMIT = 4096

# Default node-block size of auto-built blockings: K2 holds a
# (block_n, k) fp32 accumulator in shared memory (20 kB at k = 10).
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
    """Host-side node-blocked layout of an EdgeList, on the graph's device."""
    return build_node_blocking(
        g.src, g.dst, g.weight, g.num_nodes,
        block_n=block_n or DEFAULT_BLOCK_N, block_e=block_e, device=g.device)


def _needs_blocking(num_nodes: int) -> bool:
    return num_nodes > ONE_HOT_NODE_LIMIT


def fused_step_fn(g: lap.EdgeList, backend: str = "auto",
                  blocking: NodeBlocking | None = None) -> FusedStep | None:
    """fused_step(u, alpha, beta) = alpha * L u + beta * u, or None.

    The kernel path picks K1 for small n and K2 otherwise (building and
    capturing the blocking when none is supplied).  Segment returns None:
    callers then use the plain matvec recurrences.
    """
    if resolve_backend(backend, g.device) == "segment":
        return None
    if blocking is None and _needs_blocking(g.num_nodes):
        blocking = blocking_for(g)
    if blocking is not None:
        def fused(u, alpha, beta):
            return es_ops.edge_spmm_blocked(blocking, u, alpha=alpha, beta=beta)
        return fused

    def fused(u, alpha, beta):
        return es_ops.edge_spmm(g.src, g.dst, g.weight, u,
                                alpha=alpha, beta=beta)
    return fused


def laplacian_matvec_fn(g: lap.EdgeList, backend: str = "auto",
                        blocking: NodeBlocking | None = None) -> MatVec:
    """V -> L @ V on the resolved backend (V may be (n,) or (n, k))."""
    fused = fused_step_fn(g, backend, blocking)
    if fused is None:
        return functools.partial(lap.laplacian_matvec, g)
    return lambda v: fused(v, 1.0, 0.0)


def edge_arrays_matvec_fn(src: torch.Tensor, dst: torch.Tensor,
                          weight: torch.Tensor, backend: str = "auto"
                          ) -> MatVec:
    """Raw-array matvec factory (spectral probes, per-draw matvecs).

    The kernel path runs K1 at any n: K1 has no node limit on the card, so
    there is no ``num_nodes`` switch to segment past
    ``ONE_HOT_NODE_LIMIT`` as in the JAX package.
    """
    if resolve_backend(backend, src.device) == "segment":
        return functools.partial(lap.edge_matvec_arrays, src, dst, weight)
    return lambda v: es_ops.edge_spmm(src, dst, weight, v)
