"""Edge-sharded SPED on ``torch.distributed`` (paper Sec. 4.3: d edge
shards or walkers in parallel, averaged).

One rank is one shard (:mod:`repro_torch.parallel`).  Every function
takes the JAX package's GLOBAL arrays on every rank; the rank keeps its
contiguous slice of the (mesh-padded) edge buffer and returns the
replicated result:

  * a Laplacian matvec is the shard's ``L_s v = deg_s v - A_s v`` (K1/K2
    over the row CSR of the slice on the card, the plain edge matvec on
    segment) followed by ONE all_reduce of the (n, k) panel over the
    group of the mesh's edge axes;
  * a series runs per rank: each factor is the shard's matvec at
    ``alpha = 1, beta = 0``, the all_reduce, then the series AXPY
    ``alpha * Lu + beta * u`` after it (beta must apply exactly once, so
    the kernel-epilogue fusion of one device is traded for the
    collective), eagerly: a gloo collective cannot be captured;
  * the stochastic operators average (``pmean``) the ranks' independent
    estimates: each rank draws its own edge minibatch or walk batch.

Every all_reduce goes through ``program._psum``, so
``program.count_psums`` counts them.  The panel stays replicated and the
solver step (K3/K4) runs on every rank; the panel comes out bitwise
equal on every rank, since every rank receives the same reduced panel.
"""
from __future__ import annotations

import torch

from repro_torch import parallel
from repro_torch.core import backend as backend_mod
from repro_torch.core import laplacian as lap
from repro_torch.core import program
from repro_torch.core import walks as walks_mod
from repro_torch.core.laplacian import EdgeIncidence, EdgeList
from repro_torch.core.series import SpectralSeries
from repro_torch.data.pipeline import mixed_seed
from repro_torch.kernels.edge_spmm import ops as es_ops

num_edge_shards = parallel.num_edge_shards


def pad_edges_for_mesh(g: EdgeList, num_shards: int) -> EdgeList:
    """Pad with inert zero-weight edges so the edge buffer divides evenly
    across shards.  Capacity-padded buffers are fine: their free slots
    stay inert in every shard."""
    e = g.num_edges
    return lap.pad_edge_list(g, e + ((-e) % num_shards))


def _local_fused(mesh, edge_axes, src, dst, w, num_nodes: int,
                 kind: str) -> backend_mod.FusedStep:
    """fused(u, alpha, beta) = alpha L_s u + beta u of this rank's slice:
    K1 (n <= ``backend.ONE_HOT_NODE_LIMIT``) or K2 over the slice's row
    CSR, built here once, on the kernel path; the plain edge matvec of the
    slice on segment."""
    lo, hi = parallel.shard_bounds(src.shape[0], mesh, edge_axes)
    return backend_mod.buffers_fused_step(src[lo:hi], dst[lo:hi], w[lo:hi],
                                          num_nodes, kind)


def _psum_matvec(local: backend_mod.FusedStep, group):
    """V -> L V: the shard's matvec, then one all_reduce."""
    return lambda v: program._psum(local(v, 1.0, 0.0), group)


def _psum_fused(local: backend_mod.FusedStep, group) -> backend_mod.FusedStep:
    """fused(u, alpha, beta) with the all_reduce between the shard's
    matvec and the AXPY."""
    mv = _psum_matvec(local, group)
    return lambda u, alpha, beta: alpha * mv(u) + beta * u


def sharded_laplacian_matvec(mesh, edge_axes=("data",), backend: str = "auto"):
    """Returns ``matvec(src, dst, w, v) -> L v`` over GLOBAL edge arrays
    (their length divisible by the shard count) and a replicated panel:
    the rank's slice, one all_reduce over the edge axes.  A call builds
    its slice's row CSR on the kernel path; callers that reuse one edge
    list build an operator instead."""
    group = parallel.edge_group(mesh, edge_axes)

    def mv(src, dst, w, v):
        kind = backend_mod.resolve_backend(backend, v.device)
        local = _local_fused(mesh, edge_axes, src, dst, w, v.shape[0], kind)
        return _psum_matvec(local, group)(v)

    return mv


def sharded_blocked_matvec(mesh, blocking: es_ops.ShardedNodeBlocking,
                           edge_axes=("data",)):
    """Returns ``matvec(v) -> L v`` over the JAX package's per-shard
    node blockings (``backend.sharded_blocking_for``): the rank's K2 over
    the row CSR of its own blocking (``ops.blocking_rows``, built here
    once; the plain row twin on the CPU), then one all_reduce."""
    num_shards = num_edge_shards(mesh, edge_axes)
    if blocking.num_shards != num_shards:
        raise ValueError(
            f"blocking has {blocking.num_shards} shards but the mesh's "
            f"{tuple(edge_axes)} axes hold {num_shards}")
    rows = es_ops.blocking_rows(
        blocking.shard(parallel.shard_index(mesh, edge_axes)))
    group = parallel.edge_group(mesh, edge_axes)
    return lambda v: program._psum(es_ops.edge_spmm_rows_nb(rows, v), group)


def distributed_series_operator(mesh, g: EdgeList, series: SpectralSeries,
                                edge_axes=("data",), backend: str = "auto",
                                block_n: int | None = None):
    """The deterministic sharded operator ``V -> (lambda* I - S(L)) V``.

    The edges are padded to the shard count once; the whole series runs
    per rank, each of its ``degree`` factors the shard's matvec (K1/K2 on
    the card), one all_reduce of the (n, k) panel and the series AXPY
    after it.  ``block_n`` routes the shard's matvec through the JAX
    package's per-shard node blocking (``sharded_blocking_for``, built on
    the host) and K2 over its rows, the JAX package's blocked route;
    without it the kernel path reads the row CSR of the slice, built on
    the card.
    """
    num_shards = num_edge_shards(mesh, edge_axes)
    gp = pad_edges_for_mesh(g, num_shards)
    group = parallel.edge_group(mesh, edge_axes)
    kind = backend_mod.resolve_backend(backend, g.device)
    if block_n is not None:
        sb = backend_mod.sharded_blocking_for(gp, num_shards, block_n=block_n)
        rows = es_ops.blocking_rows(
            sb.shard(parallel.shard_index(mesh, edge_axes)))

        def local(u, alpha, beta):
            return es_ops.edge_spmm_rows_nb(rows, u, alpha, beta)
    else:
        local = _local_fused(mesh, edge_axes, gp.src, gp.dst, gp.weight,
                             g.num_nodes, kind)
    fused = _psum_fused(local, group)
    return lambda v: series.apply_reversed_fused(fused, v)


def distributed_solve(mesh, g: EdgeList, series: SpectralSeries, cfg,
                      edge_axes=("data",), backend: str = "auto",
                      block_n: int | None = None, v_star=None, init_v=None):
    """One-shot sharded solve: :func:`distributed_series_operator` driven
    by the unified solve loop (``program.run_program``) on every rank.
    ``cfg`` is a :class:`~repro_torch.core.solvers.SolverConfig`; returns
    ``(state, trace)`` as ``run_solver`` does.  Every rank seeds the same
    generator, so all start from one panel; the panels stay bitwise equal
    across ranks."""
    op = distributed_series_operator(mesh, g, series, edge_axes=edge_axes,
                                     backend=backend, block_n=block_n)
    return program.run_program(op, g.num_nodes, cfg, v_star=v_star,
                               init_v=init_v, device=g.device)


def _rank_generator(generator: torch.Generator, sidx: int,
                    device) -> torch.Generator:
    """This rank's own stream for one call: one draw from the shared
    ``generator`` (every rank draws the same, so the ranks stay in step
    on it) mixed with the shard index, as the JAX package splits a key
    per device."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(mixed_seed(seed, sidx))


def distributed_minibatch_operator(mesh, g: EdgeList, series: SpectralSeries,
                                   batch_edges_per_device: int,
                                   edge_axes=("data",), backend: str = "auto"):
    """Stochastic sharded operator ``op(generator, V, sel=None)`` (the
    paper's scaling model): every rank draws its OWN uniform minibatch of
    B edges of the global list for each factor, scaled by E / B, and the
    ranks' estimates are averaged (all_reduce over S), so each factor
    stays unbiased and its variance falls as 1 / S.

    One call draws this rank's (degree + 1, B) batch indices at once from
    a stream of its own (:func:`_rank_generator`), row i feeding series
    position i; an injected ``sel`` (F, B) replays a given draw (the JAX
    package's ``randint(split(fold_in(key, i), S)[s])``).  A factor is one
    K1 launch on the batch's row CSR on the kernel path,
    ``laplacian.minibatch_laplacian_matvec`` on segment; eager.
    """
    e = g.num_edges
    b = batch_edges_per_device
    kind = backend_mod.resolve_backend(backend, g.device)
    group = parallel.edge_group(mesh, edge_axes)
    num_shards = num_edge_shards(mesh, edge_axes)
    sidx = parallel.shard_index(mesh, edge_axes)

    def op(generator: torch.Generator, v: torch.Tensor,
           sel: torch.Tensor | None = None) -> torch.Tensor:
        if sel is None:
            sel = torch.randint(
                0, e, (series.degree + 1, b),
                generator=_rank_generator(generator, sidx, g.device),
                device=g.device)
        sel = torch.as_tensor(sel, device=g.device).long()
        src, dst, w = g.src[sel].long(), g.dst[sel].long(), g.weight[sel]

        def factor(_, i: int, u: torch.Tensor) -> torch.Tensor:
            if kind == "kernel":
                est = es_ops.edge_spmm(src[i], dst[i], w[i] * (e / b), u)
            else:
                est = lap.minibatch_laplacian_matvec(src[i], dst[i], w[i], u, e)
            return program._psum(est, group) / num_shards

        return series.apply_reversed_stochastic(factor, generator, v)

    return op


def distributed_walk_operator(mesh, g: EdgeList, inc: EdgeIncidence,
                              coeffs: tuple[float, ...], lambda_star: float,
                              walkers_per_device: int, edge_axes=("data",),
                              mode: str = "importance"):
    """Paper Sec. 4.3 across ranks: ``op(generator, V, walks=None,
    coins=None)`` -> ``(lambda* I - P(L)) V`` with every rank estimating
    ``P(L) V = sum_i coeffs[i] L^i V`` from its OWN batch of
    ``walkers_per_device`` walks and the estimates averaged over the ranks.

    A call draws this rank's walks (and, in "rejection" mode, its accept
    coins) from a stream of its own (:func:`_rank_generator`); an
    injected ``walks`` (a :class:`~repro_torch.core.walks.WalkBatch`) and
    ``coins`` ((degree, W) uniforms, row p - 1 the coin of power p)
    replay a given draw.  Plain PyTorch, as the single-device estimator.
    """
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("need degree >= 1")
    group = parallel.edge_group(mesh, edge_axes)
    num_shards = num_edge_shards(mesh, edge_axes)
    sidx = parallel.shard_index(mesh, edge_axes)

    def op(generator: torch.Generator, v: torch.Tensor,
           walks: walks_mod.WalkBatch | None = None,
           coins: torch.Tensor | None = None) -> torch.Tensor:
        rank_gen = None
        if walks is None or (mode == "rejection" and coins is None):
            rank_gen = _rank_generator(generator, sidx, v.device)
        if walks is None:
            walks = walks_mod.sample_walks(rank_gen, inc, walkers_per_device,
                                           max(deg, 2))
        acc = coeffs[0] * v
        for p in range(1, deg + 1):
            acc = acc + coeffs[p] * walks_mod.estimate_power_matvec(
                walks, g, inc, p, v, mode=mode, generator=rank_gen,
                uniform=None if coins is None else coins[p - 1])
        return lambda_star * v - program._psum(acc, group) / num_shards

    return op
