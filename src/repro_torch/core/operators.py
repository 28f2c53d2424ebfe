"""Solver-facing operator builders.

An operator is a function V -> A @ V where A = lambda* I - S(L) is the
transformed and reversed Laplacian (Eq. 8, Table 2).  This module wires
the Laplacian matvec and a spectral series into the matvec the solvers
consume.  Every constructor takes ``backend`` (see
:mod:`repro_torch.core.backend`).  On the kernel backend the exact-edges
operator is a :class:`CapturedOperator`: its ``degree`` kernel launches
are captured once as a CUDA graph and replayed, the port's counterpart of
the JAX package's jitted series; so is the dilated operator of a
streaming session, ``(I - c L)^degree`` on raw edge buffers.  The
stochastic minibatch operator runs eagerly: a replayed graph would
repeat its captured draw.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import kernels, spans
from repro_torch.core import backend as backend_mod
from repro_torch.core import laplacian as lap
from repro_torch.core import metrics
from repro_torch.core.series import SpectralSeries
from repro_torch.kernels.edge_spmm import ops as es_ops

MatVec = Callable[[torch.Tensor], torch.Tensor]


def side_stream_call(fn: Callable[[], object], device: torch.device):
    """Run ``fn()`` eagerly on a side stream and hand its result back to
    the current one: the warm-up before a capture (it builds and loads
    the kernel library, and gives the call's result)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    for t in out if isinstance(out, tuple) else (out,):
        t.record_stream(main)
    return out


@spans.span("sped.capture")
def capture_graph(fn: Callable[[], object]
                  ) -> tuple[torch.cuda.CUDAGraph, object, dict[str, int]]:
    """Capture ``fn()`` as a new CUDA graph: (graph, fn's static output,
    the kernel launches the graph holds).  The capture records launches
    without running them, so the counts the wrappers added during it are
    taken back; whoever replays the graph adds ``held``.

    The capture is thread-local: only the capturing thread is barred
    from calls that are unsafe during a capture, so other threads may
    allocate, synchronize and run work on other streams meanwhile (the
    serving layer's request threads label on the card while the engine
    thread captures a tick program).  Those threads must put nothing on
    the capturing stream and launch no counted kernel during the
    capture."""
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        held = {name: c - before[name]
                for name, c in kernels.launch_counts().items()}
    finally:
        kernels.add_launch_counts(
            {name: before[name] - c
             for name, c in kernels.launch_counts().items()})
    return graph, out, held


class CapturedOperator:
    """A CUDA operator V -> fn(V) replayed from a CUDA graph.

    The first call for a (panel shape, dtype, device) runs ``fn`` eagerly
    on a side stream (:func:`side_stream_call`), then captures one ``fn``
    on a static input panel (:func:`capture_graph`); later calls copy V
    in, replay, and return a copy of the static output.  Allocations
    freed during the capture are reused within it from the graph's
    private pool, so the graph holds a few panels, not one per step.  A
    replay adds the kernel launches the graph holds to the launch
    counts, so they read as the eager loop's would; the capture itself
    launches nothing and counts nothing.  A call that cannot be captured
    raises: there is no eager fallback.
    """

    def __init__(self, fn: MatVec):
        self.fn = fn
        self.graphs: dict[tuple, tuple] = {}

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if v.device.type != "cuda":
            raise ValueError(f"CapturedOperator runs CUDA panels, got {v.device}")
        key = (tuple(v.shape), v.dtype, v.device)
        if key not in self.graphs:
            out = side_stream_call(lambda: self.fn(v), v.device)
            static_in = v.clone(memory_format=torch.contiguous_format)
            graph, static_out, held = capture_graph(lambda: self.fn(static_in))
            self.graphs[key] = (graph, static_in, static_out, held)
            return out
        graph, static_in, static_out, held = self.graphs[key]
        static_in.copy_(v)
        graph.replay()
        kernels.add_launch_counts(held)
        return static_out.clone()


def dense_matvec(l_mat: torch.Tensor) -> MatVec:
    return lambda v: l_mat @ v


def dilated_step_operator(fused: backend_mod.FusedStep, c, degree: int,
                          capture: bool = False) -> MatVec:
    """``V -> (I - c L)^degree V``, each factor ``u - c L u`` one fused
    step (alpha = -c, beta = 1): one K1/K2 launch on the kernel path.
    ``capture`` replays the ``degree`` launches as one CUDA graph per
    panel shape (:class:`CapturedOperator`, when ``degree`` > 1).  K1/K2
    take alpha by value and a graph replays the c it was captured at, so
    c and degree are fixed here: an operator at another c is another
    operator, with graphs of its own."""
    c, degree = float(c), int(degree)

    def fn(v: torch.Tensor) -> torch.Tensor:
        u = v
        for _ in range(degree):
            u = fused(u, -c, 1.0)
        return u

    return CapturedOperator(fn) if capture and degree > 1 else fn


def dilated_operator_arrays(src: torch.Tensor, dst: torch.Tensor,
                            w: torch.Tensor, c, degree: int,
                            backend: str = "auto") -> MatVec:
    """``V -> (I - c L)^degree V`` on raw (capacity-padded) edge buffers:
    the dilated reversed operator of one streaming session (the paper's
    limit_neg_exp series with lambda* = 0, unit-normalized).

    Segment runs ``degree`` plain edge matvecs.  The kernel path builds
    the buffers' row CSR at the first call (the panel gives n; free slots
    sort past the last row) and replays its ``degree`` K1/K2 launches as
    a CUDA graph.  A streaming session that keeps a :class:`GraphStore`
    runs :func:`dilated_step_operator` over
    ``stream.graph_store.fused_step(store)`` instead, whose row CSR is
    cached on the store.
    """
    kind = backend_mod.resolve_backend(backend, src.device)
    built: list[MatVec] = []

    def opv(v: torch.Tensor) -> torch.Tensor:
        if not built:
            built.append(dilated_step_operator(
                backend_mod.buffers_fused_step(src, dst, w, v.shape[0], kind),
                c, degree, capture=kind == "kernel"))
        return built[0](v)
    return opv


def dilated_matvec_arrays(src, dst, w, v: torch.Tensor, c, degree: int,
                          backend: str = "auto") -> torch.Tensor:
    """One application of :func:`dilated_operator_arrays`.  A one-shot
    call captures nothing: the kernel path builds the row CSR and
    launches its ``degree`` K1/K2 steps eagerly."""
    fused = backend_mod.buffers_fused_step(src, dst, w, v.shape[0], backend)
    return dilated_step_operator(fused, c, degree)(v)


def dilated_panel_residual(src, dst, w, v: torch.Tensor, c, degree: int,
                           backend: str = "auto") -> torch.Tensor:
    """Panel residual under the dilated reversed operator
    (``metrics.operator_residual``), one application."""
    return metrics.panel_residual(
        v, dilated_matvec_arrays(src, dst, w, v, c, degree, backend))


def edge_matvec(g: lap.EdgeList, backend: str = "auto") -> MatVec:
    """V -> L @ V on the selected backend."""
    return backend_mod.laplacian_matvec_fn(g, backend)


def series_operator(series: SpectralSeries, matvec: MatVec | None,
                    fused_step: backend_mod.FusedStep | None = None) -> MatVec:
    """V -> (lambda* I - S(L)) V; ``fused_step`` switches the series onto
    its fused evaluator (one kernel call per recurrence step)."""
    if fused_step is not None:
        return lambda v: series.apply_reversed_fused(fused_step, v)
    return lambda v: series.apply_reversed(matvec, v)


def edge_series_operator(g: lap.EdgeList, series: SpectralSeries,
                         backend: str = "auto") -> MatVec:
    """The exact_edges operator: series over the edge-list matvec on the
    selected backend.  On the kernel path the fused series steps are
    replayed as a CUDA graph (:class:`CapturedOperator`) when there is
    more than one: a one-step graph saves no dispatch and its capture
    costs a tenth of a second or more."""
    fused = backend_mod.fused_step_fn(g, backend)
    if fused is None:
        return series_operator(series, edge_matvec(g, backend="segment"))
    op = series_operator(series, None, fused_step=fused)
    return CapturedOperator(op) if series.degree > 1 else op


def exact_operator(series_or_transform, l_mat: torch.Tensor) -> MatVec:
    """Exact f(L) via eigh (the paper's 'exact' curves), from a
    SpectralSeries' scalar map or a ``transforms.Transform`` (reversed at
    lambda*(lambda_max))."""
    lam, vecs = torch.linalg.eigh(l_mat)
    if isinstance(series_or_transform, SpectralSeries):
        f_lam = series_or_transform.reversed_scalar(lam)
    else:  # transforms.Transform
        tf = series_or_transform
        f_lam = tf.lambda_star(float(lam[-1])) - tf.scalar(lam)
    a = (vecs * f_lam[None, :]) @ vecs.T
    return lambda v: a @ v


def minibatch_operator(g: lap.EdgeList, series: SpectralSeries,
                       batch_edges: int, backend: str = "auto"):
    """Stochastic operator ``op(generator, V, sel=None)``: every inner
    Laplacian matvec uses its own uniform minibatch of B edges, drawn
    with replacement and scaled by E / B.  Each factor is unbiased for L
    and the factors are independent, so every monomial estimate
    E[L_b1 ... L_bi] = L^i is unbiased (paper Sec. 3).

    One call draws all its batches at once from ``generator`` (on the
    graph's device): ``sel`` of shape (degree + 1, B), whose row i feeds
    the matvec at series position i.  That is equal in distribution to
    the JAX package's ``randint(fold_in(key, i))`` per factor; an
    injected ``sel`` (F, B) replays a given draw and needs a row for
    every position the series uses (``degree`` rows for limit_neg_exp).

    On the kernel path every factor is one K1 launch on the batch's edge
    list (``ops.edge_spmm`` builds the batch's row CSR on the card) at
    any n: K1 has no node limit there.  Segment runs
    :func:`laplacian.minibatch_laplacian_matvec`.  The series runs
    eagerly, never as a captured graph, whose replays would repeat one
    draw.
    """
    e = g.num_edges
    kind = backend_mod.resolve_backend(backend, g.device)
    scale = e / batch_edges

    def op(generator: torch.Generator, v: torch.Tensor,
           sel: torch.Tensor | None = None) -> torch.Tensor:
        if sel is None:
            sel = torch.randint(0, e, (series.degree + 1, batch_edges),
                                generator=generator, device=g.device)
        sel = torch.as_tensor(sel, device=g.device).long()
        src, dst, w = g.src[sel].long(), g.dst[sel].long(), g.weight[sel]

        def factor(_, i: int, u: torch.Tensor) -> torch.Tensor:
            if kind == "kernel":
                return es_ops.edge_spmm(src[i], dst[i], w[i] * scale, u)
            return lap.minibatch_laplacian_matvec(src[i], dst[i], w[i], u, e)

        return series.apply_reversed_stochastic(factor, generator, v)

    return op


def scaled_series_for_graph(g: lap.EdgeList, series_fn, degree: int,
                            target_radius: float = 1.0,
                            rho: float | None = None) -> SpectralSeries:
    """Pre-scale L by target_radius / rho so a fixed-degree series stays
    accurate whatever the graph's max degree (the paper's Fig. 4 failure
    mode).  ``rho`` takes a probed spectral-radius estimate; the
    Gershgorin bound ``spectral_radius_upper_bound`` is the default."""
    if rho is None:
        rho = float(lap.spectral_radius_upper_bound(g))
    scale = target_radius / max(rho, 1e-30)
    return series_fn(degree, scale=scale) if "scale" in series_fn.__code__.co_varnames \
        else series_fn(degree)


def planned_operator(g: lap.EdgeList, k: int,
                     generator: torch.Generator | None = None,
                     budget: int = 96, estimation: str = "exact_edges",
                     batch_edges: int = 1024, num_probes: int = 4,
                     num_steps: int = 24, backend: str = "auto"):
    """Probe the graph's spectrum and build an auto-tuned solver operator.

    SLQ-probes lambda_max and the bottom-edge eigengap on the exact
    edges, plans the transform family, degree and strength
    (:mod:`repro_torch.spectral`) and wires the tuned series into the
    requested estimation mode.  Returns (operator, DilationPlan); the
    operator is deterministic for "exact_edges" and ``op(generator, V)``
    for "minibatch" (:func:`minibatch_operator`, ``batch_edges`` edges a
    factor).  ``budget`` caps the series degree; ``backend`` selects the
    kernels of both the probe and the solve.
    """
    if estimation not in ("exact_edges", "minibatch"):
        raise ValueError(f"unknown estimation mode {estimation!r}")
    from repro_torch import spectral  # deferred: spectral builds on core

    _, plan = spectral.probe_and_plan(
        g, k=k, generator=generator, budget=budget,
        num_probes=num_probes, num_steps=num_steps, backend=backend)
    s = spectral.series_from_plan(plan)
    if estimation == "minibatch":
        return minibatch_operator(g, s, batch_edges, backend=backend), plan
    return edge_series_operator(g, s, backend=backend), plan
