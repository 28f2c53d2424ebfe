"""Solver-facing operator builders.

An operator is a function V -> A @ V where A = lambda* I - S(L) is the
transformed and reversed Laplacian (Eq. 8, Table 2).  This module wires
the Laplacian matvec and a spectral series into the matvec the solvers
consume.  Every constructor takes ``backend`` (see
:mod:`repro_torch.core.backend`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import laplacian as lap
from repro_torch.core.series import SpectralSeries

MatVec = Callable[[torch.Tensor], torch.Tensor]


def dense_matvec(l_mat: torch.Tensor) -> MatVec:
    return lambda v: l_mat @ v


def edge_matvec(g: lap.EdgeList, backend: str = "auto",
                blocking: backend_mod.NodeBlocking | None = None) -> MatVec:
    """V -> L @ V on the selected backend."""
    return backend_mod.laplacian_matvec_fn(g, backend, blocking)


def series_operator(series: SpectralSeries, matvec: MatVec | None,
                    fused_step: backend_mod.FusedStep | None = None) -> MatVec:
    """V -> (lambda* I - S(L)) V; ``fused_step`` switches the series onto
    its fused evaluator (one kernel call per recurrence step)."""
    if fused_step is not None:
        return lambda v: series.apply_reversed_fused(fused_step, v)
    return lambda v: series.apply_reversed(matvec, v)


def edge_series_operator(g: lap.EdgeList, series: SpectralSeries,
                         backend: str = "auto",
                         blocking: backend_mod.NodeBlocking | None = None
                         ) -> MatVec:
    """The exact_edges operator: series over the edge-list matvec on the
    selected backend (fused series steps on the kernel path)."""
    fused = backend_mod.fused_step_fn(g, backend, blocking)
    if fused is not None:
        return series_operator(series, None, fused_step=fused)
    return series_operator(series, edge_matvec(g, backend="segment"))


def exact_operator(series: SpectralSeries, l_mat: torch.Tensor) -> MatVec:
    """Exact f(L) via eigh (the paper's 'exact' curves), from a series'
    scalar map."""
    lam, vecs = torch.linalg.eigh(l_mat)
    f_lam = series.reversed_scalar(lam)
    a = (vecs * f_lam[None, :]) @ vecs.T
    return lambda v: a @ v


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
                     num_probes: int = 4, num_steps: int = 24,
                     backend: str = "auto"):
    """Probe the graph's spectrum and build an auto-tuned solver operator.

    SLQ-probes lambda_max and the bottom-edge eigengap, plans the
    transform family, degree and strength (:mod:`repro_torch.spectral`)
    and wires the tuned series into the exact-edges operator.  Returns
    (operator, DilationPlan).  ``budget`` caps the series degree;
    ``backend`` selects the kernels of both the probe and the solve.
    The minibatch estimation (and its ``batch_edges``) comes with ROADMAP
    slice 4.
    """
    if estimation == "minibatch":
        raise NotImplementedError(
            "estimation='minibatch' arrives with ROADMAP slice 4, the "
            "stochastic estimators")
    if estimation != "exact_edges":
        raise ValueError(f"unknown estimation mode {estimation!r}")
    from repro_torch import spectral  # deferred: spectral builds on core

    _, plan = spectral.probe_and_plan(
        g, k=k, generator=generator, budget=budget,
        num_probes=num_probes, num_steps=num_steps, backend=backend)
    s = spectral.series_from_plan(plan)
    return edge_series_operator(g, s, backend=backend), plan
