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
