"""Warm-started SPED solver sessions (Zhuzhunashvili & Knyazev-style).

On a streaming graph consecutive solves differ by a small edge
perturbation, so the previous eigenvector panel V is an excellent initial
guess, UNLESS the graph changed so much that iterating from V is slower
than restarting.  The restart-vs-continue decision is the ground-truth
free block residual of the OLD panel under the NEW operator:

    r = ||A V - V (V^T A V)||_F / ||A V||_F     (metrics.panel_residual)

r small -> continue from QR(V) (``solvers.init_from_panel``);
r large -> restart from a random panel.

Each chunk is ``program.run_chunk`` with the step of
``solvers.make_step_fn(method)`` on the panel's device, so mu-EG runs on
K3/K4 on the card; a :class:`~repro_torch.core.operators.CapturedOperator`
keeps its graphs across chunks and re-solves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import metrics, program, solvers

MatVec = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WarmConfig:
    # residual above which the previous panel is considered uninformative
    # (a random orthonormal panel sits near sqrt(1 - k/n) ~ 1)
    restart_residual: float = 0.6
    tol: float = 1e-3  # reconvergence target on panel_residual
    chunk: int = 10  # solver steps between residual checks
    max_steps: int = 5000
    lr: float = 0.1
    method: str = "mu_eg"


def warm_start_state(generator: torch.Generator, op: MatVec, n: int, k: int,
                     v_prev: torch.Tensor | None,
                     restart_residual: float = 0.6
                     ) -> tuple[solvers.SolverState, dict]:
    """Seed a solver session: the previous panel if it passes the restart
    test, else a random panel drawn from ``generator`` (drawn in either
    case, as the JAX package draws its cold state first)."""
    cold = solvers.init_state(generator, n, k)
    if v_prev is None:
        return cold, {"warm": False, "residual": None}
    state = solvers.init_from_panel(v_prev)
    res = float(metrics.operator_residual(op, state.v))
    if res <= restart_residual:
        return state, {"warm": True, "residual": res}
    return cold, {"warm": False, "residual": res}


def run_to_tolerance(op: MatVec, state: solvers.SolverState, cfg: WarmConfig
                     ) -> tuple[solvers.SolverState, int, float]:
    """Iterate chunks of ``cfg.chunk`` steps until panel_residual <=
    cfg.tol or ``cfg.max_steps``; returns (state, iterations_used,
    final_residual).  The host reads one residual per chunk."""
    step_fn = solvers.make_step_fn(cfg.method, device=state.v.device)
    used = 0
    res = float(metrics.operator_residual(op, state.v))
    while res > cfg.tol and used < cfg.max_steps:
        state, r = program.run_chunk(op, step_fn, state, cfg.lr, cfg.chunk)
        used += cfg.chunk
        res = float(r)
    return state, used, res


def reconverge(generator: torch.Generator, op: MatVec, n: int, k: int,
               cfg: WarmConfig, v_prev: torch.Tensor | None = None
               ) -> tuple[solvers.SolverState, dict]:
    """Full warm (or cold, if v_prev fails the restart test) re-solve.
    Returns (state, info) with info["iterations"] and info["residual"]."""
    state, info = warm_start_state(generator, op, n, k, v_prev,
                                   cfg.restart_residual)
    state, used, res = run_to_tolerance(op, state, cfg)
    return state, dict(info, iterations=used, residual=res)
