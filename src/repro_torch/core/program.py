"""The single-panel solve loop.

:func:`apply_solver_step` is THE one place a mu-EG/Oja solver step is
built; :func:`run_chunk` and :func:`run_program` (the engine of
``solvers.run_solver``) are plain Python loops over it.  Trace metrics
stay on the device and are stacked at the end, so the loop never waits
on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import metrics, solvers
from repro_torch.device import resolve_device

MatVec = Callable[[torch.Tensor], torch.Tensor]


def apply_solver_step(step_fn, state: solvers.SolverState, av: torch.Tensor,
                      lr, gram: torch.Tensor | None = None
                      ) -> solvers.SolverState:
    """THE construction site of the mu-EG/Oja dilated solver step.

    ``gram`` is the hook for a caller that already holds the global
    2k x 2k gram of [V | AV]: the mu-EG update then runs row-locally
    (:func:`solvers.mu_eg_step_from_gram`).
    """
    if gram is not None:
        return solvers.mu_eg_step_from_gram(state, av, gram, lr)
    return step_fn(state, av, lr)


def run_chunk(opv: MatVec, step_fn, state: solvers.SolverState, lr,
              steps: int) -> tuple[solvers.SolverState, torch.Tensor]:
    """``steps`` dilated solver steps on one panel + one residual eval."""
    for _ in range(steps):
        state = apply_solver_step(step_fn, state, opv(state.v), lr)
    return state, metrics.operator_residual(opv, state.v)


def run_program(operator: MatVec | solvers.StochMatVec, n: int,
                cfg: solvers.SolverConfig,
                v_star: torch.Tensor | None = None,
                stochastic: bool = False,
                init_v: torch.Tensor | None = None,
                device=None) -> tuple[solvers.SolverState, solvers.Trace]:
    """One-shot solve with ground-truth traces, ``run_solver``'s engine.

    Runs ``max(1, steps // eval_every)`` evals of ``eval_every`` steps
    each (the JAX package's cadence).  One ``torch.Generator`` seeded
    with ``cfg.seed`` on ``device`` (``None`` = the CUDA card, or
    ``init_v``'s device when given) drives the solve: the random initial
    panel is its first draw, and a ``stochastic`` operator, called as
    ``operator(generator, V)``, draws each step's batches after it from
    the same stream, so they never repeat the initial panel's bits.
    ``init_v`` warm-starts from an (n, k) panel via ``init_from_panel``
    and leaves the whole stream to the operator.
    """
    dev = init_v.device if init_v is not None else resolve_device(device)
    step_fn = solvers.make_step_fn(cfg.method, cfg.backend, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    if init_v is None:
        state = solvers.init_state(gen, n, cfg.k)
    else:
        state = solvers.init_from_panel(init_v)
    num_evals = max(1, cfg.steps // cfg.eval_every)
    if v_star is None:
        v_star = torch.zeros((n, cfg.k), dtype=torch.float32, device=dev)
    steps, err, streak = [], [], []
    for _ in range(num_evals):
        for _ in range(cfg.eval_every):
            av = operator(gen, state.v) if stochastic else operator(state.v)
            state = apply_solver_step(step_fn, state, av, cfg.lr)
        steps.append(state.step)
        err.append(metrics.subspace_error(state.v, v_star))
        streak.append(metrics.eigenvector_streak(state.v, v_star))
    return state, solvers.Trace(steps=torch.stack(steps),
                                subspace_error=torch.stack(err),
                                streak=torch.stack(streak))
