"""Iterative top-k solvers (paper Sec. 5.1): Oja with QR retraction and
mu-EigenGame ("EigenGame Unloaded", Gemp et al. 2021b).

Both consume an operator ``matvec: (n, k) -> (n, k)`` computing A @ V
with A the reversed, transformed Laplacian; the solver finds the top-k
of A, which the Eq. (8) reversal makes the bottom-k of L.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

MatVec = Callable[[torch.Tensor], torch.Tensor]
# stochastic operators additionally take a torch.Generator: op(generator, V)
StochMatVec = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


class SolverState(NamedTuple):
    v: torch.Tensor  # (n, k) current estimate, orthonormal columns
    step: torch.Tensor  # 0-dim int32, on the panel's device


def _zero_step(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_state(generator: torch.Generator, n: int, k: int,
               dtype=torch.float32) -> SolverState:
    """Random orthonormal (n, k) panel drawn on the generator's device."""
    v0 = torch.randn((n, k), generator=generator, dtype=dtype,
                     device=generator.device)
    q, _ = torch.linalg.qr(v0)
    # QR returns column-major Q; keep panels row-major for the row gathers
    return SolverState(v=q.contiguous(), step=_zero_step(q.device))


def _qr_sign_fixed(v: torch.Tensor) -> torch.Tensor:
    q, r = torch.linalg.qr(v)
    sign = torch.sign(torch.diagonal(r))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return (q * sign[None, :]).contiguous()


def init_from_panel(v: torch.Tensor) -> SolverState:
    """Warm start from an (n, k) panel, orthonormalized by QR with the
    sign fix of `oja_step` (diag(R) >= 0)."""
    return SolverState(v=_qr_sign_fixed(v), step=_zero_step(v.device))


def oja_step(state: SolverState, av: torch.Tensor, lr: float) -> SolverState:
    """V <- QR(V + lr * A V), with diag(R) >= 0 for determinism."""
    return SolverState(v=_qr_sign_fixed(state.v + lr * av),
                       step=state.step + 1)


def mu_eg_step(state: SolverState, av: torch.Tensor, lr: float) -> SolverState:
    """One mu-EigenGame (unloaded) update.

    grad_i = A v_i - sum_{j<i} <v_i, A v_j> v_j
    r_i    = grad_i - <v_i, grad_i> v_i
    v_i   <- normalize(v_i + lr * r_i)
    """
    v = state.v
    vav = v.T @ av
    k = v.shape[1]
    lower = torch.tril(torch.ones((k, k), dtype=v.dtype, device=v.device), -1)
    penalties = v @ (lower * vav).T
    grad = av - penalties
    grad = grad - v * torch.sum(v * grad, dim=0, keepdim=True)
    vn = v + lr * grad
    vn = vn / torch.clamp(torch.linalg.vector_norm(vn, dim=0, keepdim=True),
                          min=1e-30)
    return SolverState(v=vn, step=state.step + 1)


def mu_eg_step_fused(state: SolverState, av: torch.Tensor,
                     lr: float) -> SolverState:
    """mu-EigenGame step as two panel passes: the gram of [V | AV] (K3)
    and the mix V' = (V @ M1 + AV @ M2) * colscale (K4)."""
    from repro_torch.kernels.eg_update import ops as eg_ops

    return SolverState(v=eg_ops.mu_eg_update(state.v, av, lr),
                       step=state.step + 1)


def panel_gram2k(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """2k x 2k gram of [V | AV]; row-decomposable (a sum over row
    slices).  K3 on the card, the plain product on the CPU."""
    from repro_torch.kernels.eg_update import ops as eg_ops

    return eg_ops.gram2k(v, av)


def mu_eg_step_from_gram(state: SolverState, av: torch.Tensor,
                         gram: torch.Tensor, lr) -> SolverState:
    """mu-EG update from a precomputed 2k x 2k gram of [V | AV]: the k x k
    coefficient algebra, then the row-local mix (K4 on the card, the
    plain products on the CPU)."""
    from repro_torch.kernels.eg_update import ops as eg_ops
    from repro_torch.kernels.eg_update import ref as eg_ref

    k = state.v.shape[1]
    m1, m2, colscale = eg_ref.coefficient_matrices(gram, k, lr)
    return SolverState(v=eg_ops.panel_mix(state.v, av, m1, m2, colscale),
                       step=state.step + 1)


STEP_FNS = {"oja": oja_step, "mu_eg": mu_eg_step}


def make_step_fn(method: str, backend: str = "auto", device=None):
    """Solver step on the resolved backend: ``mu_eg`` on the kernel path is
    the fused two-pass step; ``oja`` has no kernel form."""
    from repro_torch.core import backend as backend_mod

    dev = resolve_device(device)
    if method == "mu_eg" and backend_mod.resolve_backend(backend, dev) == "kernel":
        return mu_eg_step_fused
    return STEP_FNS[method]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    method: str = "mu_eg"  # "oja" | "mu_eg"
    lr: float = 1e-3
    steps: int = 1000
    eval_every: int = 10
    k: int = 8
    seed: int = 0
    backend: str = "auto"  # solver-step kernels: auto | segment | kernel


class Trace(NamedTuple):
    """Metrics recorded every eval_every steps (device tensors)."""
    steps: torch.Tensor  # (T,)
    subspace_error: torch.Tensor  # (T,)
    streak: torch.Tensor  # (T,)


def run_solver(operator: MatVec | StochMatVec, n: int, cfg: SolverConfig,
               v_star: torch.Tensor | None = None,
               stochastic: bool = False,
               init_v: torch.Tensor | None = None,
               device=None) -> tuple[SolverState, Trace]:
    """Run a solver, recording metrics against ground truth ``v_star``;
    a thin wrapper over :func:`repro_torch.core.program.run_program`
    (a ``stochastic`` operator is called as ``operator(generator, V)``)."""
    from repro_torch.core import program  # program builds on solvers

    return program.run_program(operator, n, cfg, v_star=v_star,
                               stochastic=stochastic, init_v=init_v,
                               device=device)


def steps_to_tolerance(trace: Trace, tol: float) -> int:
    """First recorded step at which subspace error <= tol (or -1)."""
    err = trace.subspace_error.cpu().numpy()
    idx = np.nonzero(err <= tol)[0]
    return int(trace.steps.cpu().numpy()[idx[0]]) if len(idx) else -1


def steps_to_streak(trace: Trace, k: int) -> int:
    """First recorded step with a full-k eigenvector streak (or -1)."""
    st = trace.streak.cpu().numpy()
    idx = np.nonzero(st >= k)[0]
    return int(trace.steps.cpu().numpy()[idx[0]]) if len(idx) else -1
