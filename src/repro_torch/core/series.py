"""Series approximations to spectrum transforms (paper Sec. 4.2, Table 2).

Each series S provides ``apply(matvec, v)`` computing S(L) @ v with
``degree`` Laplacian matvecs of an (n, k) panel, ``scalar(lam)`` (the
induced spectral map) and a reversal shift ``lambda_star`` folding in
Eq. (8).  Every series is evaluated with its numerically stable
recurrence (a degree-251 power basis would need coefficients ~1e74):

  * ``taylor_log``:     m <- M m with M = L - (1 - eps) I      (Table 2)
  * ``taylor_neg_exp``: t <- -(L t) / i                        (Table 2)
  * ``limit_neg_exp``:  u <- u - (L u) / l, l times, l odd     (Table 2)
  * ``chebyshev``:      Clenshaw recurrence of a Chebyshev fit (beyond paper)

Loops are plain Python loops.  A fused evaluator takes
``fused(u, alpha, beta) = alpha * (L u) + beta * u``, which the kernel
path computes in one pass with the AXPY in the SpMM epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]
# series bodies call an INDEXED matvec mv(i, u), i the position of the
# matvec within the polynomial evaluation (deterministic operators ignore it)
IndexedMatVec = Callable[[int, torch.Tensor], torch.Tensor]
# fused(u, alpha, beta) -> alpha * (L @ u) + beta * u in one pass
FusedStep = Callable[[torch.Tensor, float, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpectralSeries:
    """A polynomial spectral map with a stable matrix-free evaluator.

    The solver-facing operator is ``lambda_star * v - apply(matvec, v)``
    (Eq. 8 reversal: bottom-k of L become top-k).
    """

    name: str
    degree: int
    apply_fn: Callable[[IndexedMatVec, torch.Tensor], torch.Tensor]
    scalar_fn: Callable[[torch.Tensor], torch.Tensor]
    lambda_star: float = 0.0
    # (FusedStep, v) -> S(L) v with each recurrence step's affine folded
    # into one backend call; None => the classic recurrence over fused(u, 1, 0)
    fused_apply_fn: Callable[[FusedStep, torch.Tensor], torch.Tensor] | None = None

    def apply(self, matvec: MatVec, v: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(lambda i, u: matvec(u), v)

    def apply_fused(self, fused_step: FusedStep, v: torch.Tensor) -> torch.Tensor:
        """S(L) v with alpha*Lu+beta*u steps fused into the matvec."""
        if self.fused_apply_fn is None:
            return self.apply_fn(lambda i, u: fused_step(u, 1.0, 0.0), v)
        return self.fused_apply_fn(fused_step, v)

    def apply_reversed_fused(self, fused_step: FusedStep,
                             v: torch.Tensor) -> torch.Tensor:
        return self.lambda_star * v - self.apply_fused(fused_step, v)

    def scalar(self, lam) -> torch.Tensor:
        return self.scalar_fn(torch.as_tensor(lam))

    def apply_reversed(self, matvec: MatVec, v: torch.Tensor) -> torch.Tensor:
        return self.lambda_star * v - self.apply(matvec, v)

    def reversed_scalar(self, lam) -> torch.Tensor:
        return self.lambda_star - self.scalar(lam)


def identity_series() -> SpectralSeries:
    """No-op series paired with a reversal shift set by `with_lambda_star`."""
    return SpectralSeries(
        name="identity", degree=1,
        apply_fn=lambda mv, v: mv(0, v),
        scalar_fn=lambda lam: lam,
        lambda_star=0.0,
    )


def with_lambda_star(s: SpectralSeries, lambda_star: float) -> SpectralSeries:
    return dataclasses.replace(s, lambda_star=float(lambda_star))


def limit_neg_exp(degree: int, scale: float = 1.0) -> SpectralSeries:
    """-(I - s L/l)^l  (Table 2, l odd): u <- u - s (L u)/l, l times."""
    if degree % 2 == 0:
        raise ValueError("degree must be odd (paper Table 2: l is odd)")
    c = scale / degree

    def apply_fn(mv: IndexedMatVec, v: torch.Tensor) -> torch.Tensor:
        u = v
        for i in range(degree):
            u = u - c * mv(i, u)
        return -u

    def fused_apply_fn(fs: FusedStep, v: torch.Tensor) -> torch.Tensor:
        u = v
        for _ in range(degree):
            u = fs(u, -c, 1.0)  # u - c (L u), one fused pass
        return -u

    def scalar_fn(lam):
        return -((1.0 - c * lam) ** degree)

    return SpectralSeries(
        name=f"limit_neg_exp_d{degree}" + ("" if scale == 1.0 else f"_s{scale:g}"),
        degree=degree, apply_fn=apply_fn, scalar_fn=scalar_fn,
        lambda_star=0.0, fused_apply_fn=fused_apply_fn,
    )


def taylor_neg_exp(degree: int) -> SpectralSeries:
    """-sum_{i=0}^{l} (-L)^i / i!  (Table 2), term recurrence t <- -(L t)/i."""
    if degree % 2 == 0:
        raise ValueError("degree must be odd (paper Table 2: l is odd)")

    def apply_fn(mv: IndexedMatVec, v: torch.Tensor) -> torch.Tensor:
        term, acc = v, v
        for i in range(1, degree + 1):
            term = -mv(i, term) / float(i)
            acc = acc + term
        return -acc

    def fused_apply_fn(fs: FusedStep, v: torch.Tensor) -> torch.Tensor:
        term, acc = v, v
        for i in range(1, degree + 1):
            term = fs(term, -1.0 / i, 0.0)  # -(L t)/i
            acc = acc + term
        return -acc

    def scalar_fn(lam):
        term = torch.ones_like(lam)
        acc = torch.ones_like(lam)
        for i in range(1, degree + 1):
            term = -lam * term / i
            acc = acc + term
        return -acc

    return SpectralSeries(
        name=f"taylor_neg_exp_d{degree}", degree=degree,
        apply_fn=apply_fn, scalar_fn=scalar_fn, lambda_star=0.0,
        fused_apply_fn=fused_apply_fn,
    )


def taylor_log(degree: int, eps: float = 1e-2,
               lambda_star: float = 0.0) -> SpectralSeries:
    """sum_{i=1}^{l} (-1)^{i+1} M^i / i,  M = L + (eps-1) I  (Table 2).

    Convergent only for a spectrum of L within (0, 2 - eps).
    """
    a = eps - 1.0

    def _coef(i: int) -> float:
        # the sign / i factor, rounded to fp32 as the JAX package forms it
        return float(np.float32(1.0 if i % 2 == 1 else -1.0) / np.float32(i))

    def apply_fn(mv: IndexedMatVec, v: torch.Tensor) -> torch.Tensor:
        m, acc = v, torch.zeros_like(v)
        for i in range(1, degree + 1):
            m = mv(i, m) + a * m  # M^i v
            acc = acc + _coef(i) * m
        return acc

    def fused_apply_fn(fs: FusedStep, v: torch.Tensor) -> torch.Tensor:
        m, acc = v, torch.zeros_like(v)
        for i in range(1, degree + 1):
            m = fs(m, 1.0, a)  # M m = L m + a m, one fused pass
            acc = acc + _coef(i) * m
        return acc

    def scalar_fn(lam):
        m = torch.ones_like(lam)
        acc = torch.zeros_like(lam)
        for i in range(1, degree + 1):
            m = (lam + a) * m
            acc = acc + ((-1.0) ** (i + 1)) / i * m
        return acc

    return SpectralSeries(
        name=f"taylor_log_d{degree}_eps{eps:g}", degree=degree,
        apply_fn=apply_fn, scalar_fn=scalar_fn, lambda_star=lambda_star,
        fused_apply_fn=fused_apply_fn,
    )


def chebyshev(fn: Callable[[np.ndarray], np.ndarray], degree: int,
              lo: float, hi: float, name: str = "cheb",
              lambda_star: float | None = None) -> SpectralSeries:
    """Beyond-paper: Chebyshev interpolant of `fn` on [lo, hi], applied via
    the Clenshaw recurrence (3 live panels, `degree` matvecs)."""
    j = np.arange(degree + 1)
    nodes_t = np.cos(np.pi * (j + 0.5) / (degree + 1))
    x = 0.5 * (hi - lo) * nodes_t + 0.5 * (hi + lo)
    f = fn(x)
    c = np.empty(degree + 1)
    for i in range(degree + 1):
        c[i] = 2.0 / (degree + 1) * np.sum(
            f * np.cos(np.pi * i * (j + 0.5) / (degree + 1)))
    c[0] *= 0.5
    # fp32 coefficients, as the JAX package holds them
    coeffs = [float(x) for x in c.astype(np.float32)]
    alpha = 2.0 / (hi - lo)
    beta = -(hi + lo) / (hi - lo)

    def apply_fn(mv: IndexedMatVec, v: torch.Tensor) -> torch.Tensor:
        # Clenshaw: b_k = c_k + 2 t(L) b_{k+1} - b_{k+2}
        def t_op(i, u):
            return alpha * mv(i, u) + beta * u

        b1, b2 = torch.zeros_like(v), torch.zeros_like(v)
        for idx in range(degree):
            k = degree - idx  # runs degree..1
            b1, b2 = coeffs[k] * v + 2.0 * t_op(idx, b1) - b2, b1
        return coeffs[0] * v + t_op(degree, b1) - b2

    def fused_apply_fn(fs: FusedStep, v: torch.Tensor) -> torch.Tensor:
        # 2 t(L) b1 = fs(b1, 2a, 2b): the affine map and its doubling ride
        # the SpMM epilogue
        b1, b2 = torch.zeros_like(v), torch.zeros_like(v)
        for idx in range(degree):
            k = degree - idx
            b1, b2 = coeffs[k] * v + fs(b1, 2.0 * alpha, 2.0 * beta) - b2, b1
        return coeffs[0] * v + fs(b1, alpha, beta) - b2

    def scalar_fn(lam):
        t = alpha * lam + beta
        b1 = torch.zeros_like(lam)
        b2 = torch.zeros_like(lam)
        for k in range(degree, 0, -1):
            b1, b2 = coeffs[k] + 2.0 * t * b1 - b2, b1
        return coeffs[0] + t * b1 - b2

    if lambda_star is None:
        lambda_star = float(np.max(f)) * 1.01 + 1e-6
    return SpectralSeries(
        name=f"{name}_d{degree}", degree=degree,
        apply_fn=apply_fn, scalar_fn=scalar_fn, lambda_star=lambda_star,
        fused_apply_fn=fused_apply_fn,
    )


def cheb_neg_exp(degree: int, rho: float, tau: float = 1.0) -> SpectralSeries:
    """Chebyshev fit of -e^{-tau x} on [0, rho]."""
    return chebyshev(
        lambda x: -np.exp(-tau * x), degree, 0.0, rho,
        name=f"cheb_neg_exp_t{tau:g}", lambda_star=0.0)


def cheb_log(degree: int, rho: float, eps: float = 1e-2) -> SpectralSeries:
    """Chebyshev fit of log(x + eps) on [0, rho] (the stable series form of
    the paper's best exact transform, Sec. 5.3)."""
    return chebyshev(
        lambda x: np.log(x + eps), degree, 0.0, rho,
        name=f"cheb_log_eps{eps:g}",
        lambda_star=float(np.log(rho + eps)) * 1.01 + 1e-3)
