"""Eigenvector-preserving spectrum transformations (paper Sec. 4.1, Table 2).

A transform maps the graph Laplacian L to f(L) with the SAME eigenvectors
and monotonically transformed eigenvalues, followed by the spectrum
reversal of Eq. (8), ``L^- = lambda* I - f(L)``, so bottom-k eigenvectors
of L become top-k of the reversed operator.

``exact_*`` evaluate a transform by eigendecomposition (the paper's
"exact" curves, O(n^3), small problems only); the matrix-free series live
in :mod:`repro_torch.core.series`.  The scalar maps take tensors;
``lambda_star`` takes a Python float and returns one, computed on the
host with ``math`` (no device round trip).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Transform:
    """A named eigenvector-preserving spectral transform.

    scalar(lam) applies f to eigenvalues; lambda_star(rho) is the reversal
    shift of Eq. (8), with lambda* >= f(lambda_max) for rho >= lambda_max,
    so that the reversed spectrum is non-negative and bottom-k -> top-k.
    """

    name: str
    scalar: Callable[[torch.Tensor], torch.Tensor]
    lambda_star: Callable[[float], float]

    def exact_matrix(self, l_mat: torch.Tensor) -> torch.Tensor:
        """f(L) via eigendecomposition (the paper's exact baseline)."""
        lam, v = torch.linalg.eigh(l_mat)
        return (v * self.scalar(lam)[None, :]) @ v.T

    def exact_reversed(self, l_mat: torch.Tensor, rho: float) -> torch.Tensor:
        """lambda* I - f(L): top-k of this = bottom-k of L."""
        n = l_mat.shape[0]
        return (self.lambda_star(rho)
                * torch.eye(n, dtype=l_mat.dtype, device=l_mat.device)
                - self.exact_matrix(l_mat))


def identity_transform() -> Transform:
    return Transform(name="identity", scalar=lambda lam: lam,
                     lambda_star=lambda rho: float(rho) * 1.01)


def neg_exp_transform() -> Transform:
    """f(L) = -e^{-L} (paper Sec. 4.2): its largest eigenvalue is < 0, so
    lambda* = 0 works and the reversed spectral radius is <= 1."""
    return Transform(name="neg_exp", scalar=lambda lam: -torch.exp(-lam),
                     lambda_star=lambda rho: 0.0)


def log_transform(eps: float = 1e-2) -> Transform:
    """f(L) = log(L + eps I) (Table 2): strongly dilates the bottom gaps."""
    return Transform(
        name=f"log_eps{eps:g}", scalar=lambda lam: torch.log(lam + eps),
        lambda_star=lambda rho: math.log(float(rho) + eps) * 1.01 + 1e-3)


def shifted_inverse_transform(shift: float = 1e-1) -> Transform:
    """f(L) = -(L + shift I)^{-1}, the shift-and-invert analogue (App. B)."""
    return Transform(name=f"shift_inv{shift:g}",
                     scalar=lambda lam: -1.0 / (lam + shift),
                     lambda_star=lambda rho: 0.0)


DEFAULT_TRANSFORMS = {
    "identity": identity_transform,
    "neg_exp": neg_exp_transform,
    "log": log_transform,
    "shift_inv": shifted_inverse_transform,
}


def eigengap_ratio(lams: torch.Tensor, k: int) -> torch.Tensor:
    """Convergence-relevant ratio rho / min_i g_i (paper Sec. 3) of
    ascending eigenvalues: rho is the spectral range and g_i the
    consecutive gaps among the bottom k+1.  Lower is better."""
    rho = lams[-1] - lams[0]
    gaps = lams[1: k + 1] - lams[:k]
    return rho / torch.clamp(torch.min(gaps), min=1e-30)


def dilation_factor(lams: torch.Tensor, tf: Transform, k: int) -> torch.Tensor:
    """How much tf improves the ratio: ratio(L) / ratio(f(L)).  > 1 is a win."""
    before = eigengap_ratio(lams, k)
    after = eigengap_ratio(torch.sort(tf.scalar(lams)).values, k)
    return before / after
