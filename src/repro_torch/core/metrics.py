"""Convergence metrics (paper Sec. 5.2)."""
from __future__ import annotations

import torch


def subspace_error(v: torch.Tensor, v_star: torch.Tensor) -> torch.Tensor:
    """Normalized subspace error, Eq. (15): 1 - tr(U* P_t) / k.

    v need not be orthonormal: P uses an orthonormal basis of span(v) by QR.
    """
    k = v_star.shape[1]
    q, _ = torch.linalg.qr(v)
    m = v_star.T @ q  # tr(V* V*^T Q Q^T) = ||V*^T Q||_F^2
    return 1.0 - torch.sum(m * m) / k


def eigenvector_streak(v: torch.Tensor, v_star: torch.Tensor,
                       eps: float = 1e-2) -> torch.Tensor:
    """Longest prefix of eigenvectors with |cos(v_i, v*_i)| >= 1 - eps."""
    vn = v / torch.clamp(torch.linalg.vector_norm(v, dim=0, keepdim=True),
                         min=1e-30)
    cos = torch.abs(torch.sum(vn * v_star, dim=0))
    ok = (cos >= 1.0 - eps).to(torch.int32)
    return torch.sum(torch.cumprod(ok, dim=0))


def panel_residual(v: torch.Tensor, av: torch.Tensor,
                   eps: float = 1e-30) -> torch.Tensor:
    """Relative block-Rayleigh residual ||A V - V (V^T A V)||_F / ||A V||_F."""
    rayleigh = v.T @ av
    r = av - v @ rayleigh
    return torch.linalg.norm(r) / torch.clamp(torch.linalg.norm(av), min=eps)


def operator_residual(matvec, v: torch.Tensor) -> torch.Tensor:
    """``panel_residual`` of a panel under an operator."""
    return panel_residual(v, matvec(v))


def ground_truth_bottom_k(l_mat: torch.Tensor, k: int,
                          drop_trivial: bool = False):
    """Bottom-k eigenpairs of dense L via eigh (ascending)."""
    lam, v = torch.linalg.eigh(l_mat)
    s = 1 if drop_trivial else 0
    return lam[s: s + k], v[:, s: s + k]
