"""First-order incremental eigen-updates with drift-triggered fallback.

Dhanjal et al. ("Efficient Eigen-updating for Spectral Graph Clustering")
update the eigenbasis of a streaming graph far cheaper than re-solving.
An edge batch with realized weight deltas {dw_e} is the perturbation
ΔL = Σ_e dw_e x_e x_eᵀ (rank <= B), and for eigenpairs (λ_i, v_i) of L:

    λ_i' ≈ λ_i + v_iᵀ ΔL v_i
    v_i' ≈ v_i + Σ_{j≠i} (v_jᵀ ΔL v_i) / (λ_i - λ_j) · v_j

from B-edge matvecs: O(B k + n k^2), no solver iterations.  A Frobenius
drift bound Σ batches Σ_e 2|dw_e| >= accumulated ||ΔL||_F triggers a
FALLBACK to a full (warm-started, dilated) re-solve when it exceeds
``fallback_ratio`` × (min panel eigengap).

``delta_matvec`` stays the plain gather/scatter on every device: it
touches the B edges of a batch only, where a kernel launch would first
build an O(n) row CSR.  The anchors run K1/K2.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core.laplacian import edge_matvec_arrays
from repro_torch.core.solvers import _qr_sign_fixed

MatVec = Callable[[torch.Tensor], torch.Tensor]


class EigenEstimate(NamedTuple):
    """Tracked bottom-k eigenpairs of L plus accumulated perturbation."""

    lam: torch.Tensor  # (k,) eigenvalue estimates
    v: torch.Tensor  # (n, k) orthonormal panel
    drift: torch.Tensor  # () accumulated upper bound on ||ΔL||_F since solve


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    # fallback when drift > fallback_ratio * min eigengap of the panel
    fallback_ratio: float = 0.5
    gap_floor: float = 1e-8  # denominators |λ_i - λ_j| below this are skipped


def estimate_from_panel(matvec: MatVec, v: torch.Tensor) -> EigenEstimate:
    """Anchor an estimate at a freshly solved panel: λ = diag(VᵀLV)."""
    lam = torch.diagonal(v.T @ matvec(v))
    return EigenEstimate(lam=lam, v=v,
                         drift=torch.zeros((), dtype=v.dtype, device=v.device))


def anchor_estimate(fused: backend_mod.FusedStep,
                    v: torch.Tensor) -> EigenEstimate:
    """Anchor an estimate over a fused step (e.g.
    ``stream.graph_store.fused_step(store)``): lambda = diag(Vᵀ L V),
    drift reset; one K1/K2 launch on the kernel path."""
    return estimate_from_panel(lambda x: fused(x, 1.0, 0.0), v)


def anchor_estimate_arrays(src: torch.Tensor, dst: torch.Tensor,
                           w: torch.Tensor, v: torch.Tensor,
                           backend: str = "auto") -> EigenEstimate:
    """:func:`anchor_estimate` on a padded edge buffer (the kernel path
    builds its row CSR here)."""
    return anchor_estimate(
        backend_mod.buffers_fused_step(src, dst, w, v.shape[0], backend), v)


def delta_matvec(src: torch.Tensor, dst: torch.Tensor, dw: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """ΔL @ v for an edge batch with realized weight deltas dw, O(B k)."""
    return edge_matvec_arrays(src, dst, dw, v)


def delta_norm_bound(dw: torch.Tensor) -> torch.Tensor:
    """||ΔL||_F <= Σ_e 2|dw_e| (each dw_e x_e x_eᵀ has Frobenius norm
    exactly 2|dw_e|).  A per-edge sum, not 2·sqrt(Σdw²): edges sharing an
    endpoint stack their diagonal contributions."""
    return 2.0 * torch.sum(torch.abs(dw))


def min_gap(lam: torch.Tensor, floor: float = 1e-8) -> torch.Tensor:
    """Smallest consecutive gap of the sorted eigenvalue estimates."""
    s = torch.sort(lam).values
    return torch.clamp(torch.min(s[1:] - s[:-1]), min=floor)


def first_order_update(est: EigenEstimate, src: torch.Tensor,
                       dst: torch.Tensor, dw: torch.Tensor,
                       gap_floor: float = 1e-8) -> EigenEstimate:
    """One Dhanjal-style first-order eigen-update for an edge batch.

    Correction terms between eigenpairs closer than ``gap_floor`` are
    skipped.  Orthonormality is restored by the sign-fixed QR of the
    solvers (diag(R) >= 0), so the card and the CPU choose one sign.
    """
    dv = delta_matvec(src, dst, dw, est.v)  # ΔL V, (n, k)
    c = est.v.T @ dv  # c[j, i] = v_jᵀ ΔL v_i
    lam_new = est.lam + torch.diagonal(c)
    k = est.lam.shape[0]
    denom = est.lam[None, :] - est.lam[:, None]  # [j, i] = λ_i - λ_j
    offdiag = ~torch.eye(k, dtype=torch.bool, device=est.v.device)
    safe = offdiag & (torch.abs(denom) > gap_floor)
    coef = torch.where(safe, c / torch.where(safe, denom, 1.0), 0.0)
    v_new = est.v + est.v @ coef  # column i += Σ_j coef[j, i] v_j
    return EigenEstimate(lam=lam_new, v=_qr_sign_fixed(v_new),
                         drift=est.drift + delta_norm_bound(dw))


def should_fallback(est: EigenEstimate,
                    cfg: UpdateConfig = UpdateConfig()) -> torch.Tensor:
    """True when accumulated perturbation endangers first-order validity."""
    return est.drift > cfg.fallback_ratio * min_gap(est.lam, cfg.gap_floor)


def update_or_flag(est: EigenEstimate, src: torch.Tensor, dst: torch.Tensor,
                   dw: torch.Tensor, cfg: UpdateConfig = UpdateConfig()
                   ) -> tuple[EigenEstimate, bool]:
    """Apply the first-order update; report whether the caller must now
    fall back to a full re-solve (and re-anchor with
    :func:`estimate_from_panel` after it)."""
    est = first_order_update(est, src, dst, dw, gap_floor=cfg.gap_floor)
    return est, bool(should_fallback(est, cfg))
