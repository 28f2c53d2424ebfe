"""Stochastic estimation of Laplacian powers by random walks on the edge
incidence graph (paper Sec. 4.3, Eqs. 12-14).

Identity (Eq. 12):  L^l = sum_{chains c in E^l} alpha_c x_{e_1} x_{e_l}^T,
where alpha_c = prod_j x_{e_j}^T x_{e_{j+1}} is nonzero exactly when
consecutive edges are incident, i.e. when (e_1 .. e_l) is a walk on the
edge incidence graph (self loops included; Table 1 gives the factors
{2, +-1}).

A walk starts at a uniform edge and steps to a uniform incident edge
l - 1 times; its probability is p_l = (1/|E|) prod_{i<l} 1/deg(e_i)
(Eq. 13).  Two unbiased estimators:

  * ``rejection`` (the paper's): accept with probability p_min / p_l,
    p_min = (2 deg* - 1)^{-(l-1)} / |E| (Eq. 14), and weight the
    accepted chains by 1 / p_min.
  * ``importance`` (beyond the paper): weight each walk by alpha_c / p_l,
    a Horvitz-Thompson estimator with no rejection and lower variance.

The sampler is vectorised over walkers with a Python loop over the
l - 1 steps; the estimators are gathers and ``index_add_`` scatters.
The JAX package has no Pallas kernel here, so plain PyTorch is the port.
One batch of length-l walks estimates every power i <= l at once: the
prefix products alpha_{1:i} with endpoints (e_1, e_i) estimate L^i.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.laplacian import EdgeIncidence, EdgeList


class WalkBatch(NamedTuple):
    """Batch of length-l walks with per-prefix statistics.

    For walker w and prefix index i (the power L^{i+1} uses i steps):
      first_edge[w]  - e_1
      edge_at[w, i]  - the edge after i steps (edge_at[w, 0] = e_1)
      alpha[w, i]    - product of the first i incidence inner products
      logp[w, i]     - log p of the (i+1)-edge prefix walk (Eq. 13)
    """

    first_edge: torch.Tensor  # (W,) int32
    edge_at: torch.Tensor  # (W, l) int32
    alpha: torch.Tensor  # (W, l) float32
    logp: torch.Tensor  # (W, l) float32


def sample_walks(generator: torch.Generator, inc: EdgeIncidence,
                 num_walkers: int, length: int) -> WalkBatch:
    """Draw ``num_walkers`` independent walks of ``length`` edges on the
    incidence graph's device.

    The slot of each step is floor(u * d) for u uniform in [0, 1) in
    float64, clamped to d - 1, with d the current edge's incidence
    degree: uniform on [0, d) up to float64 rounding (d / 2^53), and
    never the self-padding at slot d or past it.
    """
    dev = inc.nbrs.device
    e = inc.nbrs.shape[0]
    deg = inc.deg.long()
    cur = torch.randint(0, e, (num_walkers,), generator=generator, device=dev)
    alpha = torch.ones((num_walkers,), dtype=torch.float32, device=dev)
    logp = torch.full((num_walkers,), -float(np.log(np.float32(e))),
                      dtype=torch.float32, device=dev)
    edges, alphas, logps = [cur], [alpha], [logp]
    for _ in range(length - 1):
        d = deg[cur]
        u = torch.rand((num_walkers,), generator=generator,
                       dtype=torch.float64, device=dev)
        slot = torch.minimum((u * d).long(), d - 1)
        alpha = alpha * inc.ip[cur, slot]
        logp = logp - torch.log(d.float())
        cur = inc.nbrs[cur, slot].long()
        edges.append(cur)
        alphas.append(alpha)
        logps.append(logp)
    return WalkBatch(first_edge=edges[0].int(),
                     edge_at=torch.stack(edges, dim=1).int(),
                     alpha=torch.stack(alphas, dim=1),
                     logp=torch.stack(logps, dim=1))


def _accumulate_rank1(out: torch.Tensor, g: EdgeList, e_first: torch.Tensor,
                      e_last: torch.Tensor, coeff: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """out += sum_w coeff[w] * x_{e_first[w]} (x_{e_last[w]}^T v), in place.

    x_e has two nonzeros (+1 at src, -1 at dst), so each term is a
    two-row scatter of a two-row gather: O(W k), never n x n.
    """
    src, dst = g.src.long(), g.dst.long()
    last, first = e_last.long(), e_first.long()
    xv = v.index_select(0, src[last]) - v.index_select(0, dst[last])
    contrib = coeff[:, None] * xv
    out.index_add_(0, src[first], contrib)
    out.index_add_(0, dst[first], -contrib)
    return out


def estimate_power_matvec(walks: WalkBatch, g: EdgeList, inc: EdgeIncidence,
                          power: int, v: torch.Tensor,
                          mode: str = "importance",
                          generator: torch.Generator | None = None,
                          uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased estimate of L^power @ v (v is (n, k)) from the
    length-``power`` prefixes of a walk batch.

    ``mode``: 'importance' (weights alpha / p, no rejection) or
    'rejection' (the Eq. 14 accept coin, as a mask).  The coin is
    ``uniform`` (W,) when injected, else drawn from ``generator``.
    """
    i = power - 1
    w = walks.first_edge.shape[0]
    alpha = walks.alpha[:, i]
    logp = walks.logp[:, i]
    if mode == "importance":
        coeff = alpha * torch.exp(-logp) / w
    elif mode == "rejection":
        if uniform is None:
            if generator is None:
                raise ValueError("rejection mode needs a generator or an "
                                 "injected uniform draw for the accept coin")
            uniform = torch.rand((w,), generator=generator, device=v.device)
        f32 = dict(dtype=torch.float32, device=v.device)
        log_pmin = (-power * torch.log(torch.tensor(float(inc.deg_star_inc), **f32))
                    - torch.log(torch.tensor(float(g.num_edges), **f32)))
        # accept w.p. p_min / p_l (<= 1 by construction of deg*_inc)
        p_acc = torch.exp(torch.clamp(log_pmin - logp, max=0.0))
        accept = uniform < p_acc
        coeff = torch.where(accept, alpha, 0.0) * torch.exp(-log_pmin) / w
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return _accumulate_rank1(torch.zeros_like(v), g, walks.first_edge,
                             walks.edge_at[:, i], coeff, v)


def walk_polynomial_operator(g: EdgeList, inc: EdgeIncidence,
                             coeffs: tuple[float, ...], lambda_star: float,
                             num_walkers: int, mode: str = "importance"):
    """``op(generator, V, walks=None)`` -> (lambda* I - P(L)) V with
    P(L) = sum_i coeffs[i] L^i estimated from ONE shared batch of
    length-max(deg, 2) walks (paper Sec. 4.3: a walk estimates all the
    shorter powers).  An injected ``walks`` replaces the draw; rejection
    coins come from ``generator``.  Meant for low degrees, where the walk
    variance stays manageable; a high-degree series takes the minibatch
    operator.
    """
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("need degree >= 1")

    def op(generator: torch.Generator, v: torch.Tensor,
           walks: WalkBatch | None = None) -> torch.Tensor:
        if walks is None:
            walks = sample_walks(generator, inc, num_walkers, max(deg, 2))
        acc = coeffs[0] * v
        for p in range(1, deg + 1):
            acc = acc + coeffs[p] * estimate_power_matvec(
                walks, g, inc, p, v, mode=mode, generator=generator)
        return lambda_star * v - acc

    return op


# ---------------------------------------------------------------------------
# Dense-estimate helpers (tests: estimate L^l itself, not L^l v).
# ---------------------------------------------------------------------------

def estimate_power_dense(walks: WalkBatch, g: EdgeList, inc: EdgeIncidence,
                         power: int, n: int, mode: str = "importance",
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """The L^power estimate as an (n, n) matrix (test-sized graphs only):
    the estimator applied to I."""
    eye = torch.eye(n, dtype=torch.float32, device=g.device)
    return estimate_power_matvec(walks, g, inc, power, eye, mode=mode,
                                 generator=generator)


def lowdeg_negexp_coeffs(degree: int, rho: float, tau: float = 1.0
                         ) -> tuple[float, ...]:
    """Power-basis coefficients of a degree-``degree`` Chebyshev-node fit
    of -e^{-tau x} on [0, rho].  Low degrees only (<= ~10): the walk
    estimator needs one coefficient per L^i, and at such degrees the
    basis conversion is numerically safe in float64.
    """
    j = np.arange(degree + 1)
    t = np.cos(np.pi * (j + 0.5) / (degree + 1))
    x = 0.5 * rho * (t + 1.0)
    f = -np.exp(-tau * x)
    v = np.vander(x, degree + 1, increasing=True)
    coeffs, *_ = np.linalg.lstsq(v, f, rcond=None)
    return tuple(float(c) for c in coeffs)
