"""Spectral series and operators of the port against the JAX package.

Each series runs through the JAX segment operator and through the port's
classic recurrence and fused evaluator (the fused step built on the
plain twins of K1 and K2, as the kernel path builds it on the card).
Tolerance 1e-5 max-abs, the TOL of tests/test_backend.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import laplacian as jlap
from repro.core import operators as jops
from repro.core import series as jseries
from repro_torch.core import backend, operators, series
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops

TOL = 1e-5
CPU = "cpu"


def _pair(seed: int, n: int, e: int, target: float = 1.5):
    """Edges scaled so the Gershgorin radius is `target`, the regime every
    production series runs in (and the only one where taylor_log converges)."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    g0 = jlap.make_edge_list(edges, n, weights=w)
    w = np.asarray(g0.weight * (target / float(jlap.spectral_radius_upper_bound(g0))))
    return (jlap.make_edge_list(edges, n, weights=w),
            lap.make_edge_list(edges, n, weights=w, device=CPU))


CASES = {"weighted": lambda: _pair(0, 96, 300),
         "non_aligned": lambda: _pair(2, 301, 517)}

SERIES = {
    "limit_neg_exp": lambda m: m.limit_neg_exp(7, scale=0.4),
    "taylor_neg_exp": lambda m: m.taylor_neg_exp(5),
    "taylor_log": lambda m: m.taylor_log(5),
    "cheb_log": lambda m: m.cheb_log(12, rho=1.5),
    "cheb_neg_exp": lambda m: m.cheb_neg_exp(9, rho=1.5, tau=2.0),
    "identity": lambda m: m.with_lambda_star(m.identity_series(), 1.6),
}


def _panel(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _fused_steps(gt):
    """The fused steps the kernel path builds, over the plain twins: K1's
    edge form and K2's node-blocked form (block_n far below n)."""
    nb = backend.blocking_for(gt, block_n=32)
    return {
        "edge": lambda u, a, b: es_ops.edge_spmm(gt.src, gt.dst, gt.weight, u,
                                                 alpha=a, beta=b),
        "blocked": lambda u, a, b: es_ops.edge_spmm_blocked(nb, u, alpha=a,
                                                            beta=b),
    }


@pytest.mark.parametrize("name", sorted(SERIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_series_operator_matches_jax(case, name):
    gj, gt = CASES[case]()
    sj, st = SERIES[name](jseries), SERIES[name](series)
    assert st.name == sj.name and st.degree == sj.degree
    assert abs(st.lambda_star - sj.lambda_star) <= 1e-6 * max(1.0, abs(sj.lambda_star))
    v = _panel(6, gj.num_nodes, 4)
    want = jops.edge_series_operator(gj, sj, backend="segment")(jnp.asarray(v))
    tv = torch.from_numpy(v)
    got = operators.edge_series_operator(gt, st, backend="segment")(tv)
    assert _maxabs(got.numpy(), want) <= TOL
    for kind, fs in _fused_steps(gt).items():
        got = operators.series_operator(st, None, fused_step=fs)(tv)
        assert _maxabs(got.numpy(), want) <= TOL, kind


@pytest.mark.parametrize("name", sorted(SERIES))
def test_scalar_maps_match_jax(name):
    sj, st = SERIES[name](jseries), SERIES[name](series)
    lam = np.linspace(0.0, 1.5, 31).astype(np.float32)
    assert _maxabs(st.reversed_scalar(torch.from_numpy(lam)).numpy(),
                   sj.reversed_scalar(jnp.asarray(lam))) <= TOL


def test_limit_neg_exp_fused_is_one_affine_per_step():
    """Degree-l limit series = l fused calls of (alpha=-c, beta=1)."""
    calls = []

    def fs(u, a, b):
        calls.append((a, b))
        return b * u + a * u  # L = I
    s = series.limit_neg_exp(9, scale=0.45)
    out = s.apply_fused(fs, torch.ones(3, 2))
    assert calls == [(-0.05, 1.0)] * 9
    torch.testing.assert_close(out, -(0.95 ** 9) * torch.ones(3, 2))


def test_even_degree_and_unknown_series_rejected():
    with pytest.raises(ValueError):
        series.limit_neg_exp(8)
    with pytest.raises(ValueError):
        series.taylor_neg_exp(4)


def test_exact_operator_matches_jax():
    gj, gt = CASES["weighted"]()
    sj, st = SERIES["limit_neg_exp"](jseries), SERIES["limit_neg_exp"](series)
    v = _panel(8, gj.num_nodes, 3)
    want = jops.exact_operator(sj, jlap.laplacian_dense(gj))(jnp.asarray(v))
    got = operators.exact_operator(st, lap.laplacian_dense(gt))(
        torch.from_numpy(v))
    assert _maxabs(got.numpy(), want) <= 1e-4  # two eigh routines, fp32
