"""Spectral probes and the dilation planner of the port against the JAX
package.

Lanczos and SLQ run from the SAME numpy start vectors on both sides
(jax.random and torch.Generator draw different numbers).  Past the point
where the Krylov space is exhausted, both recurrences run on round-off
and may add ghost copies of true eigenvalues with tiny weights, at steps
that differ between the two; so Ritz nodes are compared as a quadrature
MEASURE: nodes merged within 1e-4 of lambda_max, their weights summed,
groups of weight < 1e-5 dropped.  Centres must agree to 1e-4 of
lambda_max and masses to 1e-4 (fp32 recurrences summed in other orders
agree to ~1e-6 here).  The host readouts and the planner see identical
fp32 inputs and must agree exactly (floats to 1e-6 relative).  The port's
own random draws are held to the bars of tests/test_spectral.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import spectral as jspectral
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.spectral import plan as jplan
from repro.spectral import probes as jprobes
from repro_torch import convert, spectral
from repro_torch.core import graphs
from repro_torch.core import laplacian as lap
from repro_torch.spectral import plan as plan_mod
from repro_torch.spectral import probes

CPU = "cpu"
SEED = 0


def _pair(name):
    """The same graph from both packages (the generators are numpy)."""
    make = {
        "sbm": lambda m, **d: m.sbm_graph(200, 4, p_in=0.3, p_out=0.05,
                                          seed=0, **d)[0],
        "ring": lambda m, **d: m.ring_of_cliques(5, 12, **d)[0],
        "clique": lambda m, **d: m.clique_graph(120, 4, seed=0, **d)[0],
        "cycle4": lambda m, **d: m.make_edge_list(
            np.array([[0, 1], [1, 2], [2, 3], [0, 3]]), 4, **d),
    }[name]
    mod = jlap if name == "cycle4" else jgraphs
    tmod = lap if name == "cycle4" else graphs
    return make(mod), make(tmod, device=CPU)


GRAPHS = ("sbm", "ring", "clique")


def _eigs(gj) -> np.ndarray:
    return np.linalg.eigvalsh(np.asarray(jlap.laplacian_dense(gj)))


def _measure(theta, w, tol: float):
    """(centres, masses) of the Ritz measure, nodes within tol merged."""
    theta = np.asarray(theta, np.float64).ravel()
    w = np.asarray(w, np.float64).ravel()
    order = np.argsort(theta)
    theta, w = theta[order], w[order]
    centres, masses = [], []
    start = 0
    for i in range(1, len(theta) + 1):
        if i == len(theta) or theta[i] - theta[i - 1] > tol:
            m = w[start:i].sum()
            if m >= 1e-5:
                centres.append(float(np.average(theta[start:i],
                                                weights=w[start:i])))
                masses.append(m)
            start = i
    return np.asarray(centres), np.asarray(masses)


def _assert_same_measure(theta_a, w_a, theta_b, w_b, lam_max):
    tol = 1e-4 * lam_max
    ca, ma = _measure(theta_a, w_a, tol)
    cb, mb = _measure(theta_b, w_b, tol)
    assert ca.shape == cb.shape, (ca, cb)
    np.testing.assert_allclose(ca, cb, rtol=0, atol=tol)
    np.testing.assert_allclose(ma, mb, rtol=0, atol=1e-4)


def _jax_probe_vectors(key, n: int, num_probes: int) -> np.ndarray:
    """The (n, P) probe panel jax's slq_probe draws from ``key``."""
    keys = jax.random.split(key, num_probes)
    return np.stack([np.asarray(jax.random.normal(k, (n,), jnp.float32))
                     for k in keys], axis=1)


# ---------------------------------------------------------------------------
# Lanczos and the tridiagonal eigensolve from the same start vectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS + ("cycle4",))
def test_lanczos_matches_jax(name):
    gj, gt = _pair(name)
    n = gj.num_nodes
    steps = 16 if name == "cycle4" else 24
    lam = _eigs(gj)
    v0 = np.random.default_rng(1).normal(size=(n, 4)).astype(np.float32)
    alpha, beta = probes.lanczos(lambda v: lap.laplacian_matvec(gt, v),
                                 torch.from_numpy(v0), steps)
    assert alpha.shape == beta.shape == (4, steps)
    theta, u = probes._tridiag_eig(alpha, beta)
    for p in range(4):
        aj, bj = jprobes.lanczos(lambda v: jlap.laplacian_matvec(gj, v),
                                 jnp.asarray(v0[:, p]), steps)
        thj, uj = jprobes._tridiag_eig(aj, bj)
        _assert_same_measure(np.asarray(thj), np.asarray(uj[0]) ** 2,
                             theta[p].numpy(), u[p, 0].numpy() ** 2, lam[-1])
        # the Ritz values stay inside the spectrum's hull (as the JAX
        # breakdown test asserts), and breakdown is sticky
        assert float(theta[p].max()) <= lam[-1] + 1e-3
        assert float(theta[p].min()) >= -1e-3
        b = beta[p].numpy()
        dead = np.nonzero(b == 0.0)[0]
        if len(dead):
            assert np.all(b[dead[0]:] == 0.0)
        # one (n, P) panel per step runs each column's own recurrence:
        # the same measure as that column run alone as an (n, 1) panel
        a1, b1 = probes.lanczos(lambda v: lap.laplacian_matvec(gt, v),
                                torch.from_numpy(v0[:, p:p + 1]), steps)
        th1, u1 = probes._tridiag_eig(a1, b1)
        _assert_same_measure(th1[0].numpy(), u1[0, 0].numpy() ** 2,
                             theta[p].numpy(), u[p, 0].numpy() ** 2, lam[-1])


def test_tridiag_eig_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 10, 9).astype(np.float32)
    b = rng.uniform(0, 3, 9).astype(np.float32)
    thj, uj = jprobes._tridiag_eig(jnp.asarray(a), jnp.asarray(b))
    tht, ut = probes._tridiag_eig(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), atol=1e-5)
    np.testing.assert_allclose(ut[0].numpy() ** 2, np.asarray(uj[0]) ** 2,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# SLQ from injected probe vectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_slq_probe_matches_jax_from_same_vectors(name):
    gj, gt = _pair(name)
    n = gj.num_nodes
    key = jax.random.PRNGKey(SEED)
    want = jspectral.probe_graph(gj, key=key)
    v0 = torch.from_numpy(_jax_probe_vectors(key, n, 4))
    got = probes.slq_probe(lambda v: lap.laplacian_matvec(gt, v), n,
                           n_real=n, v0=v0)
    lam_max = float(want.lambda_max)
    assert abs(float(got.lambda_max) - lam_max) <= 1e-4 * lam_max
    assert abs(float(got.trace) - float(want.trace)) <= 1e-4 * float(want.trace)
    assert int(got.num_matvecs) == int(want.num_matvecs) == 96
    assert float(got.n) == float(want.n) == n
    # the pooled measure, i.e. the counting function the planner reads
    _assert_same_measure(np.asarray(want.ritz), np.asarray(want.weights),
                         got.ritz.numpy(), got.weights.numpy(), lam_max)
    # counting functions between (not at) the nodes of the measure
    centres, _ = _measure(np.asarray(want.ritz), np.asarray(want.weights),
                          1e-4 * lam_max)
    for t in np.concatenate([(centres[1:] + centres[:-1]) / 2,
                             [1.5 * lam_max]]):
        assert abs(probes.eigenvalue_count(got, t)
                   - jprobes.eigenvalue_count(want, t)) <= 1e-3 * n


def test_padded_probe_matches_unpadded():
    """A capacity-padded operator with the n_real mask probes the raw
    graph's spectrum (tests/test_spectral.py's streaming contract)."""
    gj, _ = jgraphs.ring_of_cliques(4, 8)
    g, _ = graphs.ring_of_cliques(4, 8, device=CPU)
    gp = lap.pad_edge_list(g, 128)
    gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731
    raw = probes.probe_graph(g, generator=gen())
    padded = probes.probe_edge_arrays(gp.src, gp.dst, gp.weight, gen(),
                                      g.num_nodes, num_nodes=64)
    assert abs(float(padded.lambda_max) - float(raw.lambda_max)) \
        <= 0.05 * float(raw.lambda_max)
    lam = _eigs(gj)
    assert 0.9 * lam[-1] <= float(padded.lambda_max) <= 1.1 * lam[-1]
    assert float(padded.n) == g.num_nodes


# ---------------------------------------------------------------------------
# host readouts: identical inputs, identical answers
# ---------------------------------------------------------------------------

SPECTRA = {
    "doc": np.array([0.0, 0.1, 0.2, 5.0, 6.0, 7.0], np.float32),
    "cut": np.concatenate([np.linspace(0, 2.0, 4),
                           np.linspace(2.1, 40.0, 8)]).astype(np.float32),
    "wide": np.concatenate([np.linspace(0, 0.5, 4),
                            np.linspace(30.0, 40.0, 8)]).astype(np.float32),
    "tight": np.concatenate([np.linspace(0, 20.0, 4),
                             np.linspace(21.0, 40.0, 8)]).astype(np.float32),
    "random": np.sort(np.random.default_rng(4).uniform(0, 50, 300)).astype(
        np.float32),
}


def _both_exact(lam):
    return (jspectral.probe_from_eigenvalues(lam),
            probes.probe_from_eigenvalues(lam, device=CPU))


@pytest.mark.parametrize("name", sorted(SPECTRA))
def test_host_readouts_equal_jax(name):
    pj, pt = _both_exact(SPECTRA[name])
    assert float(pt.lambda_max) == float(pj.lambda_max)
    assert abs(float(pt.trace) - float(pj.trace)) <= 1e-6 * float(pj.trace)
    np.testing.assert_array_equal(pt.weights.numpy(), np.asarray(pj.weights))
    for k in (1, 2, 3, 4, 6, 10):
        assert probes.bottom_edge(pt, k) == jprobes.bottom_edge(pj, k)
    for t in (0.0, 0.15, 1.0, 5.0, 20.0, 60.0):
        assert probes.eigenvalue_count(pt, t) == jprobes.eigenvalue_count(pj, t)
    for bins, hi in ((16, None), (32, 10.0)):
        ej, mj = jprobes.spectral_density(pj, num_bins=bins, hi=hi)
        et, mt = probes.spectral_density(pt, num_bins=bins, hi=hi)
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_array_equal(mt, mj)


def test_probe_from_eigenvalues_is_exact():
    lam = SPECTRA["doc"]
    probe = probes.probe_from_eigenvalues(lam, device=CPU)
    assert float(probe.lambda_max) == pytest.approx(7.0)
    assert float(probe.trace) == pytest.approx(float(lam.sum()))
    lam_k, lam_k1 = probes.bottom_edge(probe, 3)
    assert lam_k == pytest.approx(0.2, abs=1e-6)
    assert lam_k1 == pytest.approx(5.0, abs=1e-6)
    assert probes.eigenvalue_count(probe, 1.0) == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# the planner, field for field
# ---------------------------------------------------------------------------

def _assert_same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for f, wv in w.items():
        if isinstance(wv, float) and np.isnan(wv):
            assert np.isnan(g[f]), (f, g[f], wv)
        elif isinstance(wv, float):
            assert abs(g[f] - wv) <= 1e-6 * max(1.0, abs(wv)), (f, g[f], wv)
        else:
            assert g[f] == wv, (f, g[f], wv)
    assert abs(got.suggested_lr(0.4) - want.suggested_lr(0.4)) \
        <= 1e-6 * want.suggested_lr(0.4)


BUDGETS = (1, 2, 5, 7, 15, 41, 96, 251)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(SPECTRA))
def test_plan_dilation_matches_jax(name, budget):
    pj, pt = _both_exact(SPECTRA[name])
    for k in (2, 4, 8):
        for tau_cap in (None, 4.0, 12.0):
            for families in (plan_mod.FAMILIES, ("identity", "limit_neg_exp"),
                             ("limit_neg_exp", "cheb_neg_exp")):
                for rho_fallback in (None, 30.0):
                    kw = dict(k=k, budget=budget, tau_cap=tau_cap,
                              families=families, rho_fallback=rho_fallback)
                    _assert_same_plan(plan_mod.plan_dilation(pt, **kw),
                                      jplan.plan_dilation(pj, **kw))


@pytest.mark.parametrize("kw", [
    dict(k=4, budget=96),
    dict(k=4, budget=96, rho_fallback=30.0),
    dict(k=4, budget=5, rho_fallback=30.0),
    dict(k=2, budget=96, rho_fallback=30.0, lam_k=1.0, lam_k1=1.5),
    dict(k=4, budget=96, lam_k=2.0, lam_k1=20.0, rho=40.0),
    dict(k=4, budget=41, rho_fallback=0.0),
])
def test_plan_dilation_without_probe_matches_jax(kw):
    _assert_same_plan(plan_mod.plan_dilation(None, **kw),
                      jplan.plan_dilation(None, **kw))


@pytest.mark.parametrize("name", sorted(SPECTRA))
def test_plan_dilation_explicit_gap_matches_jax(name):
    pj, pt = _both_exact(SPECTRA[name])
    for lam_k1 in np.linspace(2.1, 30.0, 7):
        kw = dict(k=4, budget=96, lam_k=2.0, lam_k1=float(lam_k1))
        _assert_same_plan(plan_mod.plan_dilation(pt, **kw),
                          jplan.plan_dilation(pj, **kw))


def test_plan_helpers_match_jax():
    for x in (0.2, 3.0, 4.0, 10.5):
        assert plan_mod._next_odd(x) == jplan._next_odd(x)
    for rho in (0.0, 1.0, 37.5):
        assert plan_mod.identity_lambda_star(rho) == jplan.identity_lambda_star(rho)
        for lam_k in (-1.0, 0.0, 0.5, 20.0, 99.0):
            assert plan_mod.wanted_decay_cap(lam_k, rho) == \
                jplan.wanted_decay_cap(lam_k, rho)
    assert plan_mod.TAU_GRID == jplan.TAU_GRID


@pytest.mark.parametrize("name", sorted(SPECTRA))
def test_series_from_plan_matches_jax(name):
    pj, pt = _both_exact(SPECTRA[name])
    for budget in (5, 15, 96):
        for families in (plan_mod.FAMILIES, ("limit_neg_exp", "cheb_neg_exp")):
            sj = jplan.series_from_plan(
                jplan.plan_dilation(pj, k=4, budget=budget, families=families))
            st = plan_mod.series_from_plan(
                plan_mod.plan_dilation(pt, k=4, budget=budget,
                                       families=families))
            assert (st.name, st.degree) == (sj.name, sj.degree)
            assert abs(st.lambda_star - sj.lambda_star) \
                <= 1e-6 * max(1.0, abs(sj.lambda_star))
            lam = SPECTRA[name].astype(np.float64)
            np.testing.assert_allclose(
                st.reversed_scalar(torch.from_numpy(lam)).numpy(),
                np.asarray(sj.reversed_scalar(jnp.asarray(lam, jnp.float32))),
                rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", GRAPHS)
def test_jax_probe_gives_same_plan_in_both_planners(name):
    gj, gt = _pair(name)
    probe = jspectral.probe_graph(gj, key=jax.random.PRNGKey(SEED))
    carried = convert.probe_result_from_numpy(
        *(np.asarray(x) for x in probe), device=CPU)
    rho_ub = float(lap.spectral_radius_upper_bound(gt))
    for k in (2, 4, 6):
        for budget in (7, 96, 251):
            _assert_same_plan(
                plan_mod.plan_dilation(carried, k=k, budget=budget,
                                       rho_fallback=rho_ub),
                jplan.plan_dilation(probe, k=k, budget=budget,
                                    rho_fallback=rho_ub))


# ---------------------------------------------------------------------------
# the port's own draws against the JAX tests' bars
# ---------------------------------------------------------------------------

def _own_probe(gt, **kw):
    return probes.probe_graph(gt, generator=torch.Generator().manual_seed(SEED),
                              **kw)


@pytest.mark.parametrize("name", GRAPHS)
def test_slq_lambda_max_matches_eigh(name):
    gj, gt = _pair(name)
    lam = _eigs(gj)
    est = float(_own_probe(gt).lambda_max)
    assert 0.9 * lam[-1] <= est <= 1.1 * lam[-1]
    assert est <= float(lap.spectral_radius_upper_bound(gt)) * 1.01


@pytest.mark.parametrize("name", GRAPHS)
def test_slq_density_mass_and_mean(name):
    gj, gt = _pair(name)
    lam = _eigs(gj)
    probe = _own_probe(gt)
    edges, mass = probes.spectral_density(probe, num_bins=16)
    assert mass.shape == (16,)
    np.testing.assert_allclose(mass.sum(), gt.num_nodes, rtol=0.15)
    mids = 0.5 * (edges[:-1] + edges[1:])
    np.testing.assert_allclose(float((mids * mass).sum() / mass.sum()),
                               float(lam.mean()), rtol=0.15)
    np.testing.assert_allclose(float(probe.trace), float(lam.sum()), rtol=0.1)


def test_bottom_edge_localizer_sees_the_cut():
    q, m = 5, 12
    g, _ = graphs.ring_of_cliques(q, m, device=CPU)
    probe = _own_probe(g)
    lam_k, lam_k1 = probes.bottom_edge(probe, q)
    assert lam_k1 >= 0.5 * m
    assert lam_k1 - lam_k >= 0.25 * float(probe.lambda_max)


def test_breakdown_is_clean_on_own_draws():
    gj, gt = _pair("cycle4")
    lam = _eigs(gj)
    probe = _own_probe(gt, num_probes=2, num_steps=16)
    assert probe.ritz.shape == (2, 4)  # num_steps capped at n
    assert float(probe.lambda_max) <= lam[-1] * 1.05 + 1e-5
    assert float(probe.ritz.max()) <= lam[-1] + 1e-3
    assert float(probe.ritz.min()) >= -1e-3


def test_hutchinson_unbiased_exact_and_keyed():
    """Hutchinson under a plain matvec and under a generator-taking
    minibatch matvec (each probe its own batch) both hit tr L."""
    g, _ = graphs.sbm_graph(80, 4, p_in=0.4, p_out=0.05, seed=1, device=CPU)
    tr = float(2.0 * g.weight.sum())
    exact = probes.hutchinson_trace(lambda v: lap.laplacian_matvec(g, v),
                                    g.num_nodes,
                                    torch.Generator().manual_seed(SEED),
                                    num_probes=128)
    np.testing.assert_allclose(float(exact), tr, rtol=0.1)
    e, batch = g.num_edges, 128

    def keyed_mv(gen, v):
        sel = torch.randint(0, e, (batch,), generator=gen)
        return lap.edge_matvec_arrays(g.src[sel], g.dst[sel],
                                      g.weight[sel] * (e / batch), v)

    mb = probes.hutchinson_trace(keyed_mv, g.num_nodes,
                                 torch.Generator().manual_seed(SEED + 1),
                                 num_probes=256, keyed=True)
    np.testing.assert_allclose(float(mb), tr, rtol=0.1)


def test_probe_and_plan_caps_rho_by_gershgorin():
    g, _ = graphs.ring_of_cliques(4, 8, device=CPU)
    probe, plan = spectral.probe_and_plan(
        g, k=4, generator=torch.Generator().manual_seed(SEED))
    rho_ub = float(lap.spectral_radius_upper_bound(g))
    assert plan.rho == min(float(probe.lambda_max), rho_ub)
    assert plan.probe_matvecs == 96
    s = spectral.series_from_plan(plan)
    lam = torch.from_numpy(np.linalg.eigvalsh(
        lap.laplacian_dense(g).double().numpy()))
    assert bool(torch.all(torch.diff(s.reversed_scalar(lam)) <= 1e-5))
