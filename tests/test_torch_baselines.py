"""The rest of the port's core against the JAX package: the incidence
matrix and normalized Laplacian, the spectrum transforms, the related-work
baselines (Bethe Hessian, CG, shift-and-invert, Lanczos) and
common-neighbors link prediction.

Tolerances: the incidence matrix and linkpred's edge list bitwise (the
same numpy on both sides); dense matrices and one CG or shift-invert
application to 1e-5 max-abs (the TOL of tests/test_backend.py); maps
through eigh to 1e-5 of their scale (two fp32 eigensolvers).  The
k-means of the Bethe clustering draws from a torch.Generator, so it is
held to tests/test_baselines.py's bars (agreement > 0.9, >= 3 negative
eigenvalues), as are Lanczos (eigenvalues within 1e-3 of eigh) and the
shift-invert solve (subspace error < 1e-2).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import linkpred as jlink
from repro.core import operators as jops
from repro.core import transforms as jtf
from repro_torch.core import (SolverConfig, baselines, graphs, linkpred,
                              metrics, operators, run_solver, transforms)
from repro_torch.core import laplacian as lap
from repro_torch.core.kmeans import cluster_agreement

CPU = "cpu"
TOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _graph_pair(seed=0, n=40, e=120, self_loops=False):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2))
    if not self_loops:
        edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, len(edges)).astype(np.float32)
    return (jlap.make_edge_list(edges, n, weights=w),
            lap.make_edge_list(edges, n, weights=w, device=CPU))


@pytest.mark.parametrize("self_loops", [False, True])
def test_incidence_matrix_matches_jax_bitwise(self_loops):
    gj, gt = _graph_pair(1, self_loops=self_loops)
    xt = lap.incidence_matrix(gt)
    np.testing.assert_array_equal(_np(xt), np.asarray(jlap.incidence_matrix(gj)))
    if not self_loops:  # X^T W X = L
        lt = xt.T @ (gt.weight[:, None] * xt)
        assert _maxabs(lt, lap.laplacian_dense(gt)) <= TOL


def test_normalized_laplacian_matches_jax():
    # node 39 isolated: its row and column of D^-1/2 A D^-1/2 stay zero
    gj, gt = _graph_pair(2, n=40, e=100)
    keep = (gt.src < 39) & (gt.dst < 39)
    gt = lap.EdgeList(gt.src[keep], gt.dst[keep], gt.weight[keep], 40)
    gj = jlap.EdgeList(jnp.asarray(_np(gt.src)), jnp.asarray(_np(gt.dst)),
                       jnp.asarray(_np(gt.weight)), 40)
    got = lap.normalized_laplacian_dense(gt)
    assert _maxabs(got, jlap.normalized_laplacian_dense(gj)) <= TOL
    assert float(got[39, 39]) == 1.0


# ---------------------------------------------------------------------------
# spectrum transforms
# ---------------------------------------------------------------------------

TRANSFORMS = sorted(transforms.DEFAULT_TRANSFORMS)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_maps_match_jax(name):
    tt, tj = transforms.DEFAULT_TRANSFORMS[name](), jtf.DEFAULT_TRANSFORMS[name]()
    assert tt.name == tj.name
    lam = np.linspace(0.0, 7.5, 31).astype(np.float32)
    want = np.asarray(tj.scalar(jnp.asarray(lam)))
    got = _np(tt.scalar(torch.from_numpy(lam)))
    assert _maxabs(got, want) <= TOL * max(1.0, float(np.abs(want).max()))
    for rho in (0.5, 7.5):
        assert math.isclose(tt.lambda_star(rho), float(tj.lambda_star(rho)),
                            rel_tol=1e-6, abs_tol=1e-7)
        assert isinstance(tt.lambda_star(rho), float)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_exact_transforms_and_operator_match_jax(name):
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    gj, _ = jgraphs.ring_of_cliques(3, 6)
    l_t, l_j = lap.laplacian_dense(g), jlap.laplacian_dense(gj)
    tt, tj = transforms.DEFAULT_TRANSFORMS[name](), jtf.DEFAULT_TRANSFORMS[name]()
    for got, want in ((tt.exact_matrix(l_t), tj.exact_matrix(l_j)),
                      (tt.exact_reversed(l_t, 7.0), tj.exact_reversed(l_j, 7.0))):
        assert _maxabs(got, want) <= TOL * max(1.0, float(jnp.abs(want).max()))
    v = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    want = jops.exact_operator(tj, l_j)(jnp.asarray(v))
    got = operators.exact_operator(tt, l_t)(torch.from_numpy(v))
    assert _maxabs(got, want) <= TOL * max(1.0, float(jnp.abs(want).max()))


@pytest.mark.parametrize("name", TRANSFORMS)
def test_eigengap_ratio_and_dilation_factor_match_jax(name):
    lam = np.sort(np.random.default_rng(4).uniform(0, 6, 20)).astype(np.float32)
    lam[0] = 0.0
    tt, tj = transforms.DEFAULT_TRANSFORMS[name](), jtf.DEFAULT_TRANSFORMS[name]()
    for k in (1, 3, 5):
        want = float(jtf.eigengap_ratio(jnp.asarray(lam), k))
        got = float(transforms.eigengap_ratio(torch.from_numpy(lam), k))
        assert math.isclose(got, want, rel_tol=TOL)
        want = float(jtf.dilation_factor(jnp.asarray(lam), tj, k))
        got = float(transforms.dilation_factor(torch.from_numpy(lam), tt, k))
        assert math.isclose(got, want, rel_tol=1e-4)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def test_bethe_hessian_recovers_sbm_communities():
    g, truth = graphs.sbm_graph(180, 3, p_in=0.25, p_out=0.01, seed=0, device=CPU)
    labels, info = baselines.bethe_hessian_cluster(g, 3)
    assert float(cluster_agreement(labels, truth, 3)) > 0.9
    assert info["negative_eigs"] >= 3
    gj, _ = jgraphs.sbm_graph(180, 3, p_in=0.25, p_out=0.01, seed=0)
    hj, rj = jbase.bethe_hessian_dense(gj)
    ht, rt = baselines.bethe_hessian_dense(g)
    assert math.isclose(rt, rj, rel_tol=1e-6) and rt == info["r"]
    assert _maxabs(ht, hj) <= TOL
    assert info["negative_eigs"] == int(jnp.sum(jnp.linalg.eigvalsh(hj) < 0))
    _, r2 = baselines.bethe_hessian_dense(g, r=2.0)
    assert r2 == 2.0


def test_cg_solves_spd_system_like_jax():
    rng = np.random.default_rng(0)
    n = 40
    a = rng.normal(size=(n, n)).astype(np.float32)
    a = (a @ a.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x = baselines.cg_solve(lambda v: at @ v, bt, iters=80)
    np.testing.assert_allclose(_np(at @ x), b, rtol=1e-3, atol=1e-3)
    for iters in (5, 80):
        want = jbase.cg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                              iters=iters)
        got = baselines.cg_solve(lambda v: at @ v, bt, iters=iters)
        assert _maxabs(got, want) <= TOL


def test_shift_invert_operator_finds_bottom_eigvec_like_jax():
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    L = lap.laplacian_dense(g)
    k = 3
    _, v_star = metrics.ground_truth_bottom_k(L, k)
    op = baselines.shift_invert_operator(lambda v: L @ v, shift=0.05, cg_iters=40)
    cfg = SolverConfig(method="oja", lr=0.5, steps=200, eval_every=25, k=k)
    _, tr = run_solver(op, g.num_nodes, cfg, v_star=v_star, device=CPU)
    assert float(tr.subspace_error[-1]) < 1e-2
    # one application against the JAX operator on the same panel
    lj = jlap.laplacian_dense(jgraphs.ring_of_cliques(3, 6)[0])
    opj = jbase.shift_invert_operator(lambda v: lj @ v, shift=0.05, cg_iters=40)
    v = np.random.default_rng(1).normal(size=(18, k)).astype(np.float32)
    want = opj(jnp.asarray(v))
    assert _maxabs(op(torch.from_numpy(v)), want) <= TOL * float(jnp.abs(want).max())


def test_lanczos_matches_eigh_and_jax():
    g, _ = graphs.clique_graph(120, 3, seed=1, device=CPU)
    L = lap.laplacian_dense(g)
    lam_ref = np.linalg.eigvalsh(_np(L).astype(np.float64))[:4]
    lam, vecs = baselines.lanczos_bottom_k(lambda v: L @ v, g.num_nodes, 4,
                                           iters=110, device=CPU)
    np.testing.assert_allclose(_np(lam), lam_ref, rtol=1e-3, atol=1e-3)
    res = torch.linalg.vector_norm(L @ vecs - vecs * lam[None, :], dim=0)
    assert float(res.max()) < 1e-2
    # the same numpy start vector in the JAX package
    lj = jlap.laplacian_dense(jgraphs.clique_graph(120, 3, seed=1)[0])
    lam_j, _ = jbase.lanczos_bottom_k(lambda v: lj @ v, 120, 4, iters=110)
    np.testing.assert_allclose(_np(lam), np.asarray(lam_j), rtol=1e-3, atol=1e-3)
    assert lam.dtype == vecs.dtype == torch.float32


# ---------------------------------------------------------------------------
# link prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_prob,seed", [(0.2, 0), (0.5, 3), (0.0, 1)])
def test_complete_graph_matches_jax_bitwise(drop_prob, seed):
    gj, _ = jgraphs.clique_graph(60, 3, seed=seed)
    gt, _ = graphs.clique_graph(60, 3, seed=seed, device=CPU)
    cj = jlink.complete_graph(gj, drop_prob=drop_prob, seed=seed)
    ct = linkpred.complete_graph(gt, drop_prob=drop_prob, seed=seed)
    assert ct.num_nodes == cj.num_nodes and ct.device == gt.device
    for f in ("src", "dst", "weight"):
        got, want = _np(getattr(ct, f)), np.asarray(getattr(cj, f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_common_neighbors_scores_match_jax():
    rng = np.random.default_rng(2)
    adj = (rng.random((12, 12)) < 0.3).astype(np.float64)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    pairs = rng.integers(0, 12, size=(10, 2))
    np.testing.assert_array_equal(linkpred.common_neighbors_scores(adj, pairs),
                                  jlink.common_neighbors_scores(adj, pairs))
