"""k-means and the end-to-end clustering slice of the port, against the
JAX package and against planted labels.

The k-means++ draws differ between jax.random and torch.Generator, so
Lloyd's iterations are compared from the same initial centroids, and
whole pipelines are judged as tests/test_clustering.py judges them:
cluster agreement with the planted labels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusteringConfig as JClusteringConfig
from repro.core import build_series as jbuild_series
from repro import spectral as jspectral
from repro.core import graphs as jgraphs
from repro.core import kmeans as jkm
from repro.core import operators as joperators
from repro_torch.core import (ClusteringConfig, SolverConfig, build_series,
                              exact_cluster_reference, graphs, operators,
                              spectral_cluster)
from repro_torch import spectral
from repro_torch.core import kmeans as km

CPU = "cpu"


def _blobs(seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = np.asarray([[0.0, 0.0], [5.0, 5.0], [-5.0, 5.0]], np.float32)
    pts = np.concatenate([c + 0.3 * rng.normal(size=(40, 2)) for c in centers])
    return pts.astype(np.float32), np.repeat(np.arange(3), 40)


def test_lloyd_matches_jax_from_same_centroids():
    x = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    c0 = x[[0, 50, 100, 200, 250]]
    want = jkm._lloyd(jnp.asarray(x), jnp.asarray(c0), 25)
    got = km._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 25)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.centroids.numpy(), want.centroids, atol=1e-5)
    assert abs(float(got.inertia) - float(want.inertia)) <= 1e-4 * float(want.inertia)


def test_plusplus_init_draws_distinct_rows():
    x, _ = _blobs()
    tx = torch.from_numpy(x)
    c = km._plusplus_init(torch.Generator().manual_seed(0), tx, 3)
    rows = {tuple(r) for r in tx.numpy().tolist()}
    assert all(tuple(r) in rows for r in c.numpy().tolist())
    assert len({tuple(r) for r in c.numpy().tolist()}) == 3


def test_kmeans_separates_blobs():
    x, truth = _blobs()
    res = km.kmeans(torch.Generator().manual_seed(0), torch.from_numpy(x), 3)
    assert res.labels.shape == (120,)
    assert float(km.cluster_agreement(res.labels, truth, 3)) > 0.99


def test_cluster_agreement_matches_jax():
    rng = np.random.default_rng(2)
    labels, truth = rng.integers(0, 4, 500), rng.integers(0, 4, 500)
    assert abs(float(km.cluster_agreement(torch.from_numpy(labels), truth, 4))
               - float(jkm.cluster_agreement(jnp.asarray(labels),
                                             jnp.asarray(truth), 4))) <= 1e-6


@pytest.mark.parametrize("transform", ["identity", "limit_neg_exp",
                                       "taylor_neg_exp", "taylor_log",
                                       "cheb_neg_exp", "cheb_log"])
def test_build_series_matches_jax(transform):
    jcfg = JClusteringConfig(transform=transform, degree=9)
    cfg = ClusteringConfig(transform=transform, degree=9)
    sj, st = jbuild_series(jcfg, 37.0), build_series(cfg, 37.0)
    assert st.name == sj.name and st.degree == sj.degree
    assert abs(st.lambda_star - sj.lambda_star) <= 1e-6 * max(1.0, abs(sj.lambda_star))


@pytest.mark.parametrize("transform", ["limit_neg_exp", "cheb_log"])
def test_spectral_cluster_recovers_cliques(transform):
    """tests/test_clustering.py's clique check on the port's CPU path.  It
    runs 200 of that test's 600 steps: agreement is already 1.0 at step
    100 on this graph, and the plain CPU matvec is slow."""
    g, truth = graphs.clique_graph(160, 4, seed=3, device=CPU)
    cfg = ClusteringConfig(
        num_clusters=4, transform=transform,
        degree=64 if transform == "cheb_log" else 251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=200, eval_every=100),
        seed=0)
    labels, info = spectral_cluster(g, cfg)
    acc = float(km.cluster_agreement(labels, truth, 4))
    assert acc > 0.95, f"{transform}: accuracy {acc}"
    assert info["eigvecs"].shape == (160, 6)
    assert info["trace"].steps.tolist() == [100, 200]


def test_exact_reference_pipeline():
    g, truth = graphs.clique_graph(100, 4, seed=7, device=CPU)
    labels = exact_cluster_reference(g, 4)
    assert float(km.cluster_agreement(labels, truth, 4)) > 0.95


@pytest.mark.parametrize("entry", [
    lambda g: spectral_cluster(g, ClusteringConfig(num_clusters=3,
                                                   estimation="dense")),
    lambda g: operators.planned_operator(g, k=3, estimation="dense"),
], ids=["spectral_cluster", "planned_operator"])
def test_unknown_estimation_raises(entry):
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    with pytest.raises(ValueError, match="estimation mode 'dense'"):
        entry(g)


def test_auto_transform_recovers_cliques_with_the_jax_plan():
    """transform="auto": probe (seed + 3), plan with budget=degree, rescale
    lr, solve.  The probe draws differ from jax.random's, but the planner
    snaps onto a grid, so family, degree and tau must equal the plan the
    JAX pipeline makes on the same graph."""
    g, truth = graphs.clique_graph(160, 4, seed=3, device=CPU)
    cfg = ClusteringConfig(
        num_clusters=4, transform="auto", degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=200, eval_every=100),
        seed=0)
    labels, info = spectral_cluster(g, cfg)
    assert float(km.cluster_agreement(labels, truth, 4)) > 0.95
    gj, _ = jgraphs.clique_graph(160, 4, seed=3)
    _, want = jspectral.probe_and_plan(gj, k=6, key=jax.random.PRNGKey(3),
                                       budget=251)
    plan = info["plan"]
    assert (plan.family, plan.degree, plan.tau) == (
        want.family, want.degree, want.tau)
    assert info["series"] == spectral.series_from_plan(plan).name
    assert info["rho_ub"] >= plan.rho


def test_planned_operator_matches_jax_given_the_same_plan():
    """Both planners pick the same family, degree and tau on the ring of
    cliques; the port's planned operator then equals the JAX operator of
    the port's plan to 1e-5, the TOL of tests/test_backend.py."""
    gj, _ = jgraphs.ring_of_cliques(4, 8)
    g, _ = graphs.ring_of_cliques(4, 8, device=CPU)
    op, plan = operators.planned_operator(
        g, k=4, generator=torch.Generator().manual_seed(0), backend="segment")
    _, jplan = joperators.planned_operator(gj, k=4, key=jax.random.PRNGKey(0),
                                           backend="segment")
    assert (plan.family, plan.degree, plan.tau) == (
        jplan.family, jplan.degree, jplan.tau)
    same = type(jplan)(**dataclasses.asdict(plan))
    jop = joperators.edge_series_operator(
        gj, jspectral.series_from_plan(same), backend="segment")
    v = np.random.default_rng(5).normal(size=(g.num_nodes, 4)).astype(np.float32)
    got = op(torch.from_numpy(v)).numpy()
    assert float(np.max(np.abs(got - np.asarray(jop(jnp.asarray(v)))))) <= 1e-5


def test_scaled_series_for_graph_matches_jax():
    from repro.core import series as jseries
    from repro_torch.core import series as tseries
    gj, _ = jgraphs.ring_of_cliques(4, 8)
    g, _ = graphs.ring_of_cliques(4, 8, device=CPU)
    for name in ("limit_neg_exp", "taylor_neg_exp"):
        for rho in (None, 9.5):
            sj = joperators.scaled_series_for_graph(
                gj, getattr(jseries, name), 9, target_radius=4.0, rho=rho)
            st = operators.scaled_series_for_graph(
                g, getattr(tseries, name), 9, target_radius=4.0, rho=rho)
            assert (st.name, st.degree) == (sj.name, sj.degree)
