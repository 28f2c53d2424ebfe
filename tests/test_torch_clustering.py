"""k-means and the end-to-end clustering slice of the port, against the
JAX package and against planted labels.

The k-means++ draws differ between jax.random and torch.Generator, so
Lloyd's iterations are compared from the same initial centroids, and
whole pipelines are judged as tests/test_clustering.py judges them:
cluster agreement with the planted labels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusteringConfig as JClusteringConfig
from repro.core import build_series as jbuild_series
from repro.core import kmeans as jkm
from repro_torch.core import (ClusteringConfig, SolverConfig, build_series,
                              exact_cluster_reference, graphs,
                              spectral_cluster)
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


@pytest.mark.parametrize("change,slice_name", [
    (dict(transform="auto"), "slice 3"),
    (dict(estimation="minibatch"), "slice 4"),
    (dict(estimation="walks"), "slice 4"),
])
def test_later_slices_raise(change, slice_name):
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    cfg = dataclasses.replace(ClusteringConfig(num_clusters=3), **change)
    with pytest.raises(NotImplementedError, match=slice_name):
        spectral_cluster(g, cfg)
