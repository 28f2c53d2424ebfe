"""The random-walk estimator of the port (paper Sec. 4.3) against the JAX
package: the edge incidence graph, the walk estimators, the sampler and
the walks branch of spectral_cluster.

The incidence builder and the coefficient fit are numpy, so they must
come out bitwise equal.  The estimators are held to 1e-5 relative to
JAX's from an injected JAX ``WalkBatch`` and accept draw (importance
weights scale as E * deg^l, so an absolute bar would mean nothing).  The
sampler draws from a torch.Generator, so it is checked the way
tests/test_walks.py checks JAX's: in distribution and unbiased.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import walks as jwalks
from repro_torch import convert
from repro_torch.core import (ClusteringConfig, SolverConfig, graphs, metrics,
                              run_solver, spectral_cluster, walks)
from repro_torch.core import laplacian as lap
from repro_torch.core.kmeans import cluster_agreement

REL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for this module's many small-tensor ops: with the
    suite's parallel workers on a shared CPU, a pool of threads per op
    turned this module's seconds into minutes of contention.  Restored
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loops_and_duplicates():
    """A graph with self-loops, duplicate and reversed duplicate edges."""
    edges = np.array([[0, 1], [1, 0], [0, 1], [2, 2], [1, 2], [3, 3], [2, 3],
                      [3, 4], [4, 0], [4, 4], [1, 4]])
    w = np.linspace(0.5, 1.5, len(edges)).astype(np.float32)
    return (jlap.make_edge_list(edges, 6, weights=w),
            lap.make_edge_list(edges, 6, weights=w, device=CPU))


GRAPHS = {
    "ring_of_cliques": lambda: (jgraphs.ring_of_cliques(3, 4)[0],
                                graphs.ring_of_cliques(3, 4, device=CPU)[0]),
    "clique_graph": lambda: (jgraphs.clique_graph(96, 3)[0],
                             graphs.clique_graph(96, 3, device=CPU)[0]),
    "loops_and_duplicates": _loops_and_duplicates,
}


@pytest.fixture(scope="module")
def ring():
    """tests/test_walks.py's setup in both packages."""
    gj, g = GRAPHS["ring_of_cliques"]()
    incj, inc = jlap.build_edge_incidence(gj), lap.build_edge_incidence(g)
    return gj, incj, g, inc, lap.laplacian_dense(g).double().numpy()


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_edge_incidence_is_bitwise_jax(name):
    gj, g = GRAPHS[name]()
    want, got = jlap.build_edge_incidence(gj), lap.build_edge_incidence(g)
    for field in ("nbrs", "deg", "ip"):
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    assert got.deg_star_inc == want.deg_star_inc


def test_build_edge_incidence_refuses_an_edgeless_graph_as_jax_does():
    empty = np.zeros((0, 2), np.int64)
    with pytest.raises(ValueError):
        jlap.build_edge_incidence(jlap.make_edge_list(empty, 3))
    with pytest.raises(ValueError):
        lap.build_edge_incidence(lap.make_edge_list(empty, 3, device=CPU))


@pytest.mark.parametrize("case,pair,value", [
    ("repeated", ((0, 3), (0, 3)), 2.0),
    ("serial_src_dst", ((0, 3), (3, 5)), -1.0),
    ("serial_dst_src", ((2, 4), (0, 2)), -1.0),
    ("diverging", ((1, 3), (1, 6)), 1.0),
    ("converging", ((0, 5), (2, 5)), 1.0),
    ("disconnected", ((0, 1), (2, 3)), 0.0),
])
def test_edge_inner_product_table1(case, pair, value):
    (si, di), (sj, dj) = pair
    want = float(jlap.edge_inner_product(si, di, sj, dj))
    got = float(lap.edge_inner_product(si, di, sj, dj))
    assert got == want == value


@pytest.mark.parametrize("degree,rho,tau", [(1, 4.0, 1.0), (4, 12.0, 0.5),
                                            (6, 25.3, 8.0 / 25.3)])
def test_lowdeg_negexp_coeffs_is_bitwise_jax(degree, rho, tau):
    assert walks.lowdeg_negexp_coeffs(degree, rho, tau) == \
        jwalks.lowdeg_negexp_coeffs(degree, rho, tau)


def test_convert_carries_the_jax_incidence_across(ring):
    _, incj, _, inc, _ = ring
    got = convert.edge_incidence_from_numpy(*(np.asarray(x) for x in incj[:3]),
                                            incj.deg_star_inc, device=CPU)
    for a, b in zip(got, inc):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.fixture(scope="module")
def jax_batch(ring):
    """One JAX walk batch (2000 walkers, 3 edges) in both packages."""
    wb = jwalks.sample_walks(jax.random.PRNGKey(5), ring[1], 2000, 3)
    return wb, convert.walk_batch_from_numpy(*(np.asarray(x) for x in wb),
                                             device=CPU)


@pytest.mark.parametrize("mode", ["importance", "rejection"])
@pytest.mark.parametrize("power", [1, 2, 3])
def test_estimate_power_matvec_matches_jax_from_its_batch(ring, jax_batch,
                                                          mode, power):
    gj, incj, g, inc, _ = ring
    wbj, wb = jax_batch
    v = np.random.default_rng(power).normal(size=(g.num_nodes, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jwalks.estimate_power_matvec(wbj, gj, incj, power, jnp.asarray(v),
                                        mode=mode, key=key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (2000,))))
    got = walks.estimate_power_matvec(wb, g, inc, power, torch.from_numpy(v),
                                      mode=mode, uniform=u)
    assert _rel(got.numpy(), want) <= REL


def test_rejection_needs_a_coin(ring):
    _, _, g, inc, _ = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(0), inc, 10, 2)
    with pytest.raises(ValueError, match="accept coin"):
        walks.estimate_power_matvec(wb, g, inc, 1, torch.ones((g.num_nodes, 1)),
                                    mode="rejection")


def test_walk_polynomial_operator_matches_jax_from_its_batch(ring):
    """op(key, v) draws its walks from split(key)[0]; the port's op replays
    that batch (importance mode needs no other draw)."""
    gj, incj, g, inc, l_mat = ring
    rho = float(2 * l_mat.diagonal().max())
    coeffs = jwalks.lowdeg_negexp_coeffs(4, rho, tau=6.0 / rho)
    key = jax.random.PRNGKey(3)
    v = np.random.default_rng(9).normal(size=(g.num_nodes, 3)).astype(np.float32)
    want = jwalks.walk_polynomial_operator(gj, incj, coeffs, 0.5, 3000)(
        key, jnp.asarray(v))
    wbj = jwalks.sample_walks(jax.random.split(key)[0], incj, 3000, 4)
    wb = convert.walk_batch_from_numpy(*(np.asarray(x) for x in wbj), device=CPU)
    op = walks.walk_polynomial_operator(g, inc, coeffs, 0.5, 3000)
    assert _rel(op(None, torch.from_numpy(v), walks=wb).numpy(), want) <= REL


@pytest.mark.parametrize("power", [1, 2, 3])
def test_importance_estimator_unbiased(ring, power):
    _, _, g, inc, l_mat = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(0), inc, 120_000, 3)
    est = walks.estimate_power_dense(wb, g, inc, power, g.num_nodes).double().numpy()
    want = np.linalg.matrix_power(l_mat, power)
    assert np.linalg.norm(est - want) / np.linalg.norm(want) < 0.05


@pytest.mark.parametrize("power", [1, 2])
def test_rejection_estimator_unbiased(ring, power):
    _, _, g, inc, l_mat = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(1), inc, 200_000, 3)
    est = walks.estimate_power_dense(
        wb, g, inc, power, g.num_nodes, mode="rejection",
        generator=torch.Generator().manual_seed(2)).double().numpy()
    want = np.linalg.matrix_power(l_mat, power)
    assert np.linalg.norm(est - want) / np.linalg.norm(want) < 0.35


def test_importance_lower_variance_than_rejection(ring):
    _, _, g, inc, l_mat = ring
    want = l_mat @ l_mat
    errs = {}
    for mode in ("importance", "rejection"):
        sq = 0.0
        for t in range(6):
            wb = walks.sample_walks(torch.Generator().manual_seed(10 + t), inc,
                                    20_000, 2)
            est = walks.estimate_power_dense(
                wb, g, inc, 2, g.num_nodes, mode=mode,
                generator=torch.Generator().manual_seed(100 + t))
            sq += float(np.sum((est.double().numpy() - want) ** 2))
        errs[mode] = sq
    assert errs["importance"] < errs["rejection"]


def test_walk_probabilities_are_proper(ring):
    _, _, g, inc, _ = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(3), inc, 1000, 3)
    # log p decreasing along the walk, bounded by p_min (Eq. 14)
    assert bool(torch.all(wb.logp[:, 1] <= wb.logp[:, 0] + 1e-6))
    log_pmin = -2 * np.log(inc.deg_star_inc) - np.log(g.num_edges)
    assert bool(torch.all(wb.logp[:, 1] >= log_pmin - 1e-5))


def test_alpha_values_follow_table1(ring):
    _, _, _, inc, _ = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(4), inc, 5000, 3)
    assert bool(torch.all(wb.alpha != 0.0))
    assert set(wb.alpha[:, 1].unique().tolist()) <= {-1.0, 1.0, 2.0}


def test_steps_are_uniform_over_incident_edges_and_skip_the_padding(ring):
    """Each step lands on one of the deg[cur] listed neighbours, each about
    equally often: never on the self-padding past them."""
    _, _, _, inc, _ = ring
    wb = walks.sample_walks(torch.Generator().manual_seed(8), inc, 200_000, 2)
    first, nxt = wb.edge_at[:, 0].long(), wb.edge_at[:, 1].long()
    e, width = inc.nbrs.shape
    assert int(inc.deg.min()) < width  # some rows are padded
    counts = torch.zeros((e, e), dtype=torch.float64)
    counts.index_put_((first, nxt), torch.ones_like(first, dtype=torch.float64),
                      accumulate=True)
    for u in range(e):
        d = int(inc.deg[u])
        listed = inc.nbrs[u, :d].long()
        assert float(counts[u].sum()) == float(counts[u, listed].sum())
        share = counts[u, listed] / counts[u].sum()
        assert float((share * d - 1.0).abs().max()) < 0.2


def test_walk_operator_converges_in_solver(ring):
    """tests/test_walks.py's solve: the walk-estimated degree-4 operator
    drives mu-EG to the bottom eigenvectors."""
    _, _, g, inc, l_mat = ring
    rho = float(2 * l_mat.diagonal().max())
    coeffs = walks.lowdeg_negexp_coeffs(4, rho, tau=6.0 / rho)
    op = walks.walk_polynomial_operator(g, inc, coeffs, 0.0, num_walkers=4096)
    k = 3
    _, v_star = metrics.ground_truth_bottom_k(torch.from_numpy(l_mat).float(), k)
    cfg = SolverConfig(method="mu_eg", lr=0.05, steps=600, eval_every=50, k=k,
                       seed=0)
    _, tr = run_solver(op, g.num_nodes, cfg, v_star=v_star, stochastic=True,
                       device=CPU)
    assert float(tr.subspace_error[-1]) < 0.05


def test_walks_with_auto_transform_skips_probe(monkeypatch):
    from repro_torch import spectral

    def no_probe(*args, **kwargs):
        raise AssertionError("the walks estimator must not probe")

    monkeypatch.setattr(spectral, "probe_and_plan", no_probe)
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    labels, info = spectral_cluster(g, ClusteringConfig(
        num_clusters=3, transform="auto", estimation="walks", degree=6,
        num_walkers=512,
        solver=SolverConfig(steps=40, eval_every=20, lr=0.1)))
    assert info["plan"] is None
    assert info["series"] == "identity"
    assert labels.shape == (g.num_nodes,)


def test_spectral_cluster_walks_recovers_cliques():
    """The configuration of chip_smoke.py's walks_small phase (degree
    min(251, 6), 4096 walkers, lr 0.05, 600 steps) at the agreement bar
    of the stochastic clustering test, > 0.9."""
    g, truth = graphs.clique_graph(160, 4, seed=3, device=CPU)
    labels, info = spectral_cluster(g, ClusteringConfig(
        num_clusters=4, estimation="walks", degree=251, num_walkers=4096,
        solver=SolverConfig(method="mu_eg", lr=0.05, steps=600, eval_every=100),
        seed=0))
    assert info["plan"] is None
    assert float(cluster_agreement(labels, truth, 4)) > 0.9
