"""The minibatch estimator of the port (paper Sec. 3) against the JAX
package: the minibatch matvec, the stochastic series, the minibatch
operator, the stochastic solve loop, EdgePipeline and the minibatch
branches of planned_operator and spectral_cluster.

jax.random and torch.Generator draw different edges, so the port's
operators replay the JAX draw: the (F, B) index tensor ``sel`` whose row
i is ``randint(fold_in(key, i), (B,), 0, E)``, the batch JAX's
``minibatch_operator`` draws for series position i.  Tolerance 1e-5
max-abs (the TOL of tests/test_backend.py) for one operator call, 1e-4
for three solver steps; whole solves are judged as the JAX tests judge
them (subspace error, cluster agreement).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolverConfig as JSolverConfig
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import operators as jops
from repro.core import series as jseries
from repro.core import solvers as jsolvers
from repro.data.pipeline import EdgePipeline as JEdgePipeline
from repro_torch import convert, spectral
from repro_torch.core import (ClusteringConfig, SolverConfig, graphs, metrics,
                              operators, series, solvers, spectral_cluster)
from repro_torch.core import laplacian as lap
from repro_torch.core.kmeans import cluster_agreement
from repro_torch.data import EdgePipeline

TOL = 1e-5
STEPS_TOL = 1e-4
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


def _edges(seed: int, n: int, e: int):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges, rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)


def _graph_pair(seed: int = 0, n: int = 96, e: int = 300, capacity=None):
    """The ``weighted`` case of tests/test_backend.py in both packages."""
    edges, w = _edges(seed, n, e)
    gj = jlap.make_edge_list(edges, n, weights=w)
    gt = lap.make_edge_list(edges, n, weights=w, device=CPU)
    if capacity:
        gj, gt = jlap.pad_edge_list(gj, capacity), lap.pad_edge_list(gt, capacity)
    return gj, gt


CASES = {"weighted": (0, 96, 300, None), "capacity_padded": (1, 96, 300, 512),
         "non_aligned": (2, 301, 517, None)}


def _panel(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _jax_sel(key, rows: int, batch: int, e: int) -> torch.Tensor:
    """JAX's per-factor draws, stacked as the port's (F, B) ``sel``."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(jax.random.fold_in(key, i), (batch,), 0, e))
        for i in range(rows)]))


@pytest.mark.parametrize("shape", ["n", "n1", "nk"])
def test_minibatch_matvec_matches_jax(shape):
    gj, gt = _graph_pair()
    rng = np.random.default_rng(15)
    sel = rng.integers(0, gt.num_edges, 32)
    v = {"n": _panel(16, 96), "n1": _panel(16, 96, 1), "nk": _panel(16, 96, 4)}[shape]
    want = jlap.minibatch_laplacian_matvec(
        gj.src[sel], gj.dst[sel], gj.weight[sel], jnp.asarray(v), gj.num_edges)
    ts = torch.from_numpy(sel)
    got = lap.minibatch_laplacian_matvec(
        gt.src[ts], gt.dst[ts], gt.weight[ts], torch.from_numpy(v), gt.num_edges)
    assert got.shape == v.shape
    assert _maxabs(got.numpy(), want) <= TOL


def test_minibatch_matvec_weights_1d_and_column_alike():
    _, g = _graph_pair()
    sel = torch.from_numpy(np.random.default_rng(15).integers(0, g.num_edges, 32))
    v = torch.from_numpy(_panel(17, 96))
    out1 = lap.minibatch_laplacian_matvec(g.src[sel], g.dst[sel], g.weight[sel],
                                          v, g.num_edges)
    out2 = lap.minibatch_laplacian_matvec(g.src[sel], g.dst[sel], g.weight[sel],
                                          v[:, None], g.num_edges)
    assert out1.shape == (96,) and out2.shape == (96, 1)
    assert _maxabs(out1.numpy(), out2[:, 0].numpy()) <= 1e-6
    # the full edge set: E_total / B == 1, so exactly L @ v
    full = lap.minibatch_laplacian_matvec(g.src, g.dst, g.weight, v, g.num_edges)
    assert _maxabs(full.numpy(), lap.laplacian_matvec(g, v).numpy()) <= TOL


SERIES = {
    "limit_neg_exp": (jseries.limit_neg_exp(5, scale=0.4),
                      series.limit_neg_exp(5, scale=0.4)),
    "taylor_neg_exp": (jseries.taylor_neg_exp(3), series.taylor_neg_exp(3)),
    "cheb_neg_exp": (jseries.cheb_neg_exp(4, rho=8.0, tau=0.5),
                     series.cheb_neg_exp(4, rho=8.0, tau=0.5)),
}


@pytest.mark.parametrize("name", sorted(SERIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_minibatch_operator_matches_jax_from_its_draws(case, name):
    """The segment operator from JAX's draws equals JAX's
    ``minibatch_operator(g, s, 64)(key, v)``: limit_neg_exp to 1e-5
    max-abs.  The Taylor series read positions 1..degree, Chebyshev
    0..degree, so sel carries degree + 1 rows; their outputs grow to ~10
    (the E / B scale amplifies each factor), so they are held to 1e-5 of
    their largest magnitude."""
    gj, gt = _graph_pair(*CASES[case][:3], capacity=CASES[case][3])
    sj, st = SERIES[name]
    v = _panel(11, gt.num_nodes, 4)
    key = jax.random.PRNGKey(42)
    want = jops.minibatch_operator(gj, sj, 64, backend="segment")(key, jnp.asarray(v))
    sel = _jax_sel(key, st.degree + 1, 64, gt.num_edges)
    op = operators.minibatch_operator(gt, st, 64, backend="segment")
    got = op(None, torch.from_numpy(v), sel=sel)
    scale = 1.0 if name == "limit_neg_exp" else float(np.abs(want).max())
    assert _maxabs(got.numpy(), want) <= TOL * scale


def test_stochastic_series_gives_every_position_its_own_key():
    """Counterpart of tests/test_series.py::
    test_stochastic_apply_uses_independent_keys: every matvec of the
    series is keyed with its own position, once each."""
    seen = []

    def keyed_mv(generator, i, u):
        seen.append((generator, i))
        return u

    gen = torch.Generator().manual_seed(0)
    series.limit_neg_exp(5).apply_stochastic(keyed_mv, gen, torch.ones((4, 2)))
    assert seen == [(gen, i) for i in range(5)]


def test_minibatch_operator_draws_a_batch_per_factor():
    """A call draws one (degree + 1, B) index tensor from the generator,
    and factor i runs on row i of it."""
    _, g = _graph_pair()
    s = series.limit_neg_exp(5, scale=0.4)
    v = torch.from_numpy(_panel(12, 96, 3))
    op = operators.minibatch_operator(g, s, 16, backend="segment")
    got = op(torch.Generator().manual_seed(7), v)
    sel = torch.randint(0, g.num_edges, (6, 16),
                        generator=torch.Generator().manual_seed(7))
    assert len({tuple(r) for r in sel.tolist()}) == 6  # rows differ
    assert torch.equal(got, op(None, v, sel=sel))
    u, c = v, 0.4 / 5
    for i in range(5):
        u = u - c * lap.minibatch_laplacian_matvec(
            g.src[sel[i]], g.dst[sel[i]], g.weight[sel[i]], u, g.num_edges)
    assert _maxabs(got.numpy(), u.numpy()) <= TOL  # lambda* = 0, -(-u)


def test_minibatch_operator_kernel_backend_refuses_cpu():
    _, g = _graph_pair()
    with pytest.raises(ValueError, match="CUDA"):
        operators.minibatch_operator(g, series.limit_neg_exp(5), 16,
                                     backend="kernel")


@pytest.mark.parametrize("method", ["mu_eg", "oja"])
def test_stochastic_solver_steps_match_jax(method):
    """The slice as a whole: 3 stochastic solver steps of run_solver from
    the same init_v, the port's operator replaying the per-step draws of
    JAX's run_program (keys split from PRNGKey(seed) after the init key)."""
    gj, gt = _graph_pair()
    sj, st = SERIES["limit_neg_exp"]
    init = _panel(6, 96, 4)
    cfg_j = JSolverConfig(method=method, lr=0.3, steps=3, eval_every=3, k=4,
                          seed=5, backend="segment")
    cfg_t = convert.solver_config_from_dict(dataclasses.asdict(cfg_j))
    state_j, trace_j = jsolvers.run_solver(
        jops.minibatch_operator(gj, sj, 64, backend="segment"), 96, cfg_j,
        stochastic=True, init_v=jnp.asarray(init))
    key, _ = jax.random.split(jax.random.PRNGKey(cfg_j.seed))
    sels = iter([_jax_sel(k, st.degree, 64, gt.num_edges)
                 for k in jax.random.split(key, 3)])
    op = operators.minibatch_operator(gt, st, 64, backend="segment")
    state_t, trace_t = solvers.run_solver(
        lambda gen, v: op(gen, v, sel=next(sels)), 96, cfg_t,
        stochastic=True, init_v=torch.from_numpy(init))
    assert next(sels, None) is None
    assert _maxabs(state_t.v.numpy(), state_j.v) <= STEPS_TOL
    np.testing.assert_array_equal(trace_t.steps.numpy(), trace_j.steps)


def test_stochastic_solve_draws_after_the_init_panel():
    """run_program's one generator: the initial panel, then the
    operator's draws, from the same stream."""
    seen = []

    def op(gen, v):
        seen.append(torch.randint(0, 1 << 30, (2,), generator=gen))
        return v

    cfg = SolverConfig(k=2, steps=2, eval_every=1, seed=3, backend="segment")
    state, _ = solvers.run_solver(op, 5, cfg, stochastic=True, device=CPU)
    gen = torch.Generator().manual_seed(3)
    solvers.init_state(gen, 5, 2)
    assert int(state.step) == 2
    assert torch.equal(seen[0], torch.randint(0, 1 << 30, (2,), generator=gen))
    assert not torch.equal(seen[0], seen[1])


def test_stochastic_minibatch_operator_converges():
    """tests/test_solvers.py's case: minibatches of edges only."""
    g, _ = graphs.clique_graph(120, 3, seed=2, device=CPU)
    k = 3
    _, v_star = metrics.ground_truth_bottom_k(lap.laplacian_dense(g), k)
    rho_ub = float(lap.spectral_radius_upper_bound(g))
    op = operators.minibatch_operator(
        g, series.limit_neg_exp(51, scale=6.0 / rho_ub), batch_edges=512)
    cfg = SolverConfig(method="mu_eg", lr=0.1, steps=1200, eval_every=100, k=k)
    _, tr = solvers.run_solver(op, g.num_nodes, cfg, v_star=v_star,
                               stochastic=True, device=CPU)
    assert float(tr.subspace_error[-1]) < 0.05


def test_spectral_cluster_minibatch_stochastic():
    """tests/test_clustering.py's configuration and bar."""
    g, truth = graphs.clique_graph(120, 3, seed=4, device=CPU)
    cfg = ClusteringConfig(
        num_clusters=3, transform="limit_neg_exp", degree=51,
        estimation="minibatch", batch_edges=512,
        solver=SolverConfig(method="mu_eg", lr=0.1, steps=1500, eval_every=250),
        seed=0)
    labels, info = spectral_cluster(g, cfg)
    assert info["plan"] is None
    assert float(cluster_agreement(labels, truth, 3)) > 0.9


def test_planned_minibatch_operator_matches_jax_given_the_same_plan():
    """planned_operator(estimation="minibatch"): the probe and plan run on
    the exact edges, and the planned series goes into the minibatch
    operator, which replays JAX's draws."""
    from repro import spectral as jspectral
    gj, _ = jgraphs.ring_of_cliques(4, 8)
    g, _ = graphs.ring_of_cliques(4, 8, device=CPU)
    op, plan = operators.planned_operator(
        g, k=4, generator=torch.Generator().manual_seed(0),
        estimation="minibatch", batch_edges=32, backend="segment")
    _, jplan = jops.planned_operator(gj, k=4, key=jax.random.PRNGKey(0),
                                     backend="segment")
    assert (plan.family, plan.degree, plan.tau) == (
        jplan.family, jplan.degree, jplan.tau)
    same = type(jplan)(**dataclasses.asdict(plan))
    js = jspectral.series_from_plan(same)
    v = _panel(5, g.num_nodes, 4)
    key = jax.random.PRNGKey(9)
    want = jops.minibatch_operator(gj, js, 32, backend="segment")(key, jnp.asarray(v))
    sel = _jax_sel(key, plan.degree + 1, 32, g.num_edges)
    assert _maxabs(op(None, torch.from_numpy(v), sel=sel).numpy(), want) <= TOL


def test_auto_transform_minibatch_renormalizes_lr():
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    cfg = ClusteringConfig(num_clusters=3, transform="auto", degree=51,
                           estimation="minibatch", batch_edges=32,
                           solver=SolverConfig(lr=0.1, steps=4, eval_every=2))
    labels, info = spectral_cluster(g, cfg)
    plan = info["plan"]
    assert plan is not None and info["series"] == spectral.series_from_plan(plan).name
    assert labels.shape == (g.num_nodes,)
    assert bool(torch.isfinite(info["eigvecs"]).all())


def test_hutchinson_trace_over_the_minibatch_operator():
    """hutchinson_trace(keyed=True) over the real minibatch operator (the
    identity series with lambda* = 0 gives -L_b): each probe sees its own
    batch, so the estimate is -tr L (tests/test_spectral.py's case)."""
    g, _ = graphs.sbm_graph(80, 4, p_in=0.4, p_out=0.05, seed=1, device=CPU)
    tr = float(2.0 * g.weight.sum())
    op = operators.minibatch_operator(g, series.identity_series(), 128)
    est = spectral.hutchinson_trace(op, g.num_nodes,
                                    torch.Generator().manual_seed(1),
                                    num_probes=256, keyed=True)
    np.testing.assert_allclose(-float(est), tr, rtol=0.1)


def test_edge_pipeline_is_a_pure_function_of_seed_and_step():
    g, _ = graphs.ring_of_cliques(3, 5, device=CPU)
    pipe = EdgePipeline(graph=g, batch_edges=64, seed=0)
    b1, b2 = pipe.batch_at(3), pipe.batch_at(3)
    assert set(b1) == {"src", "dst", "weight", "num_edges_total"}
    assert all(torch.equal(b1[k], b2[k]) for k in ("src", "dst", "weight"))
    assert not torch.equal(b1["src"], pipe.batch_at(4)["src"])
    assert not torch.equal(b1["src"], EdgePipeline(g, 64, seed=1).batch_at(3)["src"])
    assert b1["num_edges_total"] == g.num_edges and b1["src"].shape == (64,)


def test_edge_pipeline_matches_jax_from_its_draw():
    gj, _ = jgraphs.ring_of_cliques(3, 5)
    g, _ = graphs.ring_of_cliques(3, 5, device=CPU)
    want = JEdgePipeline(graph=gj, batch_edges=64, seed=2).batch_at(7)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 7)
    sel = torch.from_numpy(np.array(jax.random.randint(key, (64,), 0, gj.num_edges)))
    got = EdgePipeline(graph=g, batch_edges=64, seed=2).batch_at(7, sel=sel)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert got["num_edges_total"] == want["num_edges_total"]


def test_edge_pipeline_unbiased_mean():
    """tests/test_train_substrate.py's bar: the mean of 200 minibatch
    Laplacians is within 10 % of L v."""
    g, _ = graphs.ring_of_cliques(3, 5, device=CPU)
    pipe = EdgePipeline(graph=g, batch_edges=64, seed=0)
    v = torch.from_numpy(_panel(0, g.num_nodes, 2))
    acc = torch.zeros_like(v)
    for t in range(200):
        b = pipe.batch_at(t)
        acc += lap.minibatch_laplacian_matvec(b["src"], b["dst"], b["weight"], v,
                                              b["num_edges_total"])
    want = lap.laplacian_dense(g) @ v
    assert float(torch.linalg.norm(acc / 200 - want) / torch.linalg.norm(want)) < 0.1
