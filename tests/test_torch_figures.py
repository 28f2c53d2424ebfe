"""The paper's figures on the port, against the JAX package (CPU).

- ``three_room_mdp`` (Fig. 1's grid world): structure, as
  tests/test_laplacian.py checks it (its edges are held bitwise to
  ``repro``'s in tests/test_torch_laplacian.py), and chip_smoke.py
  mdp_full's probe and plan against ``repro``'s from the same probe
  vectors.
- The legacy uniform-layout helpers equal ``repro``'s, and the skew
  properties of tests/test_skew_blocking.py hold on the port's
  ``build_node_blocking``.
- chip_smoke.py's copy of benchmarks/common.py's convergence protocol,
  100 steps from the JAX-drawn seed-0 panel (the panel
  ``convergence_run`` draws), against ``repro``'s ``run_solver`` from
  that panel: trace steps, streaks and the protocol's summary equal,
  subspace errors and panels within ``TRACE_TOL``.
- Table 2's convergence ratios and dilation factors from the port's
  scalar maps against ``repro``'s, to 1e-5 relative.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from repro import spectral as jspectral
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import metrics as jmetrics
from repro.core import operators as jops
from repro.core import series as jseries
from repro.core import solvers as jsolvers
from repro.kernels.edge_spmm import ops as jes_ops
from repro.spectral import plan as jplan
from repro_torch.core import graphs, series
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.spectral import plan as plan_mod
from repro_torch.spectral import probes

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
# 100 mu-EG / Oja steps of a degree-151 series from one panel: the two
# packages' fp32 matmuls round in another order and the solve carries it
# forward; the largest drift of the eight cases is 3.8e-6, inside the
# 1e-5 TOL of tests/test_backend.py
TRACE_TOL = 1e-5
RATIO_RTOL = 1e-5
STEPS = 100
SEEDS = list(range(1, 21))


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
bench_common = _load("bench_common", ROOT / "benchmarks" / "common.py")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for the protocol's thousands of small matmuls: with
    the suite's parallel workers on a shared CPU, a pool of threads per op
    turned this module's seconds into minutes.  Restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_three_room_mdp_structure():
    g, labels = graphs.three_room_mdp(s=1, h=10, device=CPU)
    h, w = 11, 31
    assert g.num_nodes == h * w
    assert set(np.unique(labels)) == {0, 1, 2}
    assert labels.dtype == np.int32
    # connected: the nullspace of L is one-dimensional
    lam = np.linalg.eigvalsh(lap.laplacian_dense(g).numpy())
    assert lam[0] < 1e-5 and lam[1] > 1e-6


def test_three_room_mdp_rows_hold_at_most_four_entries():
    """The grid's row CSR (the layout K2 reads at s = 59) has no hub row."""
    g, _ = graphs.three_room_mdp(s=3, h=7, device=CPU)
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    counts = rows.row_ptr[1:] - rows.row_ptr[:-1]
    assert int(counts.max()) == 4 and int(counts.min()) == 2
    assert int((rows.hub_rows < g.num_nodes).sum()) == 0


def _exact_bottom(g, k: int) -> np.ndarray:
    """The k smallest Laplacian eigenvalues (float64 shift-invert)."""
    n = g.num_nodes
    src, dst, w = g.src.numpy(), g.dst.numpy(), g.weight.numpy()
    a = sp.coo_matrix((np.r_[w, w], (np.r_[src, dst], np.r_[dst, src])),
                      shape=(n, n)).tocsr().astype(np.float64)
    lmat = sp.diags(np.asarray(a.sum(axis=1)).ravel()) - a
    return np.sort(spla.eigsh(lmat, k=k, sigma=-1e-4, which="LM",
                              return_eigenvectors=False))


@pytest.mark.parametrize("s", [1, 5])
def test_mdp_probe_plan_matches_jax(s):
    """mdp_full's probe and plan (k = 5, budget 251) on the grid, in both
    packages from the same probe vectors: the same plan.  From s = 5 on,
    the 24-step probe no longer resolves the grid's bottom edge in either
    package (lam_k = lam_k+1, gap 0); the plan from the exact eigenvalues
    is that same plan, because tau snaps to the top of its grid either
    way."""
    k, budget = 5, 251
    gj, _ = jgraphs.three_room_mdp(s, 10)
    gt, _ = graphs.three_room_mdp(s, 10, device=CPU)
    n = gj.num_nodes
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 4)  # the panel jax's slq_probe draws
    v0 = np.stack([np.asarray(jax.random.normal(kk, (n,), jnp.float32))
                   for kk in keys], axis=1)
    rho_ub = float(jlap.spectral_radius_upper_bound(gj))
    want = jplan.plan_dilation(jspectral.probe_graph(gj, key=key), k=k,
                               budget=budget, rho_fallback=rho_ub)
    probe = probes.slq_probe(lambda v: lap.laplacian_matvec(gt, v), n,
                             n_real=n, v0=torch.from_numpy(v0))
    got = plan_mod.plan_dilation(probe, k=k, budget=budget,
                                 rho_fallback=rho_ub)
    assert (got.family, got.degree, got.tau, got.rho) == \
        (want.family, want.degree, want.tau, want.rho)
    for f in ("lam_k", "lam_k1"):  # Ritz nodes, as tests/test_torch_spectral
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-4 * want.rho
    assert (got.gamma == 0.0) == (want.gamma == 0.0) == (s >= 5)
    lam = _exact_bottom(gt, k + 1)
    exact = plan_mod.plan_dilation(probe, k=k, budget=budget,
                                   rho_fallback=rho_ub,
                                   lam_k=float(lam[k - 1]),
                                   lam_k1=float(lam[k]))
    assert (exact.family, exact.degree, exact.tau) == \
        (got.family, got.degree, got.tau)


# ---- the uniform-layout helpers and the skew properties --------------------

def _skewed_case(seed: int):
    """tests/test_skew_blocking.py's case: a power-law graph, distinct
    weights, some zero (capacity-padding) slots, a random block size."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 400))
    g = graphs.power_law_graph(n, avg_degree=float(rng.uniform(2.0, 12.0)),
                               alpha=2.5, seed=seed, device=CPU)
    src, dst = g.src.numpy(), g.dst.numpy()
    w = (np.arange(1, len(src) + 1, dtype=np.float32)
         * rng.uniform(0.5, 1.5)).astype(np.float32)
    w[rng.uniform(size=len(src)) < 0.15] = 0.0
    block_n = int(rng.choice([8, 16, 32, 64]))
    return src, dst, w, n, block_n


def _half_edge_counts(src, dst, w, block_n: int, nb: int):
    live = w != 0.0
    u = np.concatenate([src[live], dst[live]])
    return np.bincount(u // block_n, minlength=nb)


def _power_law_counts():
    g = graphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0,
                               device=CPU)
    src, dst, w = g.src.numpy(), g.dst.numpy(), g.weight.numpy()
    return _half_edge_counts(src, dst, w, 256, 4096 // 256)


UNIFORM_CASES = ["power_law_4096"] + [f"skewed_{s}" for s in SEEDS]


@pytest.mark.parametrize("case", UNIFORM_CASES)
def test_uniform_helpers_match_jax(case):
    if case == "power_law_4096":
        counts = _power_law_counts()
    else:
        src, dst, w, n, block_n = _skewed_case(int(case.split("_")[1]))
        counts = _half_edge_counts(src, dst, w, block_n,
                                   -(-n // block_n))
    for block_e in (16, 128):
        for snap in (True, False):
            assert es_ops.uniform_chunks_for_counts(counts, block_e, snap) \
                == jes_ops.uniform_chunks_for_counts(counts, block_e, snap)
            assert es_ops.uniform_padded_half_edges(counts, block_e, snap) \
                == jes_ops.uniform_padded_half_edges(counts, block_e, snap)


@pytest.mark.parametrize("seed", SEEDS)
def test_padded_work_le_uniform(seed):
    """tests/test_skew_blocking.py:132 on the port's layout: the raw CSR
    chunk count (before the pow2 snap) never walks more padded slots than
    the raw uniform layout, the snap costs < 2x on top, and the layout is
    bitwise ``repro``'s."""
    src, dst, w, n, block_n = _skewed_case(seed)
    nb = es_ops.build_node_blocking(src, dst, w, n, block_n=block_n,
                                    device=CPU)
    counts = _half_edge_counts(src, dst, w, block_n,
                               nb.padded_nodes // block_n)
    raw_padded = int(es_ops._chunk_counts(counts, nb.block_e).sum()) \
        * nb.block_e
    assert raw_padded <= es_ops.uniform_padded_half_edges(
        counts, nb.block_e, snap_chunks=False)
    assert raw_padded <= nb.padded_half_edges < 2 * raw_padded
    nb_j = jes_ops.build_node_blocking(src, dst, w, n, block_n=block_n)
    assert nb.num_chunks == nb_j.num_chunks
    for f in ("u_local", "other", "weight", "chunk_block", "deg"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(),
                                      np.asarray(getattr(nb_j, f)), err_msg=f)


def test_skew_reduction_on_power_law():
    """tests/test_skew_blocking.py:252 on the port's layout: >= 2x fewer
    padded slots than the uniform layout on the alpha = 2.5 graph."""
    g = graphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0,
                               device=CPU)
    nb = es_ops.build_node_blocking(g.src, g.dst, g.weight, g.num_nodes,
                                    block_n=256, device=CPU)
    counts = _power_law_counts()
    uniform = es_ops.uniform_padded_half_edges(counts, nb.block_e)
    assert uniform / nb.padded_half_edges >= 2.0, (uniform,
                                                   nb.padded_half_edges)


# ---- chip_smoke.py's convergence protocol ---------------------------------

def _jax_seed0_panel(n: int, k: int) -> np.ndarray:
    """run_program's seed-0 initial panel (its first split of PRNGKey(0))."""
    _, init_key = jax.random.split(jax.random.PRNGKey(0))
    return np.asarray(jsolvers.init_state(init_key, n, k).v)


GRAPHS = {
    "mdp_s1": lambda: (jgraphs.three_room_mdp(1, 10)[0],
                       graphs.three_room_mdp(1, 10, device=CPU)[0], 6),
    "clique_300_3": lambda: (jgraphs.clique_graph(300, 3, seed=0)[0],
                             graphs.clique_graph(300, 3, seed=0,
                                                 device=CPU)[0], 3),
}
TRANSFORMS = {
    "limit_neg_exp": lambda rho: (jseries.limit_neg_exp(151),
                                  series.limit_neg_exp(151), 0.4),
    "identity": lambda rho: (
        jseries.with_lambda_star(jseries.identity_series(), rho * 1.01),
        series.with_lambda_star(series.identity_series(), rho * 1.01), 2e-2),
}


@pytest.mark.parametrize("method", ["mu_eg", "oja"])
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_convergence_run_matches_jax(graph, transform, method):
    gj, gt, k = GRAPHS[graph]()
    rho = float(jlap.spectral_radius_upper_bound(gj))
    tf_j, tf_t, lr = TRANSFORMS[transform](rho)
    l_j = jlap.laplacian_dense(gj)
    _, vs = jmetrics.ground_truth_bottom_k(l_j, k)
    init = _jax_seed0_panel(gj.num_nodes, k)
    cfg = jsolvers.SolverConfig(method=method, lr=lr, steps=STEPS,
                                eval_every=smoke.FIG_EVAL_EVERY, k=k, seed=0)
    state_j, trace_j = jsolvers.run_solver(
        jops.series_operator(tf_j, jops.dense_matvec(l_j)), gj.num_nodes, cfg,
        v_star=vs, init_v=jnp.asarray(init))
    got = smoke.convergence_run(gt, tf_t, method, lr, STEPS, k,
                                v_star=torch.tensor(np.asarray(vs)),
                                init_v=torch.from_numpy(init), device=CPU)
    trace_t = got["trace"]
    np.testing.assert_array_equal(trace_t.steps.numpy(), trace_j.steps)
    np.testing.assert_array_equal(trace_t.streak.numpy(), trace_j.streak)
    assert np.max(np.abs(trace_t.subspace_error.numpy()
                         - np.asarray(trace_j.subspace_error))) <= TRACE_TOL
    assert np.max(np.abs(got["state"].v.numpy()
                         - np.asarray(state_j.v))) <= TRACE_TOL
    # the summary benchmarks/common.py's convergence_run reads off the trace
    assert got["steps_to_streak"] == jsolvers.steps_to_streak(trace_j, k)
    assert got["steps_to_1pct"] == jsolvers.steps_to_tolerance(trace_j, 0.01)
    assert got["final_streak"] == int(trace_j.streak[-1])
    final_j = float(trace_j.subspace_error[-1])
    assert abs(got["final_err"] - final_j) <= TRACE_TOL


def test_paper_transform_suite_matches_jax():
    rho = 8.0
    suite_j = bench_common.paper_transform_suite(rho, degree=151)
    suite_t = smoke.paper_transform_suite(rho, degree=151)
    assert list(suite_t) == list(suite_j)
    lam = np.linspace(0.0, rho, 17).astype(np.float32)
    for name in suite_j:
        sj, st = suite_j[name], suite_t[name]
        assert (st.degree, st.lambda_star) == (sj.degree, sj.lambda_star)
        np.testing.assert_allclose(
            st.reversed_scalar(torch.from_numpy(lam)).numpy(),
            np.asarray(sj.reversed_scalar(jnp.asarray(lam))),
            rtol=1e-5, atol=1e-6, err_msg=name)


# ---- Table 2 ----------------------------------------------------------------

def _jax_table2() -> dict:
    """benchmarks/bench_transforms.py's ratios, computed as it computes
    them (its suite and conv_ratio, without the apply timing)."""
    lam = jnp.concatenate([jnp.asarray([0.0, 0.05, 0.08, 0.12]),
                           jnp.linspace(20.0, 60.0, 60)])
    rho = float(lam[-1])
    k = 4
    suite = {
        "identity": jseries.with_lambda_star(jseries.identity_series(),
                                             rho * 1.01),
        "taylor_log_d51": jseries.taylor_log(51, eps=0.05),
        "taylor_neg_exp_d51": jseries.taylor_neg_exp(51),
        "limit_neg_exp_d251": jseries.limit_neg_exp(251),
        "limit_neg_exp_d251_s8": jseries.limit_neg_exp(251, scale=8.0 / rho),
        "cheb_log_d64": jseries.cheb_log(64, rho=rho),
        "cheb_neg_exp_d32": jseries.cheb_neg_exp(32, rho=rho, tau=8.0 / rho),
    }

    def conv_ratio(f_vals):
        f_vals = jnp.sort(f_vals)
        gaps = jnp.diff(f_vals[: k + 1])
        rng = f_vals[-1] - f_vals[0]
        return float(rng / jnp.maximum(jnp.min(gaps), 1e-30))

    base = conv_ratio(lam)
    out = {}
    for name, s in suite.items():
        ratio = conv_ratio(s.scalar(lam))
        dil = (base / ratio if np.isfinite(ratio) and ratio > 0
               else float("nan"))
        out[name] = (ratio, dil)
    return out


TABLE2 = ("identity", "taylor_log_d51", "taylor_neg_exp_d51",
          "limit_neg_exp_d251", "limit_neg_exp_d251_s8", "cheb_log_d64",
          "cheb_neg_exp_d32")


@pytest.fixture(scope="module")
def table2_pair():
    return smoke.table2_ratios(CPU), _jax_table2()


@pytest.mark.parametrize("name", TABLE2)
def test_table2_ratios_match_jax(table2_pair, name):
    got, want = table2_pair
    assert list(got) == list(TABLE2)
    for g, w in zip(got[name], want[name]):
        if name == "taylor_log_d51":  # diverges in both (paper Sec. 5.3)
            assert not math.isfinite(g) and not math.isfinite(w)
        else:
            assert math.isfinite(w)
            assert abs(g - w) <= RATIO_RTOL * abs(w), (g, w)
