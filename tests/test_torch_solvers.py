"""Solvers, metrics and the solve loop of the port against the JAX package.

JAX draws its initial panel with jax.random, which torch cannot
reproduce, so whole solves start both packages from the same numpy
panel (``init_v``).  The fused path runs on the CPU through the plain
twins of K2 (series steps) and K3/K4 (mu-EG step).  Tolerance 1e-5
max-abs, the TOL of tests/test_backend.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusteringConfig as JClusteringConfig
from repro.core import SolverConfig as JSolverConfig
from repro.core import laplacian as jlap
from repro.core import metrics as jmetrics
from repro.core import operators as jops
from repro.core import program as jprogram
from repro.core import series as jseries
from repro.core import solvers as jsolvers
from repro_torch import convert
from repro_torch.core import backend, metrics, operators, program, series, solvers
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops

TOL = 1e-5
CPU = "cpu"


def _panel(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _unit_cols(seed: int, n: int, k: int) -> np.ndarray:
    v = _panel(seed, n, k)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _states(v):
    return (jsolvers.SolverState(v=jnp.asarray(v), step=jnp.zeros((), jnp.int32)),
            convert.solver_state_from_numpy(v, 0, device=CPU))


@pytest.mark.parametrize("name", ["oja_step", "mu_eg_step"])
def test_solver_steps_match_jax(name):
    v, av = _unit_cols(1, 300, 6), _panel(2, 300, 6)
    sj, st = _states(v)
    want = getattr(jsolvers, name)(sj, jnp.asarray(av), 0.05)
    got = getattr(solvers, name)(st, torch.from_numpy(av), 0.05)
    assert _maxabs(got.v.numpy(), want.v) <= TOL
    assert int(got.step) == int(want.step) == 1


def test_fused_step_and_gram_forms_match_jax():
    v, av = _unit_cols(3, 257, 5), _panel(4, 257, 5)
    sj, st = _states(v)
    want = jsolvers.mu_eg_step(sj, jnp.asarray(av), 0.1)
    tav = torch.from_numpy(av)
    fused = solvers.mu_eg_step_fused(st, tav, 0.1)
    assert _maxabs(fused.v.numpy(), want.v) <= TOL
    gram = solvers.panel_gram2k(st.v, tav)
    assert _maxabs(gram.numpy(), jsolvers.panel_gram2k(sj.v, jnp.asarray(av))) \
        <= TOL * 10  # a sum over 257 rows of O(1) products
    from_gram = program.apply_solver_step(None, st, tav, 0.1, gram=gram)
    assert _maxabs(from_gram.v.numpy(), want.v) <= TOL


def test_init_from_panel_matches_jax():
    v = _panel(5, 120, 4)
    want = jsolvers.init_from_panel(jnp.asarray(v))
    got = solvers.init_from_panel(torch.from_numpy(v))
    assert got.v.is_contiguous()
    assert _maxabs(got.v.numpy(), want.v) <= TOL


def test_init_state_orthonormal_and_seeded():
    a = solvers.init_state(torch.Generator().manual_seed(7), 200, 5)
    b = solvers.init_state(torch.Generator().manual_seed(7), 200, 5)
    torch.testing.assert_close(a.v, b.v, atol=0, rtol=0)
    torch.testing.assert_close(a.v.T @ a.v, torch.eye(5), atol=1e-5, rtol=0)
    assert a.v.is_contiguous() and int(a.step) == 0


def test_make_step_fn_resolution():
    assert solvers.make_step_fn("mu_eg", "auto", CPU) is solvers.mu_eg_step
    assert solvers.make_step_fn("oja", "segment", CPU) is solvers.oja_step
    assert solvers.make_step_fn("mu_eg", "kernel", "cuda") is solvers.mu_eg_step_fused
    assert solvers.make_step_fn("oja", "kernel", "cuda") is solvers.oja_step
    with pytest.raises(ValueError):
        solvers.make_step_fn("mu_eg", "kernel", CPU)


def _graph_pair(seed=0, n=96, e=300):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    return (jlap.make_edge_list(edges, n, weights=w),
            lap.make_edge_list(edges, n, weights=w, device=CPU))


@pytest.mark.parametrize("method", ["mu_eg", "oja"])
def test_run_program_from_same_init_matches_jax(method):
    """The slice's solve loop as a whole: series operator + solver steps +
    trace cadence, from the same initial panel."""
    gj, gt = _graph_pair()
    sj, st = jseries.limit_neg_exp(7, scale=0.4), series.limit_neg_exp(7, scale=0.4)
    init = _panel(6, gj.num_nodes, 4)
    v_star = _unit_cols(7, gj.num_nodes, 4)
    cfg_j = JSolverConfig(method=method, lr=0.3, steps=10, eval_every=5, k=4,
                          backend="segment")
    cfg_t = convert.solver_config_from_dict(dataclasses.asdict(cfg_j))
    state_j, trace_j = jprogram.run_program(
        jops.edge_series_operator(gj, sj, backend="segment"), gj.num_nodes,
        cfg_j, v_star=jnp.asarray(v_star), init_v=jnp.asarray(init))
    state_t, trace_t = program.run_program(
        operators.edge_series_operator(gt, st, backend="segment"), gt.num_nodes,
        cfg_t, v_star=torch.from_numpy(v_star), init_v=torch.from_numpy(init))
    assert _maxabs(state_t.v.numpy(), state_j.v) <= TOL
    np.testing.assert_array_equal(trace_t.steps.numpy(), trace_j.steps)
    assert _maxabs(trace_t.subspace_error.numpy(), trace_j.subspace_error) <= TOL
    np.testing.assert_array_equal(trace_t.streak.numpy(), trace_j.streak)


def test_run_chunk_fused_path_matches_jax():
    """The kernel path's composition on the CPU twins: node-blocked fused
    series steps (K2) and the fused two-pass mu-EG step (K3/K4)."""
    gj, gt = _graph_pair(seed=1, n=301, e=517)
    sj, st = jseries.limit_neg_exp(9, scale=0.3), series.limit_neg_exp(9, scale=0.3)
    nb = backend.blocking_for(gt, block_n=64)
    opv_t = operators.series_operator(
        st, None, fused_step=lambda u, a, b: es_ops.edge_spmm_blocked(nb, u, a, b))
    opv_j = jops.edge_series_operator(gj, sj, backend="segment")
    v0 = _unit_cols(8, gj.num_nodes, 5)
    sj0, st0 = _states(v0)
    state_j, res_j = jprogram.run_chunk(opv_j, jsolvers.mu_eg_step, sj0, 0.4, 4)
    state_t, res_t = program.run_chunk(opv_t, solvers.mu_eg_step_fused, st0, 0.4, 4)
    assert _maxabs(state_t.v.numpy(), state_j.v) <= TOL
    assert abs(float(res_t) - float(res_j)) <= TOL
    assert int(state_t.step) == 4


def test_metrics_match_jax():
    v, vs = _panel(9, 150, 4), _unit_cols(10, 150, 4)
    av = _panel(11, 150, 4)
    tv, tvs, tav = (torch.from_numpy(a) for a in (v, vs, av))
    assert abs(float(metrics.subspace_error(tv, tvs))
               - float(jmetrics.subspace_error(jnp.asarray(v), jnp.asarray(vs)))) <= TOL
    assert int(metrics.eigenvector_streak(tvs, tvs)) == 4
    assert int(metrics.eigenvector_streak(tv, tvs)) == int(
        jmetrics.eigenvector_streak(jnp.asarray(v), jnp.asarray(vs)))
    assert abs(float(metrics.panel_residual(tvs, tav))
               - float(jmetrics.panel_residual(jnp.asarray(vs), jnp.asarray(av)))) <= TOL
    gj, gt = _graph_pair()
    lam_j, _ = jmetrics.ground_truth_bottom_k(jlap.laplacian_dense(gj), 5, True)
    lam_t, _ = metrics.ground_truth_bottom_k(lap.laplacian_dense(gt), 5, True)
    assert _maxabs(lam_t.numpy(), lam_j) <= 1e-4  # two eigh routines, fp32


def test_steps_to_helpers():
    tr = solvers.Trace(steps=torch.tensor([5, 10, 15]),
                       subspace_error=torch.tensor([0.5, 0.01, 0.001]),
                       streak=torch.tensor([0, 2, 4]))
    jtr = jsolvers.Trace(steps=jnp.asarray([5, 10, 15]),
                         subspace_error=jnp.asarray([0.5, 0.01, 0.001]),
                         streak=jnp.asarray([0, 2, 4]))
    for tol in (0.6, 0.02, 1e-4):
        assert solvers.steps_to_tolerance(tr, tol) == jsolvers.steps_to_tolerance(jtr, tol)
    for k in (1, 4, 5):
        assert solvers.steps_to_streak(tr, k) == jsolvers.steps_to_streak(jtr, k)


def test_config_conversion_from_jax_dicts():
    jc = JClusteringConfig(num_clusters=3, degree=51, backend="pallas",
                           solver=JSolverConfig(lr=0.2, steps=40, backend="pallas"))
    tc = convert.clustering_config_from_dict(dataclasses.asdict(jc))
    assert tc.backend == "kernel" and tc.solver.backend == "kernel"
    assert tc.degree == 51 and tc.solver.lr == 0.2 and tc.num_clusters == 3
    assert dataclasses.asdict(tc).keys() == dataclasses.asdict(jc).keys()


def test_solver_state_from_numpy_keeps_dtypes():
    st = convert.solver_state_from_numpy(np.ones((4, 2)), np.int64(3), device=CPU)
    assert st.v.dtype == torch.float32 and st.step.dtype == torch.int32
    assert int(st.step) == 3
    jax_state = jsolvers.init_state(jax.random.PRNGKey(0), 10, 2)
    st = convert.solver_state_from_numpy(jax_state.v, jax_state.step, device=CPU)
    assert _maxabs(st.v.numpy(), jax_state.v) == 0.0
