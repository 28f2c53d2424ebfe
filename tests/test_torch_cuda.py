"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the JAX package, so on a machine that has only
PyTorch it runs as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the result's scale (max(|plain|, 1)).  K1 and K2 sum
each row in registers in an order the layout fixes, K3/K4 in another
order than the plain matmuls, so they agree with their twins to
rounding, not bitwise; all four are bitwise equal from run to run.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (ClusteringConfig, SolverConfig, SolverState,
                              backend, graphs, limit_neg_exp, operators,
                              solvers, spectral_cluster)
from repro_torch.core import laplacian as lap
from repro_torch.core.kmeans import cluster_agreement
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.kernels.edge_spmm import ref as es_ref
from repro_torch.kernels.eg_update import ops as eg_ops
from repro_torch.kernels.eg_update import ref as eg_ref
from repro_torch.kernels.laplacian_poly import ops as lp_ops
from repro_torch.kernels.laplacian_poly import ref as lp_ref

pytestmark = pytest.mark.cuda

REL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(seed: int, n: int, e: int, dev, capacity: int | None = None):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    g = lap.make_edge_list(edges, n, weights=w, device=dev)
    return lap.pad_edge_list(g, capacity) if capacity else g


def _panel(seed: int, n: int, k: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)).to(dev)


def _rel_err(got, want) -> float:
    torch.cuda.synchronize()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


GRAPHS = {
    "weighted": (0, 96, 300, None),
    "capacity_padded": (1, 96, 300, 512),
    "non_aligned": (2, 301, 517, None),
    "larger": (3, 9216, 40000, None),
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_k1_matches_plain(dev, case):
    g = _graph(*GRAPHS[case][:3], dev, capacity=GRAPHS[case][3])
    v = _panel(10, g.num_nodes, 10, dev)
    reset_launch_counts()
    got = es_ops.edge_spmm(g.src, g.dst, g.weight, v, alpha=-0.2, beta=1.0)
    assert launch_counts()["edge_spmm"] == 1
    want = es_ref.edge_spmm_affine(g.src, g.dst, g.weight, v, -0.2, 1.0)
    assert _rel_err(got, want) <= REL


def test_k1_edgeless_returns_beta_v(dev):
    g = lap.make_edge_list(np.zeros((0, 2), np.int64), 40, device=dev)
    v = _panel(11, 40, 3, dev)
    out = es_ops.edge_spmm(g.src, g.dst, g.weight, v, alpha=2.0, beta=0.5)
    torch.testing.assert_close(out, 0.5 * v, atol=0, rtol=0)


@pytest.mark.parametrize("block_n,block_e", [(16, 32), (64, 128), (512, 128)])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_k2_matches_plain(dev, case, block_n, block_e):
    g = _graph(*GRAPHS[case][:3], dev, capacity=GRAPHS[case][3])
    nb = backend.blocking_for(g, block_n=block_n, block_e=block_e)
    v = _panel(12, g.num_nodes, 10, dev)
    reset_launch_counts()
    got = es_ops.edge_spmm_blocked(nb, v, alpha=-0.3, beta=1.0)
    assert launch_counts()["edge_spmm_nb"] == 1
    want = es_ref.edge_spmm_blocked(nb.u_local, nb.other, nb.weight,
                                    nb.block_chunks, nb.deg, v, -0.3, 1.0,
                                    block_n=block_n, block_e=block_e)
    assert _rel_err(got, want) <= REL
    seg = -0.3 * lap.laplacian_matvec(g, v) + v
    assert _rel_err(got, seg) <= REL


def test_k2_refuses_too_wide_panels(dev):
    """K2 once refused panels whose (block_n, k) shared accumulator did not
    fit; the row gather holds no accumulator in shared memory, so a
    120-column panel runs as column groups and matches the twins."""
    g = _graph(0, 96, 300, dev)
    nb = backend.blocking_for(g, block_n=512)
    v = _panel(1, 96, 120, dev)
    got = es_ops.edge_spmm_blocked(nb, v, alpha=-0.3, beta=1.0)
    rows = es_ops.blocking_rows(nb)
    assert _rel_err(got, es_ref.edge_spmm_rows(
        rows.row_ptr, rows.other, rows.weight, v, -0.3, 1.0)) <= REL
    assert _rel_err(got, -0.3 * lap.laplacian_matvec(g, v) + v) <= REL


@pytest.mark.parametrize("k", [1, 4, 10, 37])
@pytest.mark.parametrize("num_shards", [2, 3])
def test_k2_rectangular_launch_matches_twin(dev, num_shards, k):
    """K2 over a panel shard's owned rows: R output rows whose own terms
    are ``v_self`` (a row range of V, so its alignment moves with the
    shard's first row) and whose neighbours index all of V.  Shard by
    shard the rows concatenate to alpha L V + beta V."""
    g = _power_law(dev, 9216)
    v = _panel(42, g.num_nodes, k, dev)
    parts = []
    for s in range(num_shards):
        rows = es_ops.build_model_shard_rows(g.src, g.dst, g.weight,
                                             g.num_nodes, num_shards, s,
                                             block_n=64)
        r = rows.row_ptr.shape[0] - 1
        reset_launch_counts()
        got = es_ops.model_local_rows(rows, v, -0.05, 1.0, s * r)
        assert launch_counts()["edge_spmm_nb"] == 1
        vp = torch.cat([v, v.new_zeros((num_shards * r - g.num_nodes, k))])
        want = es_ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                     vp, -0.05, 1.0,
                                     v_self=vp[s * r:(s + 1) * r])
        assert _rel_err(got, want) <= REL
        torch.testing.assert_close(
            es_ops.model_local_rows(rows, v, -0.05, 1.0, s * r), got,
            atol=0, rtol=0)
        parts.append(got)
    full = torch.cat(parts)[:g.num_nodes]
    assert _rel_err(full, es_ref.edge_spmm_affine(
        g.src, g.dst, g.weight, v, -0.05, 1.0)) <= REL
    # v_self = v is the square launch, bit for bit
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    torch.testing.assert_close(
        es_ops.edge_spmm_rows_nb(rows, v, -0.05, 1.0, v_self=v),
        es_ops.edge_spmm_rows_nb(rows, v, -0.05, 1.0), atol=0, rtol=0)


def _power_law(dev, n=4096):
    return graphs.power_law_graph(n, avg_degree=8, alpha=2.5, seed=0,
                                  device=dev)


@pytest.mark.parametrize("k", [1, 4, 10, 37])
@pytest.mark.parametrize("threshold", [0, 5, 128])
def test_k1_k2_split_hub_rows_match_twins(dev, threshold, k, monkeypatch):
    """The alpha = 2.5 power-law graph (rows up to 613 half-edges) with the
    hub split forced down to every row (0) or most rows (5); k = 4, 10 and
    37 take the float4, float2 and scalar loads, 37 three column groups.
    K2 runs over the rows of the JAX-equal blocking."""
    monkeypatch.setattr(es_ops, "HUB_THRESHOLD", threshold)
    g = _power_law(dev)
    v = _panel(40, g.num_nodes, k, dev)
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    assert int((rows.hub_rows < g.num_nodes).sum()) > 0  # the split runs
    nb = backend.blocking_for(g)
    want = es_ref.edge_spmm_affine(g.src, g.dst, g.weight, v, -0.05, 1.0)
    reset_launch_counts()
    k1 = es_ops.edge_spmm_rows(rows, v, alpha=-0.05, beta=1.0)
    k2 = es_ops.edge_spmm_blocked(nb, v, alpha=-0.05, beta=1.0)
    assert launch_counts()["edge_spmm"] == launch_counts()["edge_spmm_nb"] == 1
    for got in (k1, k2):
        assert _rel_err(got, want) <= REL
        assert _rel_err(got, es_ref.edge_spmm_rows(
            rows.row_ptr, rows.other, rows.weight, v, -0.05, 1.0)) <= REL
    # the same layout, split or not, sums each row in the same order
    # within a block; K1 and K2 read the same CSR
    torch.testing.assert_close(k1, k2, atol=0, rtol=0)


def test_k1_k2_are_bitwise_deterministic(dev, monkeypatch):
    monkeypatch.setattr(es_ops, "HUB_THRESHOLD", 16)
    g = _power_law(dev, 9216)
    v = _panel(41, g.num_nodes, 10, dev)
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    nb = backend.blocking_for(g)
    for fn in (lambda: es_ops.edge_spmm_rows(rows, v, -0.1, 1.0),
               lambda: es_ops.edge_spmm_rows_nb(rows, v, -0.1, 1.0),
               lambda: es_ops.edge_spmm_blocked(nb, v, -0.1, 1.0),
               lambda: es_ops.edge_spmm(g.src, g.dst, g.weight, v, -0.1, 1.0)):
        first = fn()
        for _ in range(3):
            torch.testing.assert_close(fn(), first, atol=0, rtol=0)


@pytest.mark.parametrize("n", [96, 8192])
def test_captured_series_operator_is_the_eager_loop(dev, n):
    """The kernel-path operator replays a CUDA graph: bitwise the eager
    fused loop, with the eager loop's launch counts on every call."""
    g = _graph(7, n, 4 * n, dev)
    s = limit_neg_exp(9, scale=0.4 / float(lap.spectral_radius_upper_bound(g)))
    name = "edge_spmm" if n <= backend.ONE_HOT_NODE_LIMIT else "edge_spmm_nb"
    fused = backend.fused_step_fn(g, "kernel")
    op = operators.edge_series_operator(g, s, backend="kernel")
    assert isinstance(op, operators.CapturedOperator)
    for seed in (42, 43, 44):
        v = _panel(seed, n, 6, dev)
        reset_launch_counts()
        eager = s.apply_reversed_fused(fused, v)
        assert launch_counts()[name] == 9
        reset_launch_counts()
        got = op(v)
        assert launch_counts() == {**{k: 0 for k in launch_counts()}, name: 9}
        torch.testing.assert_close(got, eager, atol=0, rtol=0)
    assert len(op.graphs) == 1
    # a new panel shape is a new capture
    op(_panel(45, n, 3, dev))
    assert len(op.graphs) == 2


def test_one_step_series_runs_eagerly(dev):
    """A series of one fused step is not captured (the graph would hold
    one launch); it launches the same kernel once per call."""
    g = _graph(9, 96, 300, dev)
    s = limit_neg_exp(1, scale=0.1)
    op = operators.edge_series_operator(g, s, backend="kernel")
    assert not isinstance(op, operators.CapturedOperator)
    v = _panel(47, 96, 4, dev)
    reset_launch_counts()
    got = op(v)
    assert launch_counts()["edge_spmm"] == 1
    eager = s.apply_reversed_fused(backend.fused_step_fn(g, "kernel"), v)
    torch.testing.assert_close(got, eager, atol=0, rtol=0)


def test_captured_operator_raises_without_fallback(dev):
    g = _graph(8, 96, 300, dev)
    op = operators.edge_series_operator(g, limit_neg_exp(5, scale=0.1),
                                        backend="kernel")
    reset_launch_counts()
    with pytest.raises(ValueError, match="96"):
        op(_panel(46, 95, 4, dev))  # the layout has 96 rows
    with pytest.raises(ValueError, match="CUDA"):
        op(torch.zeros(96, 4))
    assert op.graphs == {}
    assert sum(launch_counts().values()) == 0


# n = 1 and below one K3 tile (128 rows at k = 10), n a multiple of neither
# 4 nor a tile, k from 1 to K3's widest; offset 1 takes the row slice
# [1:] of a larger panel, whose rows start 4k bytes past the allocation,
# off any 16-byte boundary unless 4 divides k; the paper's figures add
# their panels: the MDP at s = 1, 2 and 59 (k = 6, 5, 5), the cliques'
# 400 x 4
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,k", [(1, 3), (1, 10), (100, 10), (300, 6),
                                 (1001, 1), (301, 3), (4097, 4), (5000, 10),
                                 (5003, 7), (70000, 16), (70001, 10),
                                 (3001, 64), (2000, 192), (341, 6), (1281, 5),
                                 (400, 4), (1046661, 5)])
def test_k3_k4_match_plain(dev, n, k, offset):
    v = _panel(13, n + offset, k, dev)[offset:]
    av = _panel(14, n + offset, k, dev)[offset:]
    reset_launch_counts()
    s = eg_ops.gram2k(v, av)
    assert _rel_err(s, eg_ref.gram2k(v, av)) <= REL
    m1, m2, cs = (_panel(15, k, k, dev), _panel(16, k, k, dev),
                  _panel(17, 1, k, dev)[0])
    out = eg_ops.panel_mix(v, av, m1, m2, cs)
    assert _rel_err(out, eg_ref.panel_mix(v, av, m1, m2, cs)) <= REL
    assert launch_counts()["gram2k"] == 1 and launch_counts()["panel_mix"] == 1


def test_k3_refuses_too_wide_panels(dev):
    v = _panel(12, 10, 193, dev)
    with pytest.raises(ValueError, match="gram2k"):
        eg_ops.gram2k(v, v)


def _mix_inputs(n: int, k: int, dev):
    v, av = _panel(18, n, k, dev), _panel(19, n, k, dev)
    m1, m2, cs = eg_ref.coefficient_matrices(eg_ref.gram2k(v, av), k, 0.4)
    return v, av, m1, m2, cs


def test_gram2k_is_deterministic(dev):
    v, av = _mix_inputs(100000, 10, dev)[:2]
    torch.testing.assert_close(eg_ops.gram2k(v, av), eg_ops.gram2k(v, av),
                               atol=0, rtol=0)


def test_panel_mix_is_deterministic(dev):
    args = _mix_inputs(100003, 10, dev)
    torch.testing.assert_close(eg_ops.panel_mix(*args), eg_ops.panel_mix(*args),
                               atol=0, rtol=0)


def test_k3_k4_replayed_in_a_graph_give_the_eager_bits(dev):
    """A K3 and a K4 call captured in one CUDA graph and replayed twice
    write the eager calls' bits: no scratch or counter carries over."""
    args = _mix_inputs(100003, 10, dev)
    want_s = eg_ops.gram2k(*args[:2])
    want_out = eg_ops.panel_mix(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eg_ops.gram2k(*args[:2])
        eg_ops.panel_mix(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_s = eg_ops.gram2k(*args[:2])
        got_out = eg_ops.panel_mix(*args)
    for _ in range(2):
        got_s.fill_(float("nan"))
        got_out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got_s, want_s) and torch.equal(got_out, want_out)


def test_fused_mu_eg_step_matches_segment(dev):
    v = _panel(20, 300, 6, dev)
    v = v / torch.linalg.vector_norm(v, dim=0, keepdim=True)
    av = _panel(21, 300, 6, dev)
    st = SolverState(v=v, step=torch.zeros((), dtype=torch.int32, device=dev))
    seg = solvers.make_step_fn("mu_eg", "segment", dev)(st, av, 0.05)
    ker = solvers.make_step_fn("mu_eg", "kernel", dev)(st, av, 0.05)
    assert float((seg.v - ker.v).abs().max()) <= REL
    assert int(seg.step) == int(ker.step) == 1


@pytest.mark.parametrize("n", [96, 8192])
def test_fused_series_operator_matches_segment(dev, n):
    g = _graph(4, n, 4 * n, dev)
    g = g._replace(weight=g.weight * (1.5 / float(
        lap.spectral_radius_upper_bound(g))))
    s = limit_neg_exp(9, scale=0.4)
    v = _panel(22, n, 4, dev)
    seg = operators.edge_series_operator(g, s, backend="segment")(v)
    ker = operators.edge_series_operator(g, s, backend="kernel")(v)
    assert _rel_err(ker, seg) <= REL


def test_solver_steps_match_segment_node_blocked(dev):
    """Three solver steps of the kernel path (K2 + K3 + K4) against the
    segment path on a node-blocked graph."""
    g = _graph(5, 8192, 40000, dev)
    rho = float(lap.spectral_radius_upper_bound(g))
    s = limit_neg_exp(15, scale=8.0 / rho)
    init = _panel(23, 8192, 10, dev)
    out = {}
    for b in ("segment", "kernel"):
        op = operators.edge_series_operator(g, s, backend=b)
        cfg = SolverConfig(lr=0.4, steps=3, eval_every=3, k=10, backend=b)
        out[b] = solvers.run_solver(op, 8192, cfg, init_v=init)[0].v
    assert float((out["segment"] - out["kernel"]).abs().max()) <= 1e-4


def test_spectral_cluster_small_runs_kernels(dev):
    g, truth = graphs.clique_graph(160, 4, seed=3, device=dev)
    cfg = ClusteringConfig(
        num_clusters=4, degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=200, eval_every=100))
    reset_launch_counts()
    labels, _ = spectral_cluster(g, cfg)
    counts = launch_counts()
    assert counts["edge_spmm"] == 200 * 251  # every series step on K1
    assert counts["gram2k"] == counts["panel_mix"] == 200
    assert float(cluster_agreement(labels, truth, 4)) > 0.95


def test_spans_of_an_exact_edges_job_on_the_card(dev):
    """Under the CUDA profiler a job past K1's node limit records one
    capture, device times that nest, the allocator's calls, and no span
    on the device side of the trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    n = 2 * backend.ONE_HOT_NODE_LIMIT
    g, _ = graphs.sparse_sbm_graph(n, 3, 8.0, 0.5, seed=5, device=dev)
    cfg = ClusteringConfig(num_clusters=3, degree=15, kmeans_restarts=2,
                           solver=SolverConfig(lr=0.1, steps=4, eval_every=2))
    spectral_cluster(g, cfg)  # warm: the kernel library is built
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spectral_cluster(g, cfg)
        torch.cuda.synchronize()
    recs = spans.records()
    names = [r.name for r in recs]
    assert names.count("sped.capture") == 1
    assert names.count("sped.eval") == 2 and names.count("sped.cluster") == 1
    by_index = {r.index: r for r in recs}
    for r in recs:
        assert r.device_ms is not None and r.device_ms >= 0.0, r
        if r.parent is not None:
            assert r.device_ms <= by_index[r.parent].device_ms, r
    (job,) = [r for r in recs if r.name == "sped.cluster"]
    assert set(job.allocs) == {"num_device_alloc", "num_device_free"}
    assert all(isinstance(v, int) and v >= 0 for v in job.allocs.values())
    events = prof.profiler.kineto_results.events()
    on_device = [e.name() for e in events
                 if not str(e.device_type()).endswith("CPU")]
    assert on_device and not [m for m in on_device if m.startswith("sped.")]
    on_host = {e.name() for e in events if e.name().startswith("sped.")}
    assert on_host == set(names)
    spans.clear()


def _sym(seed: int, n: int, dev) -> torch.Tensor:
    a = _panel(seed, n, n, dev)
    return (a + a.T) / (2.0 * n ** 0.5)


@pytest.mark.parametrize("n,k", [(1, 1), (300, 4), (301, 10), (517, 12),
                                 (1029, 16), (640, 37)])
def test_k5_k6_match_plain(dev, n, k):
    """Ragged n (301, 517, 1029 take the scalar-load variant), one strip
    short of full, and k past 16 (column groups)."""
    l_mat = _sym(30, n, dev)
    u = _panel(31, n, k, dev)
    reset_launch_counts()
    got = lp_ops.poly_step(l_mat, u, 0.03)
    assert _rel_err(got, lp_ref.poly_step(l_mat, u, 0.03)) <= REL
    got6 = lp_ops.dense_matvec_panel(l_mat, u)
    assert _rel_err(got6, lp_ref.dense_matvec_panel(l_mat, u)) <= REL
    counts = launch_counts()
    assert counts["poly_step"] == 1 and counts["dense_matvec_panel"] == 1


def test_k5_takes_bf16_and_unaligned_views(dev):
    l_mat = _sym(32, 256, dev)
    u = _panel(33, 256, 4, dev)
    got = lp_ops.poly_step(l_mat.bfloat16(), u, 0.1)
    want = lp_ref.poly_step(l_mat.bfloat16().float(), u, 0.1)
    assert _rel_err(got, want) <= REL
    # an L that starts 4 bytes past alignment takes the scalar loads
    flat = torch.empty(256 * 256 + 1, device=dev)
    shifted = flat[1:].view(256, 256)
    shifted.copy_(l_mat)
    assert shifted.data_ptr() % 16 != 0
    got = lp_ops.poly_step(shifted, u, 0.1)
    assert _rel_err(got, lp_ref.poly_step(l_mat, u, 0.1)) <= REL


def test_limit_series_apply_matches_series(dev):
    l_mat = _sym(34, 1000, dev) / 10
    v = _panel(35, 1000, 6, dev)
    reset_launch_counts()
    got = lp_ops.limit_series_apply(l_mat, v, degree=31, scale=2.0)
    assert launch_counts()["poly_step"] == 31
    want = limit_neg_exp(31, scale=2.0).apply(operators.dense_matvec(l_mat), v)
    assert _rel_err(got, want) <= 1e-4  # 31 steps of fp32 rounding


def test_k5_refuses_cpu_tensors():
    from repro_torch.kernels.laplacian_poly import kernel as lp_kernel
    with pytest.raises(ValueError, match="CUDA"):
        lp_kernel.poly_step(torch.eye(4), torch.ones(4, 2), 0.1)


def test_probe_runs_one_k1_launch_per_lanczos_step(dev):
    from repro_torch import spectral
    g = _graph(6, 9216, 40000, dev)  # past the one-hot limit: K1 all the same
    reset_launch_counts()
    # the default backend ("auto") of a card graph is the kernel path
    probe = spectral.probe_graph(g, torch.Generator(device=dev).manual_seed(0))
    assert launch_counts()["edge_spmm"] == 24
    seg = spectral.probe_graph(g, torch.Generator(device=dev).manual_seed(0),
                               backend="segment")
    lam = float(seg.lambda_max)
    assert abs(float(probe.lambda_max) - lam) <= 1e-3 * lam


def test_auto_spectral_cluster_on_the_card(dev):
    from repro_torch import spectral
    g, truth = graphs.clique_graph(160, 4, seed=3, device=dev)
    cfg = ClusteringConfig(
        num_clusters=4, transform="auto", degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=200, eval_every=100))
    reset_launch_counts()
    labels, info = spectral_cluster(g, cfg)
    counts = launch_counts()
    plan = info["plan"]
    # 24 probe steps, then degree K1 calls per solver step
    assert counts["edge_spmm"] == 24 + 200 * plan.degree
    assert counts["gram2k"] == counts["panel_mix"] == 200
    assert float(cluster_agreement(labels, truth, 4)) > 0.95
    lam = torch.linalg.eigvalsh(lap.laplacian_dense(g).double())
    probe = spectral.probe_graph(g, torch.Generator(device=dev).manual_seed(3),
                                 backend="kernel")
    assert 0.9 <= float(probe.lambda_max) / float(lam[-1]) <= 1.1


def _minibatch_case(dev, n: int = 301, e: int = 2000):
    g_cpu = _graph(11, n, e, "cpu")
    g = lap.EdgeList(g_cpu.src.to(dev), g_cpu.dst.to(dev), g_cpu.weight.to(dev),
                     n)
    return g_cpu, g, limit_neg_exp(7, scale=0.5 / float(
        lap.spectral_radius_upper_bound(g_cpu)))


def test_minibatch_operator_on_the_card_matches_segment(dev):
    """Each factor one K1 launch on its drawn batch; from the same
    injected sel the card's operator equals the CPU segment run."""
    g_cpu, g, s = _minibatch_case(dev)
    sel = torch.randint(0, g.num_edges, (8, 256),
                        generator=torch.Generator().manual_seed(0))
    v = _panel(50, g.num_nodes, 10, dev)
    want = operators.minibatch_operator(g_cpu, s, 256, backend="segment")(
        None, v.cpu(), sel=sel)
    op = operators.minibatch_operator(g, s, 256, backend="kernel")
    reset_launch_counts()
    got = op(None, v, sel=sel.to(dev))
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "edge_spmm": 7}
    assert _rel_err(got, want.to(dev)) <= REL
    torch.testing.assert_close(op(None, v, sel=sel.to(dev)), got, atol=0, rtol=0)


def test_minibatch_operator_draws_on_the_card(dev):
    _, g, s = _minibatch_case(dev)
    op = operators.minibatch_operator(g, s, 128, backend="kernel")
    v = _panel(51, g.num_nodes, 4, dev)
    a = op(torch.Generator(device=dev).manual_seed(3), v)
    b = op(torch.Generator(device=dev).manual_seed(3), v)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, op(torch.Generator(device=dev).manual_seed(4), v))


def test_minibatch_batch_with_repeats_and_a_hub_row(dev):
    """Draws with replacement: one edge 48 times in a batch makes both its
    ends hub rows (> HUB_THRESHOLD half-edges) of the batch's row CSR."""
    g_cpu, g, s = _minibatch_case(dev)
    rng = np.random.default_rng(2)
    sel = rng.integers(0, g.num_edges, (8, 96))
    sel[:, :48] = 5
    sel[3, 48:] = rng.integers(0, 4, 48)  # few distinct edges, many repeats
    sel = torch.from_numpy(sel)
    v = _panel(52, g.num_nodes, 10, dev)
    want = operators.minibatch_operator(g_cpu, s, 96, backend="segment")(
        None, v.cpu(), sel=sel)
    got = operators.minibatch_operator(g, s, 96, backend="kernel")(
        None, v, sel=sel.to(dev))
    assert _rel_err(got, want.to(dev)) <= REL
    rows = es_ops.build_edge_rows(g.src[sel[0].to(dev)], g.dst[sel[0].to(dev)],
                                  g.weight[sel[0].to(dev)], g.num_nodes)
    assert int((rows.hub_rows < g.num_nodes).sum()) >= 2


def test_minibatch_spectral_cluster_on_the_card(dev):
    g, truth = graphs.clique_graph(120, 3, seed=4, device=dev)
    cfg = ClusteringConfig(
        num_clusters=3, degree=51, estimation="minibatch", batch_edges=512,
        solver=SolverConfig(method="mu_eg", lr=0.1, steps=1500, eval_every=250))
    reset_launch_counts()
    labels, _ = spectral_cluster(g, cfg)
    counts = launch_counts()
    assert counts["edge_spmm"] == 1500 * 51  # one K1 per drawn factor
    assert counts["gram2k"] == counts["panel_mix"] == 1500
    assert float(cluster_agreement(labels, truth, 3)) > 0.9


def test_sample_walks_on_the_card_is_proper(dev):
    from repro_torch.core import walks
    g, _ = graphs.ring_of_cliques(3, 4, device=dev)
    inc = lap.build_edge_incidence(g)
    assert inc.nbrs.device.type == "cuda"
    wb = walks.sample_walks(torch.Generator(device=dev).manual_seed(4), inc,
                            5000, 3)
    assert bool(torch.all(wb.alpha != 0.0))
    assert set(wb.alpha[:, 1].unique().tolist()) <= {-1.0, 1.0, 2.0}
    assert bool(torch.all(wb.logp[:, 1] <= wb.logp[:, 0] + 1e-6))
    log_pmin = -2 * np.log(inc.deg_star_inc) - np.log(g.num_edges)
    assert bool(torch.all(wb.logp[:, 1] >= log_pmin - 1e-5))
    first, nxt = wb.edge_at[:, 0].long(), wb.edge_at[:, 1].long()
    listed = (inc.nbrs[first] == nxt[:, None]) & (
        torch.arange(inc.nbrs.shape[1], device=dev)[None, :]
        < inc.deg[first][:, None])
    assert bool(listed.any(dim=1).all())  # never the self-padding


def test_walks_spectral_cluster_on_the_card(dev):
    g, truth = graphs.clique_graph(160, 4, seed=3, device=dev)
    cfg = ClusteringConfig(
        num_clusters=4, estimation="walks", degree=251, num_walkers=4096,
        solver=SolverConfig(method="mu_eg", lr=0.05, steps=600, eval_every=100))
    reset_launch_counts()
    labels, info = spectral_cluster(g, cfg)
    counts = launch_counts()
    assert info["plan"] is None and counts["edge_spmm"] == 0
    assert counts["gram2k"] == counts["panel_mix"] == 600
    assert float(cluster_agreement(labels, truth, 4)) > 0.9


# ---------------------------------------------------------------------------
# streaming state (stream/) and the dilated operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [96, 8192])
def test_dilated_operator_at_two_c_matches_plain(dev, n):
    """Captured dilated operators at two c over one store (K1/K2 take alpha
    by value, so c is fixed per operator): two different answers, each
    the plain loop's at its c, each replay bitwise its eager run."""
    from repro_torch.stream import graph_store as gs
    g = _graph(11, n, 4 * n, dev, capacity=8 * n)
    store = gs.from_edge_list(g)
    store, rho = gs.spectral_radius_upper_bound(store)
    fused = gs.fused_step(store)
    name = "edge_spmm" if n <= backend.ONE_HOT_NODE_LIMIT else "edge_spmm_nb"
    v = _panel(50, n, 6, dev)
    outs = []
    for c in (0.3 / float(rho), 0.6 / float(rho)):
        op = operators.dilated_step_operator(fused, c, 7, capture=True)
        assert isinstance(op, operators.CapturedOperator)
        eager = operators.dilated_step_operator(fused, c, 7)(v)
        plain = operators.dilated_operator_arrays(
            store.src, store.dst, store.weight, c, 7, backend="segment")(v)
        assert _rel_err(eager, plain) <= REL
        reset_launch_counts()
        got = op(v)
        assert launch_counts()[name] == 7
        torch.testing.assert_close(got, eager, atol=0, rtol=0)
        torch.testing.assert_close(op(v), eager, atol=0, rtol=0)
        assert len(op.graphs) == 1
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    dil = operators.dilated_operator_arrays(store.src, store.dst, store.weight,
                                            0.6 / float(rho), 7, backend="kernel")
    torch.testing.assert_close(dil(v), outs[1], atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["set", "add"])
def test_apply_edge_batch_on_the_card_is_the_cpu_result(dev, mode):
    from repro_torch.stream import graph_store as gs
    rng = np.random.default_rng(12)
    n, cap = 5000, 1 << 14
    edges = rng.integers(0, n, size=(9000, 2))
    edges = np.concatenate([edges[edges[:, 0] != edges[:, 1]], edges[:3]])  # dups
    g_cpu = lap.make_edge_list(edges, n, device="cpu")
    stores = {"cpu": gs.from_edge_list(g_cpu, capacity=cap),
              "cuda": gs.from_edge_list(lap.make_edge_list(edges, n, device=dev),
                                        capacity=cap)}
    for step in range(6):
        pairs = np.concatenate([edges[rng.choice(len(edges), 500)],
                                rng.integers(0, n, size=(3000 * step, 2))])
        ws = rng.choice([0.0, 1.0, 2.5, -1.0], size=len(pairs))
        out = {}
        for d, st in stores.items():
            b = gs.coalesce_batch(pairs, np.abs(ws) if mode == "set" else ws,
                                  mode=mode, pad_to=16384, device=d)
            out[d] = gs.apply_edge_batch(st, b, mode=mode)
        (_, dw_cpu, stats_cpu), (_, dw_card, stats_card) = out["cpu"], out["cuda"]
        for want, got in zip((dw_cpu, *stats_cpu), (dw_card, *stats_card)):
            torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)
        stores = {d: o[0] for d, o in out.items()}
        for f in ("src", "dst", "weight"):
            torch.testing.assert_close(getattr(stores["cuda"], f).cpu(),
                                       getattr(stores["cpu"], f), atol=0, rtol=0)
    assert int(out["cuda"][2].dropped) > 0  # the last batches overflow


def test_first_order_update_on_the_card_matches_cpu(dev):
    from repro_torch.stream import graph_store as gs
    from repro_torch.stream import updates
    g = _graph(13, 6000, 30000, dev, capacity=65536)
    store = gs.from_edge_list(g)
    v = solvers.init_state(torch.Generator(device=dev).manual_seed(3), 6000, 8).v
    reset_launch_counts()
    est = updates.anchor_estimate(gs.fused_step(store), v)
    assert launch_counts()["edge_spmm_nb"] == 1
    est_cpu = updates.anchor_estimate_arrays(
        store.src.cpu(), store.dst.cpu(), store.weight.cpu(), v.cpu())
    for a, b in zip(est, est_cpu):
        assert _rel_err(a, b.to(dev)) <= REL
    rng = np.random.default_rng(14)
    for _ in range(3):
        src = rng.integers(0, 5999, 256)
        dst = src + rng.integers(1, 6000 - src)
        dw = (rng.normal(size=256) * 1e-3).astype(np.float32)
        args = [torch.from_numpy(x) for x in (src, dst, dw)]
        est = updates.first_order_update(est, *(a.to(dev) for a in args))
        est_cpu = updates.first_order_update(est_cpu, *args)
        for a, b in zip(est, est_cpu):
            assert float((a.cpu() - b).abs().max()) <= 1e-5


def test_warm_reconverge_on_the_card_runs_k2_k3_k4(dev):
    from repro_torch.stream import graph_store as gs
    from repro_torch.stream import warm
    g, _ = graphs.sparse_sbm_graph(6000, 6, avg_degree_in=10, avg_degree_out=1,
                                   seed=0, device=dev)
    store, rho = gs.spectral_radius_upper_bound(gs.from_edge_list(g))
    op = operators.dilated_step_operator(gs.fused_step(store),
                                         8.0 / float(rho) / 15, 15, capture=True)
    cfg = warm.WarmConfig(tol=5e-3, chunk=10, max_steps=3000, lr=0.3)
    reset_launch_counts()
    state, info = warm.reconverge(torch.Generator(device=dev).manual_seed(0), op,
                                  6000, 6, cfg)
    counts = launch_counts()
    assert info["residual"] <= cfg.tol and not info["warm"]
    assert counts["gram2k"] == counts["panel_mix"] == info["iterations"]
    assert counts["edge_spmm_nb"] == 15 * (info["iterations"]
                                           + info["iterations"] // 10 + 1)
    _, info2 = warm.reconverge(torch.Generator(device=dev).manual_seed(1), op,
                               6000, 6, cfg, v_prev=state.v)
    assert info2["warm"] and info2["iterations"] < info["iterations"]


# ---------------------------------------------------------------------------
# the streaming service's batched tick (core/program.py, stream/service.py)
# ---------------------------------------------------------------------------

def _tick_group(dev, n: int, cap: int):
    """Four members of node capacity n in edge capacity cap, one of them a
    power-law graph with hub rows, each with its own c and lr."""
    from repro_torch.stream import graph_store as gs
    members = [_graph(60 + i, n, 3 * n, dev) for i in range(3)]
    members.insert(2, graphs.power_law_graph(n, avg_degree=6, alpha=2.0,
                                             seed=3, device=dev))
    stores = [gs.from_edge_list(g, capacity=cap) for g in members]
    rhos = [float(gs.spectral_radius_upper_bound(s)[1]) for s in stores]
    cs = [(1.5 + i) / r / 5 for i, r in enumerate(rhos)]
    return stores, cs, [0.2, 0.3, 0.4, 0.5]


@pytest.mark.parametrize("n", [1024, 4096])
def test_kernel_group_tick_matches_per_member_runs(dev, n):
    """One group tick (K1 at 4 x 1024 rows, K2 at 4 x 4096) == each
    member's own dilated operator and run_chunk on the card, from the
    same panels at the same c and lr, with per-member chunk budgets; the
    replay repeats bitwise, and the segment tick (the plain twins) agrees."""
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gs
    stores, cs, lrs = _tick_group(dev, n, 8 * n)
    hubs = es_ops.build_edge_rows(stores[2].src, stores[2].dst,
                                  stores[2].weight, n).hub_rows
    assert int((hubs < n).sum()) > 0  # the power-law member has hub rows
    vs = torch.stack([_panel(70 + i, n, 6, dev) for i in range(4)])
    vs = torch.stack([solvers.init_from_panel(v).v for v in vs])
    chunks = (2, 1, 2, 1)
    rows = [gs.edge_rows(s) for s in stores]
    sched = program.StepSchedule(degree=5, steps=3, backend="kernel")
    prog = program.build_tick_program(sched, dev)
    first = prog(rows, cs, vs, lrs, chunks)
    reset_launch_counts()
    second = prog(rows, cs, vs, lrs, chunks)
    counts = launch_counts()
    third = prog(rows, cs, vs, lrs, chunks)
    assert prog.captures == 1 and prog.layout_fills == 1
    name = "edge_spmm" if 4 * n <= backend.ONE_HOT_NODE_LIMIT else "edge_spmm_nb"
    assert counts[name] == 5 * (3 * 2 + 1)
    assert counts["gram2k"] == counts["panel_mix"] == 4 * 3 * 2
    for a, b in zip(second, third):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(first, second):
        assert _rel_err(b, a) <= REL
    seg = program.build_tick_program(
        dataclasses.replace(sched, backend="segment"), dev)(rows, cs, vs, lrs,
                                                            chunks)
    for a, b in zip(second, seg):
        assert _rel_err(a, b) <= REL
    step_fn = solvers.make_step_fn("mu_eg", "kernel", dev)
    for i, st in enumerate(stores):
        op = operators.dilated_step_operator(gs.fused_step(st), cs[i], 5,
                                             capture=True)
        state = solvers.SolverState(v=vs[i].clone(),
                                    step=torch.zeros((), dtype=torch.int32,
                                                     device=dev))
        state, res = program.run_chunk(op, step_fn, state, lrs[i],
                                       3 * chunks[i])
        assert _rel_err(second[0][i], state.v) <= REL, i
        assert abs(float(second[1][i]) - float(res)) <= REL, i


def test_kernel_tick_refilled_between_groups_replays_their_answers(dev):
    """One captured program serving two groups in turn (as two
    sub-batches of one occupancy do): every call refills the layout in
    place, captures nothing, and repeats bitwise the answer the program
    gave that group before, which the segment tick confirms."""
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gs
    stores, cs, lrs = _tick_group(dev, 2048, 8 * 2048)
    rows = [gs.edge_rows(s) for s in stores]
    vs = torch.stack([solvers.init_from_panel(_panel(80 + i, 2048, 6, dev)).v
                      for i in range(2)])
    groups = [([rows[0], rows[2]], [cs[0], cs[2]]),
              ([rows[1], rows[3]], [cs[1], cs[3]])]
    sched = program.StepSchedule(degree=5, steps=3, backend="kernel")
    prog = program.build_tick_program(sched, dev)
    seg = program.build_tick_program(
        dataclasses.replace(sched, backend="segment"), dev)
    prog(*groups[0], vs, lrs[:2], (2, 1))  # eager run and capture
    answers = {}
    for i in (0, 1, 0, 1):
        out = prog(*groups[i], vs, lrs[:2], (2, 1))
        if i in answers:
            for a, b in zip(out, answers[i]):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        else:
            answers[i] = out
            for a, b in zip(out, seg(*groups[i], vs, lrs[:2], (2, 1))):
                assert _rel_err(a, b) <= REL, i
    assert prog.captures == 1 and prog.layout_fills == 4


def test_service_captures_once_across_updates_replans_and_membership(dev):
    """A kernel-path service at occupancy 4: an apply_updates, a re-plan
    (new c and lr at the same degree) and a member leaving and
    re-entering at the same occupancy each refill the group's layout
    once and capture nothing new."""
    from repro_torch.stream.service import ServiceConfig, StreamingService
    cfg = ServiceConfig(k=4, num_clusters=3, degree=7, steps_per_tick=5,
                        tol=1e-9, probe_spectrum=False,
                        tick_schedule="round_robin")
    svc = StreamingService(cfg, device=dev)
    for i in range(4):
        g, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=i, device=dev)
        svc.add_graph(f"g{i}", g, num_clusters=3, edge_capacity=1024)
    svc.tick()
    svc.tick()

    def captures():
        return (svc.compile_count,
                sum(p.captures for p in svc._compiled.values()))
    assert captures() == (1, 1) and svc.layout_fills == 1
    svc.apply_updates("g1", [[0, 30], [2, 45]], [1.0, 1.0])
    svc.tick()
    assert captures() == (1, 1) and svc.layout_fills == 2
    sess = svc._sessions["g2"]
    c_before = sess.plan.scale
    svc._plan_session(sess, 0.8 * sess.rho, sess.rho_ub)
    assert sess.plan.scale != c_before and sess.plan.degree == 7
    out = svc.tick()
    assert captures() == (1, 1) and np.isfinite(out["g2"])
    assert svc.layout_fills == 3
    panel = svc.evict("g3")["panel"]
    g3, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=3, device=dev)
    svc.add_graph("g3", g3, num_clusters=3, edge_capacity=1024,
                  resume_panel=panel)
    out = svc.tick()
    assert captures() == (1, 1) and svc.layout_fills == 4
    assert all(np.isfinite(r) for r in out.values()) and len(out) == 4
    assert svc.tick_invocations == 5


# ---------------------------------------------------------------------------
# the serving layer on the card
# ---------------------------------------------------------------------------

def _serve_cfg():
    from repro_torch.serve import ServerConfig
    from repro_torch.stream.service import ServiceConfig
    return ServerConfig(service=ServiceConfig(
        k=4, num_clusters=3, degree=7, steps_per_tick=5, tol=1e-9,
        probe_spectrum=False, tick_schedule="round_robin"))


def _serve_admit(srv, count, n=1 << 14):
    for i in range(count):
        g, _ = graphs.sparse_sbm_graph(n, 4, 8.0, 0.5, seed=i, device="cpu")
        srv.admit(f"s{i}", torch.stack([g.src, g.dst], 1), n,
                  weights=g.weight, num_clusters=3)


def test_labels_run_while_the_engine_thread_captures(dev, monkeypatch):
    """A request thread labels (k-means on the card, allocations, a copy
    to the host) INSIDE the first tick's capture of both graphs: the
    capture waits until the request thread has labelled every session.
    Neither side raises, the program captures once, and the engine
    thread lives until stop()."""
    import threading
    from repro_torch.core import operators
    from repro_torch.serve import Server
    srv = Server(_serve_cfg(), device=dev)
    _serve_admit(srv, 2)
    inside, labelled, errors, served = (threading.Event(), threading.Event(),
                                        [], [])
    real_capture = operators.capture_graph

    def capture_graph(fn):
        def fn_after_queries():
            inside.set()
            if not labelled.wait(timeout=120):
                raise AssertionError("the request thread never labelled")
            return fn()
        return real_capture(fn_after_queries)

    monkeypatch.setattr(operators, "capture_graph", capture_graph)

    def querier():
        try:
            if not inside.wait(timeout=120):
                raise AssertionError("no capture started")
            served.extend(srv.labels(sid) for sid in ("s0", "s1"))
        except Exception as e:
            errors.append(e)
        finally:
            labelled.set()

    thread = threading.Thread(target=querier)
    thread.start()
    srv.start()
    thread.join(timeout=180)
    assert not thread.is_alive() and not errors, errors
    assert srv.flush(timeout=120) and srv.running
    deadline = time.monotonic() + 120
    while srv.metrics.counter("ticks") < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.running and srv.metrics.counter("ticks") >= 3
    srv.stop()
    progs = list(srv.service._compiled.values())
    assert len(progs) == 1 and progs[0].captures == 1
    assert [r["version"] for r in served] == [1, 1]
    for r in served:
        assert r["labels"].shape == (1 << 14,) and r["labels"].max() < 3


def test_labels_of_one_version_are_bitwise_equal_across_threads(dev):
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serve import Server
    srv = Server(_serve_cfg(), device=dev)
    _serve_admit(srv, 2)
    for _ in range(3):
        srv.step()
    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(srv.labels, f"s{i % 2}") for i in range(8)]
        outs = [f.result(timeout=120) for f in futures]
    for i, out in enumerate(outs):
        ref = outs[i % 2]
        assert out["version"] == ref["version"] == srv.results.version(
            f"s{i % 2}")
        np.testing.assert_array_equal(out["labels"], ref["labels"])
    again = srv.labels("s0")
    np.testing.assert_array_equal(again["labels"], outs[0]["labels"])


def test_http_shell_serves_on_the_card(dev):
    import json
    import os
    import select
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--num-clusters", "3",
         "--k", "4", "--degree", "7", "--steps-per-tick", "10"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root)

    def req(base, path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(base + path, data=data, method=method,
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        ready, _, _ = select.select([proc.stdout], [], [], 180)
        assert ready, "no banner within 180 s"
        banner = proc.stdout.readline().strip()
        assert banner.startswith("SERVING "), banner
        base = "http://127.0.0.1:" + dict(
            kv.split("=") for kv in banner.split()[1:])["port"]
        g, truth = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=0,
                                    device="cpu")
        out = req(base, "/v1/sessions/c", "POST",
                  {"edges": torch.stack([g.src, g.dst], 1).tolist(),
                   "num_nodes": 60, "weights": g.weight.tolist(),
                   "num_clusters": 3})
        assert out["version"] == 1
        out = req(base, "/v1/sessions/c/labels")
        assert len(out["labels"]) == 60
        launches = req(base, "/metrics")["engine"]["kernel_launches"]
        assert launches["edge_spmm"] > 0  # the admission probe on K1
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        assert stdout.strip().splitlines()[-1] == "STOPPED"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


# ---------------------------------------------------------------------------
# the edge-sharded paths: 2 ranks on this card over gloo (NCCL refuses two
# ranks on one GPU); the rank bodies live in tests/torch_dist_ranks.py
# ---------------------------------------------------------------------------

def test_sharded_k2_series_on_two_ranks_matches_one_process(dev):
    import torch_dist_ranks as ranks
    from repro_torch import parallel

    edges, w = ranks.rand_edges(7, 8192, 60000)
    v = ranks.panel(8, 8192, 10)
    g = lap.make_edge_list(edges, 8192, weights=w, device=dev)
    scale = 4.0 / float(lap.spectral_radius_upper_bound(g))
    want = operators.edge_series_operator(
        g, limit_neg_exp(15, scale=scale), backend="kernel")(
            torch.from_numpy(v).to(dev))
    results = parallel.run_ranks(2, ranks.card_series, edges, w, 8192, v, 15,
                                 scale, device=dev, timeout=300.0)
    got = [r.value for r in results]
    assert parallel.bitwise_equal(got)
    assert _rel_err(torch.from_numpy(got[0]).to(dev), want) <= REL
    for r in results:  # one K2 launch per factor on each rank's shard
        assert r.launches["edge_spmm_nb"] == 15


def test_sharded_kernel_tick_on_two_ranks_matches_one_process(dev):
    import torch_dist_ranks as ranks
    from repro_torch import parallel
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gs

    graphs_np = [ranks.rand_edges(20 + i, 1024, 6000) for i in range(2)]
    cs, lrs, chunks = [0.01, 0.02], [0.3, 0.2], (1, 2)
    vs = np.stack([ranks.panel(30 + i, 1024, 6) for i in range(2)])
    stores = [gs.from_edge_list(lap.make_edge_list(e, 1024, weights=w_,
                                                   device=dev), capacity=8192)
              for e, w_ in graphs_np]
    prog = program.build_tick_program(
        program.StepSchedule(degree=7, steps=3, backend="kernel"), dev)
    want = prog([gs.edge_rows(st) for st in stores], cs,
                torch.from_numpy(vs).to(dev), lrs, chunks)
    results = parallel.run_ranks(2, ranks.card_tick, graphs_np, 1024, 8192,
                                 cs, vs, lrs, chunks, 7, 3, device=dev,
                                 timeout=300.0)
    for j in range(2):
        got = [r.value[j] for r in results]
        assert parallel.bitwise_equal(got)
        assert _rel_err(torch.from_numpy(got[0]).to(dev), want[j]) <= REL
    assert all(r.value[2] == 0 for r in results)  # eager: nothing captured
    for r in results:  # K1 (2 x 1024 rows) per factor, K3/K4 per member
        assert r.launches["edge_spmm"] == 7 * (3 * 2 + 1)
        assert r.launches["gram2k"] == r.launches["panel_mix"] == 3 * 2 * 2


def test_panel_sharded_kernel_tick_on_two_ranks_matches_one_process(dev):
    import torch_dist_ranks as ranks
    from repro_torch import parallel
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gs

    graphs_np = [ranks.rand_edges(20 + i, 1024, 6000) for i in range(2)]
    cs, lrs, chunks = [0.01, 0.02], [0.3, 0.2], (1, 2)
    vs = np.stack([ranks.panel(30 + i, 1024, 6) for i in range(2)])
    stores = [gs.from_edge_list(lap.make_edge_list(e, 1024, weights=w_,
                                                   device=dev), capacity=8192)
              for e, w_ in graphs_np]
    prog = program.build_tick_program(
        program.StepSchedule(degree=7, steps=3, backend="kernel"), dev)
    want = prog([gs.edge_rows(st) for st in stores], cs,
                torch.from_numpy(vs).to(dev), lrs, chunks)
    results = parallel.run_ranks(2, ranks.card_model_tick, graphs_np, 1024,
                                 8192, cs, vs, lrs, chunks, 7, 3, 128,
                                 device=dev, timeout=300.0)
    for j in range(2):
        got = [r.value[j] for r in results]
        assert parallel.bitwise_equal(got)
        assert _rel_err(torch.from_numpy(got[0]).to(dev), want[j]) <= REL
    for r in results:
        assert r.value[2] == 0  # eager: nothing captured
        assert r.value[3] == (6 * 6 + 7, 6)  # per step 6 plain + 1 fused
        # K2 on the owned rows per factor, K3 per member per step, K4 per
        # member per step on the replicated panel
        assert r.launches["edge_spmm_nb"] == 7 * (3 * 2 + 1)
        assert r.launches["gram2k"] == r.launches["panel_mix"] == 3 * 2 * 2


# --------------------------------------------------------------------------
# The LM substrate's SSM, hybrid and enc-dec families (no kernel of the
# port runs on them): the card against the CPU from one set of weights
# --------------------------------------------------------------------------

LM_F32_TOL, LM_DECODE_F32_TOL = 1e-4, 5e-3


def _lm_smoke(arch: str, seed: int = 0):
    """smoke_config(arch)'s model on the CPU and a copy on the card, and
    a prompt (with whisper's stub frames) of 2 x 12 on the CPU."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import Model
    from repro_torch.models.frontends import synthetic_frontend

    cfg = smoke_config(get_arch(arch))
    gen = torch.Generator().manual_seed(seed)
    cpu = Model(cfg, "cpu", gen)
    card = Model(cfg, "cpu", torch.Generator().manual_seed(seed))
    card.to("cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=gen, dtype=torch.int32)}
    batch.update(synthetic_frontend(gen, cfg, 2))
    return cfg, cpu, card, batch


def test_ssd_on_the_card_matches_cpu(dev):
    """The chunked SSD scan and a mamba2 smoke layer's ssm_train at a
    ragged length (45 = 2 chunks of 16 and 13), card against CPU (f32)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import ssm

    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 45, 4, 8, 16
    args = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, p), (b, s, h), (b, s, n), (b, s, n))]
    args[1] = -0.2 * np.abs(args[1])
    want = ssm._ssd_chunked(*map(torch.from_numpy, args), 16)
    got = ssm._ssd_chunked(*(torch.from_numpy(a).to(dev) for a in args), 16)
    for g, w in zip(got, want):
        assert _rel_err(g.cpu(), w) <= REL
    cfg = smoke_config(get_arch("mamba2-2.7b"))
    params = ssm.init_ssm(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(0.3 * rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = ssm.ssm_train(params, cfg, x)
        got = ssm.ssm_train(params.to(dev), cfg, x.to(dev))
    assert float((got.cpu() - want).abs().max()) <= LM_F32_TOL


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
def test_lm_smoke_on_the_card_matches_cpu(dev, arch, monkeypatch):
    """A smoke hybrid and a smoke whisper in f32 (COMPUTE_DTYPE patched):
    prefill logits 1e-4, four decode steps fed the CPU's argmax 5e-3 (the
    bf16 caches round), train_loss 1e-4, card against CPU."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg, cpu, card, batch = _lm_smoke(arch)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        want, st_cpu = cpu.prefill(batch, max_seq=16)
        got, st_card = card.prefill(on_card, max_seq=16)
        assert float((got.cpu() - want).abs().max()) <= LM_F32_TOL
        for _ in range(4):
            tok = want.argmax(-1, keepdim=True)
            want, _ = cpu.decode_step(st_cpu, tok)
            got, _ = card.decode_step(st_card, tok.to(dev))
            assert float((got.cpu() - want).abs().max()) <= LM_DECODE_F32_TOL
        labels = torch.roll(batch["tokens"], -1, dims=1)
        loss_cpu = float(cpu.train_loss({**batch, "labels": labels})[0])
        loss_card = float(card.train_loss({**on_card,
                                           "labels": labels.to(dev)})[0])
    assert abs(loss_card - loss_cpu) <= LM_F32_TOL


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "whisper-small"])
def test_lm_repeated_prefill_is_bitwise(dev, arch):
    """Two bf16 prefills of one prompt on the card give the same bits."""
    _, _, card, batch = _lm_smoke(arch)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    first, _ = card.prefill(on_card)
    second, _ = card.prefill(on_card)
    assert torch.equal(first, second)


# --------------------------------------------------------------------------
# training (launch/train.py, launch/dryrun.py, train/)
# --------------------------------------------------------------------------

LM_GRAD_TOL = 1e-5  # of each leaf's largest |g|


def _train_batch(cfg, seed: int = 1, b: int = 2, s: int = 32):
    from repro_torch.models.frontends import synthetic_frontend

    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
            **synthetic_frontend(gen, cfg, b)}


def _grads_close(got: dict, want: dict) -> float:
    """The largest |got - want| of a leaf over that leaf's largest |want|."""
    worst = 0.0
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        diff = got[name].detach().cpu() - w.detach().cpu()
        worst = max(worst, float(diff.abs().max()) / scale)
    return worst


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_lm_train_step_on_the_card_matches_cpu(dev, arch, monkeypatch):
    """smoke_config in f32 (COMPUTE_DTYPE patched): train_loss and its
    gradients (1e-4; 1e-5 of each leaf's largest |g|), then two steps of
    build_train_step (losses 1e-4, gradient norms 1e-4 of their size),
    card against CPU from one set of weights.  Parameters after a step
    are not compared: Adam's first updates are sign-like."""
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    from repro_torch.train import optimizer as opt

    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg, cpu, card, _ = _lm_smoke(arch)
    batch = _train_batch(cfg)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    loss_cpu, _ = cpu.train_loss(batch)
    loss_card, _ = card.train_loss(on_card)
    loss_cpu.backward()
    loss_card.backward()
    assert abs(float(loss_card.detach()) - float(loss_cpu.detach())) <= LM_F32_TOL
    assert _grads_close({k: p.grad for k, p in card.named_parameters()},
                        {k: p.grad for k, p in cpu.named_parameters()}) <= LM_GRAD_TOL
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    step = dryrun.build_train_step(cfg, ocfg)
    states = [opt.init(ocfg, dict(m.named_parameters())) for m in (cpu, card)]
    for i in range(2):
        b2 = _train_batch(cfg, seed=10 + i)
        _, states[0], want = step(cpu, states[0], b2)
        _, states[1], got = step(card, states[1],
                                 {k: v.to(dev) for k, v in b2.items()})
        assert abs(float(got["loss"]) - float(want["loss"])) <= LM_F32_TOL, i
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= (
            LM_F32_TOL * float(want["grad_norm"])), i


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b",
                                  "whisper-small"])
def test_remat_policies_on_the_card(dev, arch):
    """bf16 train_loss under "none", "full" and "dots" on the card: the
    loss bitwise, the gradients within 1e-5 of each leaf's largest |g|
    (the backward's scatter-adds may order their sums differently from
    run to run)."""
    import copy

    cfg, _, card, _ = _lm_smoke(arch)
    batch = {k: v.to(dev) for k, v in _train_batch(cfg).items()}
    runs = {}
    for policy in ("none", "full", "dots"):
        model = copy.deepcopy(card)
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        loss, _ = model.train_loss(batch)
        loss.backward()
        runs[policy] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()})
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0]), policy
        assert _grads_close(runs[policy][1], runs["none"][1]) <= LM_GRAD_TOL, policy


def test_sped_training_resumes_bitwise_on_the_card(dev, tmp_path):
    """train_sped on the card (K1 once per drawn factor): resumed from its
    step-200 checkpoint it ends bitwise where the uninterrupted run ends
    (K1 and the seeded CUDA generator repeat bitwise)."""
    from repro_torch.launch import train

    args = ["--mode", "sped", "--steps", "250", "--nodes", "150",
            "--clusters", "3", "--ckpt-dir", str(tmp_path / "ck")]
    reset_launch_counts()
    full = train.train_sped(train.parse_args(args), dev)
    assert launch_counts()["edge_spmm"] == 250 * 51
    resumed = train.train_sped(train.parse_args(args), dev)
    assert resumed.steps == 50 and torch.equal(resumed.v, full.v)
    assert full.accuracy == 1.0


def test_context_parallel_decode_on_two_ranks_matches_one_process(dev):
    """qwen3's smoke model in f32 compute on a (1, 2) ("data", "model")
    mesh of 2 gloo ranks on this card: each rank holds half of every KV
    cache's positions and decodes context parallel (three all_reduces a
    layer); the prefill and 8 decode steps equal the one-process run's
    within 1e-4 (the order of the softmax's sums differs)."""
    import torch_dist_ranks as ranks
    from repro_torch import convert, parallel
    from repro_torch.models import Model, layers

    cfg = ranks.lm_config("qwen3-4b")
    tree = convert.lm_params_to_numpy(
        Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    steps, max_seq = 8, 20
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        model = convert.lm_params_from_numpy(cfg, tree, device=dev)
        logits, state = model.prefill({"tokens": torch.from_numpy(tokens).to(dev)},
                                      max_seq=max_seq)
        want = [logits]
        for _ in range(steps):
            logits, state = model.decode_step(
                state, want[-1].argmax(-1, keepdim=True).int())
            want.append(logits)
    finally:
        layers.COMPUTE_DTYPE = old
    results = parallel.run_ranks(2, ranks.card_cp_decode, tree, tokens, max_seq,
                                 steps, device=dev, timeout=300.0)
    for r in results:
        got = torch.from_numpy(r.value).to(dev)
        assert _rel_err(got, torch.stack(want)) <= 1e-4


@pytest.mark.parametrize("max_seq, dtype", [(16, "float32"), (16, "bfloat16"),
                                            (15, "float32")])
def test_serving_heads_exchange_on_the_card_is_the_cpu_result(dev, max_seq,
                                                              dtype):
    """The tensor-parallel prefill's heads -> positions exchange
    (``attention.prefill_cache``) on 2 gloo ranks of this card: CUDA
    tensors through gloo fill each rank's cache bitwise as the same
    exchange of CPU tensors does, by one all_to_all into a
    context-parallel cache and one all_gather into a whole cache (a
    sequence that does not divide)."""
    import torch_dist_ranks as ranks
    from repro_torch import parallel

    results = parallel.run_ranks(2, ranks.card_heads_exchange, max_seq, dtype,
                                 device=dev, timeout=300.0)
    cp = max_seq % 2 == 0
    for r in results:
        card, cpu = r.value["cuda"], r.value["cpu"]
        assert card["length"] == cpu["length"] == 13
        assert card["calls"]["all_to_all"] == int(cp)
        assert card["calls"]["all_gather"] == int(not cp)
        for f in ("k", "v"):
            assert np.array_equal(np.asarray(card[f]), np.asarray(cpu[f])), f


def test_split_mla_cache_decode_on_the_card_is_the_cpu_result(dev):
    """deepseek's smoke model in f32 compute, in the serving layout of a
    (1, 2) ("data", "model") mesh of 2 gloo ranks on this card: each
    rank holds half of every MLA latent cache's positions, gathers each
    token's absorbed queries and combines the softmax over "model" (one
    all_gather and four all_reduces a layer).  The prefill and 4 decode
    steps equal the same ranks' CPU run within 1e-5, and each rank's
    cache holds the same bytes on the card as on the CPU."""
    import torch_dist_ranks as ranks
    from repro_torch import convert, parallel
    from repro_torch.models import Model

    cfg = ranks.lm_config("deepseek-v2-236b")
    tree = convert.lm_params_to_numpy(
        Model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    fed = [rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
           for _ in range(4)]
    max_seq = 16
    results = parallel.run_ranks(2, ranks.card_mla_decode, tree, tokens, fed,
                                 max_seq, device=dev, timeout=300.0)
    for r in results:
        card, cpu = r.value["cuda"], r.value["cpu"]
        assert card["split"] and cpu["split"]
        assert card["positions"] == cpu["positions"] == max_seq // 2
        assert card["cache_bytes"] == cpu["cache_bytes"] == (
            cfg.num_layers * 2 * (max_seq // 2) * 2
            * (cfg.kv_lora_rank + cfg.qk_rope_head_dim))
        # a step: the embedding's sum; per layer the queries' gather, the
        # softmax's three all_reduces, wo's sum and the MoE's combine (one
        # data rank: no aux mean, no rows gathered); the logits' gather
        assert card["calls"]["all_gather"] == cfg.num_layers + 1
        assert card["calls"]["all_reduce"] == 1 + 5 * cfg.num_layers
        assert _rel_err(torch.from_numpy(card["logits"]).to(dev),
                        torch.from_numpy(cpu["logits"]).to(dev)) <= REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_heads_exchange_on_the_card_is_the_cpu_result(dev, dtype):
    """The head-sliced Mamba2 mixer's collectives on 2 gloo ranks of this
    card: the [z | x] exchange of each rank's column block into its heads
    of z and x, its inverse exchange backward, and the norm's statistic
    summed over "model" with its SUM backward give on CUDA tensors
    exactly the bits the same collectives give on CPU tensors."""
    import torch_dist_ranks as ranks
    from repro_torch import parallel

    results = parallel.run_ranks(2, ranks.card_ssm_exchange, dtype,
                                 device=dev, timeout=300.0)
    for j, r in enumerate(results):
        card, cpu = r.value["cuda"], r.value["cpu"]
        for got in (card, cpu):
            assert got["calls"]["all_to_all"] == 2
            assert got["calls"]["all_reduce"] == 2
        for f in ("z", "x", "dzx", "total", "dss"):
            assert np.array_equal(np.asarray(card[f]), np.asarray(cpu[f])), (j, f)
    # rank 1's exchange gave it x's second block, from rank 1's columns
    assert not np.array_equal(np.asarray(results[0].value["cpu"]["x"]),
                              np.asarray(results[1].value["cpu"]["x"]))


def test_data_parallel_step_on_two_ranks_matches_one_process(dev):
    """granite's smoke model in f32 compute on a (2, 1) ("data", "model")
    mesh of 2 gloo ranks on this card: 2 data-parallel steps with ZeRO-1
    moments against one process on the card computing each half-batch's
    gradient, averaging them and applying: losses within 1e-4, the
    parameters within 1e-5 of each leaf's largest magnitude, the ranks'
    parameters bitwise equal.  Adam's eps is its default 1e-8, whose
    1/eps slope at a gradient of 0 turns a last-bit difference there
    into a step of up to the learning rate: the bar holds only where the
    data-parallel step gives the halves' gradients to the last bit, the
    same kernels on the same rows (the CPU tests against the JAX package
    take eps 1e-3 for this reason)."""
    import torch_dist_ranks as ranks
    from repro_torch import convert, parallel
    from repro_torch.models import Model, layers
    from repro_torch.train import optimizer as opt_lib

    cfg = ranks.lm_config("granite-moe-1b-a400m")
    tree = convert.lm_params_to_numpy(
        Model(cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    fields = dict(lr=1e-3, warmup_steps=0, total_steps=2)
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        model = convert.lm_params_from_numpy(cfg, tree, device=dev)
        params = dict(model.named_parameters())
        ocfg = opt_lib.OptConfig(**fields)
        state = opt_lib.init(ocfg, params)
        want_losses = []
        for batch in batches:
            halves = []
            for h in (slice(0, 2), slice(2, 4)):
                loss, _ = model.train_loss({k: torch.from_numpy(v[h]).to(dev)
                                            for k, v in batch.items()})
                loss.backward()
                halves.append((float(loss.detach()),
                               {k: p.grad for k, p in params.items()}))
                model.zero_grad(set_to_none=True)
            grads = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in params}
            _, state, _ = opt_lib.apply(ocfg, state, params, grads)
            want_losses.append((halves[0][0] + halves[1][0]) / 2)
    finally:
        layers.COMPUTE_DTYPE = saved
    results = parallel.run_ranks(2, ranks.card_train_dp, tree, batches, fields,
                                 device=dev, timeout=300.0)
    for r in results:
        losses, got = r.value
        assert np.abs(losses - np.array(want_losses)).max() <= 1e-4
        for k, p in params.items():
            w = p.detach().cpu().numpy()
            assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k
    for k in params:
        assert parallel.bitwise_equal([r.value[1][k] for r in results]), k


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_tensor_parallel_step_on_four_ranks_matches_one_process(dev, arch):
    """The smoke model in f32 compute in the training layout of a (2, 2)
    ("data", "model") mesh of 4 gloo ranks on this card (fsdp=True: heads,
    hidden dims, experts and the vocabulary over "model", d_model over
    "data"): 2 steps against one process on the card computing each
    half-batch's gradient, averaging them and applying: losses within
    1e-4, the parameters gathered whole within 1e-5 of each leaf's
    largest magnitude and bitwise equal on the ranks.  Adam's eps is
    1e-3: the model ranks' partial sums differ from one process's in the
    last bits, which eps 1e-8's slope at a gradient of 0 would turn into
    steps of up to the learning rate."""
    import torch_dist_ranks as ranks
    from repro_torch import convert, parallel
    from repro_torch.models import Model, layers
    from repro_torch.train import optimizer as opt_lib

    cfg = ranks.lm_config(arch)
    tree = convert.lm_params_to_numpy(
        Model(cfg, device="cpu", generator=torch.Generator().manual_seed(6)))
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    fields = dict(lr=1e-3, warmup_steps=0, total_steps=2, eps=1e-3)
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        model = convert.lm_params_from_numpy(cfg, tree, device=dev)
        params = dict(model.named_parameters())
        ocfg = opt_lib.OptConfig(**fields)
        state = opt_lib.init(ocfg, params)
        want_losses = []
        for batch in batches:
            halves = []
            for h in (slice(0, 2), slice(2, 4)):
                loss, _ = model.train_loss({k: torch.from_numpy(v[h]).to(dev)
                                            for k, v in batch.items()})
                loss.backward()
                halves.append((float(loss.detach()),
                               {k: p.grad for k, p in params.items()}))
                model.zero_grad(set_to_none=True)
            grads = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in params}
            _, state, _ = opt_lib.apply(ocfg, state, params, grads)
            want_losses.append((halves[0][0] + halves[1][0]) / 2)
    finally:
        layers.COMPUTE_DTYPE = saved
    results = parallel.run_ranks(4, ranks.card_train_tp, arch, tree, batches,
                                 fields, device=dev, timeout=300.0)
    for r in results:
        losses, got = r.value
        assert np.abs(losses - np.array(want_losses)).max() <= 1e-4
        for k, p in params.items():
            w = p.detach().cpu().numpy()
            assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k
    for k in params:
        assert parallel.bitwise_equal([r.value[1][k] for r in results]), k


def test_dryrun_sped_fused_on_two_ranks_matches_one_process(dev):
    """``launch.dryrun_sped``'s cheb64_fused step on 2 gloo ranks of this
    card (each scattering its half of the edges, one all_reduce a
    matvec) against the one-process step on the card, within 1e-5 of the
    panel's largest magnitude, bitwise equal on the ranks."""
    import torch_dist_ranks as ranks
    from repro_torch import parallel
    from repro_torch.launch import dryrun_sped

    edges = {k: t.numpy() for k, t in dryrun_sped.random_edges(
        4096, 1 << 16, seed=6, device="cpu").items()}
    v = np.linalg.qr(np.random.default_rng(6).standard_normal((4096, 8)))[0]
    v = np.ascontiguousarray(v, np.float32)
    want = dryrun_sped.build_step("cheb64_fused", None, ())(
        torch.from_numpy(v).to(dev),
        {k: torch.from_numpy(a).to(dev) for k, a in edges.items()})
    results = parallel.run_ranks(2, ranks.card_dryrun_sped, edges, v,
                                 "cheb64_fused", device=dev, timeout=300.0)
    got = [r.value for r in results]
    assert parallel.bitwise_equal(got)
    assert _rel_err(torch.from_numpy(got[0]).to(dev), want) <= REL
