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
# off any 16-byte boundary unless 4 divides k
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,k", [(1, 3), (1, 10), (100, 10), (300, 6),
                                 (1001, 1), (301, 3), (4097, 4), (5000, 10),
                                 (5003, 7), (70000, 16), (70001, 10),
                                 (3001, 64), (2000, 192)])
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
