"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the JAX package, so on a machine that has only
PyTorch it runs as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the result's scale (max(|plain|, 1)).  K1 and K2 add
with fp32 atomics in an order that changes from run to run, and K3/K4
sum in another order than the plain matmuls, so they agree to rounding,
not bitwise.
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
    g = _graph(0, 96, 300, dev)
    nb = backend.blocking_for(g, block_n=512)
    with pytest.raises(ValueError, match="shared memory"):
        es_ops.edge_spmm_blocked(nb, _panel(1, 96, 120, dev))


@pytest.mark.parametrize("n,k", [(1, 3), (300, 6), (5000, 10), (70000, 16)])
def test_k3_k4_match_plain(dev, n, k):
    v = _panel(13, n, k, dev)
    av = _panel(14, n, k, dev)
    reset_launch_counts()
    s = eg_ops.gram2k(v, av)
    assert _rel_err(s, eg_ref.gram2k(v, av)) <= REL
    m1, m2, cs = (_panel(15, k, k, dev), _panel(16, k, k, dev),
                  _panel(17, 1, k, dev)[0])
    out = eg_ops.panel_mix(v, av, m1, m2, cs)
    assert _rel_err(out, eg_ref.panel_mix(v, av, m1, m2, cs)) <= REL
    assert launch_counts()["gram2k"] == 1 and launch_counts()["panel_mix"] == 1


def test_gram2k_is_deterministic(dev):
    v = _panel(18, 100000, 10, dev)
    av = _panel(19, 100000, 10, dev)
    torch.testing.assert_close(eg_ops.gram2k(v, av), eg_ops.gram2k(v, av),
                               atol=0, rtol=0)


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
