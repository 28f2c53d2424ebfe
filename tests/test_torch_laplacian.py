"""The port's graphs, Laplacian and backend layer against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (its plain PyTorch path).  Tolerance: 1e-5 max-abs,
the TOL of tests/test_backend.py (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro_torch.core import backend, graphs, operators
from repro_torch.core import laplacian as lap

TOL = 1e-5
CPU = "cpu"


def _rand_edges(seed: int, n: int, e: int):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    return edges, w


def _pair(seed: int, n: int, e: int, capacity: int | None = None):
    edges, w = _rand_edges(seed, n, e)
    gj = jlap.make_edge_list(edges, n, weights=w)
    gt = lap.make_edge_list(edges, n, weights=w, device=CPU)
    if capacity is not None:
        gj, gt = jlap.pad_edge_list(gj, capacity), lap.pad_edge_list(gt, capacity)
    return gj, gt


CASES = {
    "weighted": lambda: _pair(0, 96, 300),
    "capacity_padded": lambda: _pair(1, 96, 300, capacity=512),
    "non_aligned": lambda: _pair(2, 301, 517),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


GENERATORS = {
    "clique": ("clique_graph", (160, 4), dict(seed=3)),
    "sbm": ("sbm_graph", (90, 3), dict(p_in=0.3, p_out=0.02, seed=1)),
    "sparse_sbm": ("sparse_sbm_graph", (5000, 8),
                   dict(avg_degree_in=16, avg_degree_out=1, seed=0)),
    "power_law": ("power_law_graph", (4096,),
                  dict(avg_degree=8, alpha=2.5, seed=0)),
    "ring_of_cliques": ("ring_of_cliques", (4, 8), {}),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_identical_edges(name):
    fn, args, kw = GENERATORS[name]
    outj = getattr(jgraphs, fn)(*args, **kw)
    outt = getattr(graphs, fn)(*args, device=CPU, **kw)
    labelled = not isinstance(outj, jlap.EdgeList)  # (EdgeList, labels)
    gj, gt = (outj[0], outt[0]) if labelled else (outj, outt)
    assert gt.num_nodes == gj.num_nodes
    assert gt.src.dtype == torch.int32 and gt.weight.dtype == torch.float32
    np.testing.assert_array_equal(_np(gt.src), np.asarray(gj.src))
    np.testing.assert_array_equal(_np(gt.dst), np.asarray(gj.dst))
    np.testing.assert_array_equal(_np(gt.weight), np.asarray(gj.weight))
    if labelled:
        np.testing.assert_array_equal(outt[1], outj[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_forms_and_degrees(case):
    gj, gt = CASES[case]()
    np.testing.assert_allclose(_np(lap.degrees(gt)), jlap.degrees(gj), atol=TOL)
    np.testing.assert_allclose(_np(lap.adjacency_dense(gt)),
                               jlap.adjacency_dense(gj), atol=TOL)
    np.testing.assert_allclose(_np(lap.laplacian_dense(gt)),
                               jlap.laplacian_dense(gj), atol=TOL)
    assert abs(float(lap.spectral_radius_upper_bound(gt))
               - float(jlap.spectral_radius_upper_bound(gj))) <= TOL


@pytest.mark.parametrize("k", [None, 1, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_matvec_matches_jax(case, k):
    gj, gt = CASES[case]()
    rng = np.random.default_rng(3)
    v = rng.normal(size=(gj.num_nodes,) if k is None else (gj.num_nodes, k))
    v = v.astype(np.float32)
    want = jlap.laplacian_matvec(gj, jnp.asarray(v))
    got = lap.laplacian_matvec(gt, torch.from_numpy(v))
    assert got.shape == tuple(want.shape)
    assert float(np.max(np.abs(_np(got) - np.asarray(want)))) <= TOL


def test_pad_edge_list_inert_and_checked():
    _, gt = CASES["weighted"]()
    gp = lap.pad_edge_list(gt, 512)
    assert gp.num_edges == 512
    v = torch.randn(gt.num_nodes, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(lap.laplacian_matvec(gp, v),
                               lap.laplacian_matvec(gt, v), atol=TOL, rtol=0)
    with pytest.raises(ValueError):
        lap.pad_edge_list(gt, gt.num_edges - 1)


def test_backend_resolution_mirrors_jax_names():
    assert backend.BACKENDS == ("auto", "segment", "kernel")
    assert len(backend.BACKENDS) == len(jbackend.BACKENDS)
    assert backend.ONE_HOT_NODE_LIMIT == jbackend.ONE_HOT_NODE_LIMIT
    assert backend.DEFAULT_BLOCK_N == jbackend.DEFAULT_BLOCK_N
    assert backend.resolve_backend("auto", "cpu") == "segment"
    assert backend.resolve_backend("auto", "cuda") == "kernel"
    assert backend.resolve_backend("segment", "cuda") == "segment"
    with pytest.raises(ValueError):
        backend.resolve_backend("kernel", "cpu")
    with pytest.raises(ValueError):
        backend.resolve_backend("pallas", "cpu")


def test_segment_backend_factories_on_cpu():
    gj, gt = CASES["non_aligned"]()
    v = torch.randn(gt.num_nodes, 4, generator=torch.Generator().manual_seed(1))
    assert backend.fused_step_fn(gt, "auto") is None
    want = lap.laplacian_matvec(gt, v)
    for mv in (backend.laplacian_matvec_fn(gt, "segment"),
               backend.edge_arrays_matvec_fn(gt.src, gt.dst, gt.weight,
                                             "segment"),
               operators.edge_matvec(gt, backend="auto")):
        torch.testing.assert_close(mv(v), want, atol=0, rtol=0)
    with pytest.raises(ValueError):
        operators.edge_matvec(gt, backend="kernel")


def test_dense_matvec_operator():
    gj, gt = CASES["weighted"]()
    v = torch.randn(gt.num_nodes, 3, generator=torch.Generator().manual_seed(2))
    got = operators.dense_matvec(lap.laplacian_dense(gt))(v)
    torch.testing.assert_close(got, lap.laplacian_matvec(gt, v), atol=1e-4,
                               rtol=1e-5)
