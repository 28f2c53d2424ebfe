"""The incidence SpMM (K1, K2) and the node-blocked layout against the JAX
package.

CPU: the port's wrappers take their plain twins, which are held to the
JAX segment matvec and, at tiny sizes, to the Pallas kernels in
interpret mode (as tests/test_backend.py runs them); tolerance 1e-5
max-abs, the TOL of tests/test_backend.py.  The layout arrays must be
bitwise equal.  tests/test_torch_cuda.py holds the CUDA kernels to these
plain twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.kernels.edge_spmm import ops as jops
from repro.kernels.edge_spmm import ref as jref
from repro_torch import convert
from repro_torch.core import graphs
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import kernel, ops, ref

TOL = 1e-5
CPU = "cpu"


def _pair(seed: int, n: int, e: int, capacity: int | None = None):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
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


def _panel(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy()


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_jax_ref(case):
    gj, gt = CASES[case]()
    v = _panel(3, gj.num_nodes, 5)
    assert _maxabs(_np(ref.edge_spmm(gt.src, gt.dst, gt.weight,
                                     torch.from_numpy(v))),
                   jref.edge_spmm(gj.src, gj.dst, gj.weight, v)) <= TOL
    assert _maxabs(_np(ref.edge_spmm_affine(gt.src, gt.dst, gt.weight,
                                            torch.from_numpy(v), -0.03, 1.0)),
                   jref.edge_spmm_affine(gj.src, gj.dst, gj.weight, v,
                                         -0.03, 1.0)) <= TOL


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-0.05, 1.0), (0.7, -0.2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_spmm_cpu_matches_jax_segment(case, alpha, beta):
    gj, gt = CASES[case]()
    v = _panel(4, gj.num_nodes, 6)
    want = alpha * jlap.laplacian_matvec(gj, jnp.asarray(v)) + beta * v
    got = ops.edge_spmm(gt.src, gt.dst, gt.weight, torch.from_numpy(v),
                        alpha=alpha, beta=beta)
    assert _maxabs(_np(got), want) <= TOL


def test_edge_spmm_edgeless_and_1d():
    g = lap.make_edge_list(np.zeros((0, 2), np.int64), 40, device=CPU)
    v = torch.from_numpy(_panel(16, 40, 3))
    out = ops.edge_spmm(g.src, g.dst, g.weight, v)
    np.testing.assert_array_equal(_np(out), 0.0)
    out = ops.edge_spmm(g.src, g.dst, g.weight, v, alpha=2.0, beta=0.5)
    np.testing.assert_array_equal(_np(out), 0.5 * _np(v))
    _, gt = CASES["non_aligned"]()
    v = torch.from_numpy(_panel(5, gt.num_nodes, 1))
    one = ops.edge_spmm(gt.src, gt.dst, gt.weight, v[:, 0])
    assert one.shape == (gt.num_nodes,)
    torch.testing.assert_close(one, ops.edge_spmm(gt.src, gt.dst, gt.weight,
                                                  v)[:, 0], atol=TOL, rtol=0)


def test_k1_pallas_interpret_matches_port():
    gj, gt = CASES["weighted"]()
    v = _panel(6, gj.num_nodes, 4)
    want = jops.edge_spmm(gj.src, gj.dst, gj.weight, jnp.asarray(v),
                          alpha=-0.1, beta=1.0, interpret=True)
    got = ops.edge_spmm(gt.src, gt.dst, gt.weight, torch.from_numpy(v),
                        alpha=-0.1, beta=1.0)
    assert _maxabs(_np(got), want) <= TOL


LAYOUTS = {
    "weighted_b32": lambda: (CASES["weighted"](), 32, 128),
    "padded_b32": lambda: (CASES["capacity_padded"](), 32, 128),
    "non_aligned_b64": lambda: (CASES["non_aligned"](), 64, 128),
    "non_aligned_b16_e32": lambda: (CASES["non_aligned"](), 16, 32),
}


def _layouts(name):
    (gj, gt), block_n, block_e = LAYOUTS[name]()
    bj = jops.build_node_blocking(gj.src, gj.dst, gj.weight, gj.num_nodes,
                                  block_n=block_n, block_e=block_e)
    bt = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=block_n, block_e=block_e, device=CPU)
    return gj, gt, bj, bt


def _assert_layout_equal(bt, bj):
    for f in ("u_local", "other", "weight", "chunk_block", "deg"):
        a, b = _np(getattr(bt, f)), np.asarray(getattr(bj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("block_n", "block_e", "num_chunks", "num_nodes"):
        assert getattr(bt, f) == getattr(bj, f), f
    assert bt.num_blocks == bj.num_blocks
    assert bt.padded_half_edges == bj.padded_half_edges


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_node_blocking_bitwise_equal(name):
    _, _, bj, bt = _layouts(name)
    _assert_layout_equal(bt, bj)


def test_skew_blocking_bitwise_and_real_chunk_offsets():
    """The alpha = 2.5 power-law row of BENCH_kernels.json (`skew`): 32768
    padded slots; block_chunks ends the last block's run at its real chunk
    count, before the pow2 padding."""
    gj = jgraphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0)
    gt = graphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0,
                                device=CPU)
    bj = jops.build_node_blocking(gj.src, gj.dst, gj.weight, gj.num_nodes,
                                  block_n=256)
    bt = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=256, device=CPU)
    _assert_layout_equal(bt, bj)
    assert bt.padded_half_edges == 32768
    offs = _np(bt.block_chunks)
    cb = _np(bt.chunk_block)
    nb = bt.num_blocks
    assert offs.shape == (nb + 1,) and offs[0] == 0
    real = int(offs[-1])
    assert real < bt.num_chunks  # the snap padded this layout
    # every real chunk's block is the block whose offset range holds it
    np.testing.assert_array_equal(
        cb[:real], np.repeat(np.arange(nb), np.diff(offs)))
    # past the real chunks, only zero-weight padding of the last block
    assert np.all(cb[real:] == nb - 1)
    assert np.all(_np(bt.weight)[real * bt.block_e:] == 0.0)
    counts = np.bincount(
        np.concatenate([_np(gt.src), _np(gt.dst)]) // 256, minlength=nb)
    np.testing.assert_array_equal(
        np.diff(offs), np.maximum(-(-counts // bt.block_e), 1))


def test_layout_helpers_match_jax():
    for x in (0, 1, 2, 3, 5, 1000, 140386):
        assert ops.next_pow2(x) == jops.next_pow2(x)
    counts = np.array([0, 1, 128, 129, 1000])
    np.testing.assert_array_equal(ops._chunk_counts(counts, 128),
                                  jops._chunk_counts(counts, 128))
    gj, _ = CASES["capacity_padded"]()
    outs_t = ops._block_sorted_half_edges(gj.src, gj.dst, gj.weight, 32, 3)
    outs_j = jops._block_sorted_half_edges(gj.src, gj.dst, gj.weight, 32, 3)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a, b)
    u, o, w2, c = outs_j
    nc = jops.next_pow2(int(jops._chunk_counts(c, 16).sum()))
    for a, b in zip(ops._fill_chunked(u, o, w2, c, 3, nc, 32, 16),
                    jops._fill_chunked(u, o, w2, c, 3, nc, 32, 16)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ops._weighted_degrees(gj.src, gj.dst, gj.weight, 128),
        jops._weighted_degrees(gj.src, gj.dst, gj.weight, 128))


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-0.04, 1.0)])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_blocked_plain_matches_jax_segment(name, alpha, beta):
    gj, gt, bj, bt = _layouts(name)
    v = _panel(7, gj.num_nodes, 5)
    want = alpha * jlap.laplacian_matvec(gj, jnp.asarray(v)) + beta * v
    got = ops.edge_spmm_blocked(bt, torch.from_numpy(v), alpha=alpha, beta=beta)
    assert _maxabs(_np(got), want) <= TOL


def test_k2_pallas_interpret_matches_port():
    gj, gt, bj, bt = _layouts("non_aligned_b64")
    v = _panel(8, gj.num_nodes, 3)
    want = jops.edge_spmm_blocked(bj, jnp.asarray(v), alpha=-0.1, beta=1.0,
                                  interpret=True)
    got = ops.edge_spmm_blocked(bt, torch.from_numpy(v), alpha=-0.1, beta=1.0)
    assert _maxabs(_np(got), want) <= TOL


def test_blocked_1d_and_row_check():
    _, gt, _, bt = _layouts("weighted_b32")
    v = torch.from_numpy(_panel(9, gt.num_nodes, 2))
    torch.testing.assert_close(ops.edge_spmm_blocked(bt, v[:, 0]),
                               ops.edge_spmm_blocked(bt, v)[:, 0],
                               atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="num_nodes"):
        ops.edge_spmm_blocked(bt, v[:-1])


@pytest.mark.parametrize("name", ["padded_b32", "non_aligned_b16_e32"])
def test_node_blocking_from_numpy(name):
    _, _, bj, bt = _layouts(name)
    bc = convert.node_blocking_from_numpy(
        bj.u_local, bj.other, bj.weight, bj.chunk_block, bj.deg,
        block_n=bj.block_n, block_e=bj.block_e, num_chunks=bj.num_chunks,
        num_nodes=bj.num_nodes, device=CPU)
    _assert_layout_equal(bc, bj)
    np.testing.assert_array_equal(_np(bc.block_chunks), _np(bt.block_chunks))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, gt, _, bt = _layouts("weighted_b32")
    v = torch.zeros(gt.num_nodes, 2)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.edge_spmm(rows.row_ptr, rows.other, rows.weight, rows.hub_rows,
                         v, 1.0, 0.0, hub_threshold=ops.HUB_THRESHOLD)
    rows = ops.blocking_rows(bt)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.edge_spmm_nb(rows.row_ptr, rows.other, rows.weight,
                            rows.hub_rows, v, 1.0, 0.0,
                            hub_threshold=ops.HUB_THRESHOLD)
