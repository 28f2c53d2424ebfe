"""The row CSR that K1 and K2 read, and its plain twin, against the JAX
package.

CPU: the destination-sorted half-edge CSR (``ops.EdgeRows``) must list
exactly the edge list's half-edges per row, come out the same from the
edge list (``build_edge_rows``) and from a host-built or converted JAX
``NodeBlocking`` (``blocking_rows``), and its hub table must hold exactly
the rows past the split threshold ``ops.HUB_THRESHOLD``, which the tests
force down with monkeypatch.  The plain twin over it is held to the JAX
reference and to the Pallas kernels in interpret mode (as
tests/test_backend.py runs them) at 1e-5 max-abs, the TOL of
tests/test_backend.py.  tests/test_torch_cuda.py holds the CUDA kernel to
this twin on the card.  The skew graph's hub rows sum hundreds of terms
of order one, so there the bound is 1e-5 of the result's scale
(max(|want|, 1)), as the card tests state theirs.
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
from repro_torch.core import graphs, operators
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops, ref

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


def _skew():
    """The alpha = 2.5 power-law graph of BENCH_kernels.json's skew row:
    rows from 1 to hundreds of half-edges."""
    gj = jgraphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0)
    gt = graphs.power_law_graph(4096, avg_degree=8.0, alpha=2.5, seed=0,
                                device=CPU)
    return gj, gt


CASES = {
    "weighted": lambda: _pair(0, 96, 300),
    "capacity_padded": lambda: _pair(1, 96, 300, capacity=512),
    "non_aligned": lambda: _pair(2, 301, 517),
    "skew": _skew,
}


def _panel(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy()


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _scaled_err(got, want) -> float:
    return _maxabs(got, want) / max(float(np.max(np.abs(np.asarray(want)))), 1.0)


def _half_edges(g):
    """Live half-edges of an edge list as a sorted list of (row, other, w)."""
    s, d, w = _np(g.src), _np(g.dst), _np(g.weight)
    live = w != 0
    s, d, w = s[live], d[live], w[live]
    return sorted(zip(np.concatenate([s, d]).tolist(),
                      np.concatenate([d, s]).tolist(),
                      np.concatenate([w, w]).tolist()))


def _rows_listed(row_ptr, other, weight):
    rp = _np(row_ptr)
    rows = np.repeat(np.arange(rp.shape[0] - 1), np.diff(rp))
    return sorted(zip(rows.tolist(), _np(other)[: rp[-1]].tolist(),
                      _np(weight)[: rp[-1]].tolist()))


def _hubs(rows) -> np.ndarray:
    """The hub rows of a table, without its padding of n's."""
    h = _np(rows.hub_rows)
    n = rows.row_ptr.shape[0] - 1
    assert h[-1] == n and np.all((np.diff(h) > 0) | (h[1:] == n))
    return h[h != n]


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_csr_lists_every_half_edge_once(case):
    _, gt = CASES[case]()
    live = int((gt.weight != 0).sum())
    nb = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=64, device=CPU)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    blocked = ops.blocking_rows(nb)
    want = _half_edges(gt)
    for r_ in (rows, blocked):
        r = _np(r_.row_ptr)
        assert r_.row_ptr.dtype == torch.int32
        assert r_.other.dtype == torch.int32
        assert r_.weight.dtype == torch.float32
        assert r.shape == (gt.num_nodes + 1,) and r[0] == 0
        assert np.all(np.diff(r) >= 0) and r[-1] == 2 * live
        # each row's (neighbour, weight) multiset is the edge list's
        assert _rows_listed(r_.row_ptr, r_.other, r_.weight) == want
        # dead slots (capacity or chunk padding) sort past the last row
        assert np.all(_np(r_.weight)[2 * live:] == 0)
    assert rows.other.shape == (2 * gt.num_edges,)
    assert blocked.other.shape == (nb.padded_half_edges,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_and_host_builders_agree(case, monkeypatch):
    """build_edge_rows of the edge list and blocking_rows of the host-built
    blocking (block_n far below n) give the same live arrays and the same
    hub rows bitwise, at every split threshold."""
    _, gt = CASES[case]()
    nb = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=32, device=CPU)
    for threshold in (0, 3, 16, ops.HUB_THRESHOLD):
        monkeypatch.setattr(ops, "HUB_THRESHOLD", threshold)
        rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
        blocked = ops.blocking_rows(nb)
        live = int(rows.row_ptr[-1])
        np.testing.assert_array_equal(_np(rows.row_ptr), _np(blocked.row_ptr))
        np.testing.assert_array_equal(_np(rows.other)[:live],
                                      _np(blocked.other)[:live])
        np.testing.assert_array_equal(_np(rows.weight)[:live],
                                      _np(blocked.weight)[:live])
        np.testing.assert_array_equal(_hubs(rows), _hubs(blocked))


@pytest.mark.parametrize("threshold", [0, 1, 4, 40])
def test_hub_table_holds_the_rows_past_a_forced_threshold(threshold,
                                                          monkeypatch):
    _, gt = _skew()
    monkeypatch.setattr(ops, "HUB_THRESHOLD", threshold)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    lens = np.diff(_np(rows.row_ptr))
    want = np.nonzero(lens > threshold)[0]
    assert want.shape[0] > 0
    hubs = _np(rows.hub_rows)
    np.testing.assert_array_equal(hubs[: want.shape[0]], want)
    assert np.all(hubs[want.shape[0]:] == gt.num_nodes)
    # the table has room for every row the threshold can admit
    assert hubs.shape[0] - 1 == min(
        gt.num_nodes, 2 * gt.num_edges // (threshold + 1))


def test_row_csr_is_a_stable_sort_of_the_block_order():
    """The row CSR is the block-sorted half-edges of the JAX package
    (``_block_sorted_half_edges``), stably sorted by destination."""
    gj, gt = CASES["non_aligned"]()
    u, o, w2, _ = jops._block_sorted_half_edges(gj.src, gj.dst, gj.weight,
                                                64, 5)
    order = np.argsort(u, kind="stable")
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    live = u.shape[0]
    np.testing.assert_array_equal(_np(rows.other)[:live], o[order])
    np.testing.assert_array_equal(_np(rows.weight)[:live], w2[order])


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-0.05, 1.0), (0.7, -0.2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_twin_matches_jax_ref(case, alpha, beta):
    gj, gt = CASES[case]()
    v = _panel(3, gj.num_nodes, 5)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    got = ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                             torch.from_numpy(v), alpha, beta)
    want = jref.edge_spmm_affine(gj.src, gj.dst, gj.weight, v, alpha, beta)
    assert _scaled_err(_np(got), want) <= TOL
    # the wrapper's CPU path is that twin
    got2 = ops.edge_spmm_rows(rows, torch.from_numpy(v), alpha, beta)
    np.testing.assert_array_equal(_np(got2), _np(got))


@pytest.mark.parametrize("case", ["weighted", "non_aligned"])
def test_row_twin_matches_pallas_edge_spmm_interpret(case):
    gj, gt = CASES[case]()
    v = _panel(6, gj.num_nodes, 4)
    want = jops.edge_spmm(gj.src, gj.dst, gj.weight, jnp.asarray(v),
                          alpha=-0.1, beta=1.0, interpret=True)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    got = ops.edge_spmm_rows(rows, torch.from_numpy(v), alpha=-0.1, beta=1.0)
    assert _maxabs(_np(got), want) <= TOL


@pytest.mark.parametrize("block_n,block_e", [(64, 128), (16, 32)])
def test_row_twin_matches_pallas_blocked_interpret(block_n, block_e):
    gj, gt = CASES["non_aligned"]()
    bj = jops.build_node_blocking(gj.src, gj.dst, gj.weight, gj.num_nodes,
                                  block_n=block_n, block_e=block_e)
    bt = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=block_n, block_e=block_e, device=CPU)
    v = _panel(8, gj.num_nodes, 3)
    want = jops.edge_spmm_blocked(bj, jnp.asarray(v), alpha=-0.1, beta=1.0,
                                  interpret=True)
    rows = ops.blocking_rows(bt)
    got = ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                             torch.from_numpy(v), -0.1, 1.0)
    assert _maxabs(_np(got), want) <= TOL


@pytest.mark.parametrize("name", ["weighted", "capacity_padded", "skew"])
def test_convert_fills_the_row_fields(name, monkeypatch):
    """A JAX blocking carried across by convert gives the row CSR of the
    port's own blocking, and the edge list's on the live entries."""
    monkeypatch.setattr(ops, "HUB_THRESHOLD", 16)
    gj, gt = CASES[name]()
    bj = jops.build_node_blocking(gj.src, gj.dst, gj.weight, gj.num_nodes,
                                  block_n=256)
    bt = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 block_n=256, device=CPU)
    bc = convert.node_blocking_from_numpy(
        bj.u_local, bj.other, bj.weight, bj.chunk_block, bj.deg,
        block_n=bj.block_n, block_e=bj.block_e, num_chunks=bj.num_chunks,
        num_nodes=bj.num_nodes, device=CPU)
    got, want = ops.blocking_rows(bc), ops.blocking_rows(bt)
    for f in ops.EdgeRows._fields:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    rows = ops.build_edge_rows(gt.src, gt.dst, gt.weight, gt.num_nodes)
    live = int(rows.row_ptr[-1])
    np.testing.assert_array_equal(_np(got.row_ptr), _np(rows.row_ptr))
    np.testing.assert_array_equal(_np(got.other)[:live], _np(rows.other)[:live])
    np.testing.assert_array_equal(_hubs(got), _hubs(rows))


def test_rows_view_and_edgeless_layouts():
    _, gt = CASES["weighted"]()
    nb = ops.build_node_blocking(gt.src, gt.dst, gt.weight, gt.num_nodes,
                                 device=CPU)
    assert isinstance(ops.blocking_rows(nb), ops.EdgeRows)
    g0 = lap.make_edge_list(np.zeros((0, 2), np.int64), 40, device=CPU)
    rows = ops.build_edge_rows(g0.src, g0.dst, g0.weight, 40)
    np.testing.assert_array_equal(_np(rows.row_ptr), 0)
    np.testing.assert_array_equal(_np(rows.hub_rows), [40])
    v = torch.from_numpy(_panel(9, 40, 3))
    out = ops.edge_spmm_rows(rows, v, alpha=2.0, beta=0.5)
    np.testing.assert_array_equal(_np(out), 0.5 * _np(v))
    one = ops.edge_spmm_rows(ops.blocking_rows(nb),
                             torch.from_numpy(_panel(9, 96, 1))[:, 0])
    assert one.shape == (96,)
    e0 = ops.blocking_rows(ops.build_node_blocking(
        g0.src, g0.dst, g0.weight, 40, block_n=16, device=CPU))
    np.testing.assert_array_equal(_np(e0.row_ptr), 0)
    np.testing.assert_array_equal(_np(ops.edge_spmm_rows_nb(e0, v, 2.0, 0.5)),
                                  0.5 * _np(v))


def test_captured_operator_refuses_cpu_panels():
    op = operators.CapturedOperator(lambda v: v)
    with pytest.raises(ValueError, match="CUDA"):
        op(torch.zeros(4, 2))
    assert op.graphs == {}
