"""The port's streaming state (``repro_torch.stream``) and the dilated
operators of ``core.operators`` against the JAX package.

Both packages start from the same buffers (made with numpy, carried
across by ``convert``).  Tolerances: the store's buffers, ``dw``,
``BatchStats``, ``coalesce_batch``, capacity classes and the overlap
counts are bitwise equal; degrees to 1e-6 relative (both sum with
scatter-adds, in another order); matvecs, dilated operators and
first-order updates to 1e-5 max-abs (the TOL of tests/test_backend.py);
warm re-solves from the same ``v_prev`` follow the same steps and agree
to 1e-4.  Cold solves draw from jax.random and torch.Generator, so they
are held to the JAX tests' own bars, not to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import operators as jops
from repro.stream import graph_store as jgs
from repro.stream import tracking as jtracking
from repro.stream import updates as jupdates
from repro.stream import warm as jwarm
from repro_torch import convert
from repro_torch.core import backend as backend_mod
from repro_torch.core import graphs, laplacian as lap, operators
from repro_torch.core.series import limit_neg_exp
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.stream import graph_store as gs
from repro_torch.stream import tracking, updates, warm

CPU = "cpu"
TOL = 1e-5
STEPS_TOL = 1e-4
DEG_RTOL = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b)))) if _np(a).size else 0.0


def _store_pair(edges, n, capacity, weights=None):
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    gj = jlap.make_edge_list(edges, n, weights=weights)
    gt = lap.make_edge_list(edges, n, weights=weights, device=CPU)
    return (jgs.from_edge_list(gj, capacity=capacity),
            gs.from_edge_list(gt, capacity=capacity))


def _same_store(sj, st):
    for f in ("src", "dst", "weight"):
        _bitwise(getattr(sj, f), getattr(st, f))
    assert bool(sj.deg_dirty) == st.deg_dirty
    assert sj.num_nodes == st.num_nodes
    np.testing.assert_allclose(_np(st.deg), np.asarray(sj.deg), rtol=DEG_RTOL,
                               atol=0)


def _apply_both(sj, st, pairs, ws, mode, pad_to):
    bj = jgs.coalesce_batch(pairs, ws, mode=mode, pad_to=pad_to)
    bt = gs.coalesce_batch(pairs, ws, mode=mode, pad_to=pad_to, device=CPU)
    for f in ("src", "dst", "weight"):
        _bitwise(getattr(bj, f), getattr(bt, f))
    sj, dwj, statj = jgs.apply_edge_batch(sj, bj, mode=mode)
    st, dwt, statt = gs.apply_edge_batch(st, bt, mode=mode)
    _same_store(sj, st)
    _bitwise(dwj, dwt)
    for f in ("matched", "inserted", "dropped"):
        _bitwise(getattr(statj, f), getattr(statt, f))
    assert int(jgs.num_edges(sj)) == int(gs.num_edges(st))
    return sj, st, statt


# ---------------------------------------------------------------------------
# graph store: bitwise against the JAX store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["set", "add"])
def test_random_batches_match_jax_bitwise(mode):
    """test_stream.py::test_edge_batches_match_rebuilt_laplacian's random
    sequence, applied in both packages after every batch."""
    rng = np.random.default_rng(0)
    n = 12
    sj, st = _store_pair([[0, 1], [1, 2], [2, 3]], n, 64)
    _same_store(sj, st)
    for _ in range(6):
        pairs, ws = [], []
        for _ in range(5):
            i, j = sorted(rng.choice(n, size=2, replace=False).tolist())
            pairs.append((i, j))
            ws.append(float(rng.choice([0.0, 0.5, 1.0, 2.0])))
        if mode == "add":  # deltas of both signs, some reaching exactly 0
            ws = [w * (-1) ** k for k, w in enumerate(ws)]
        sj, st, _ = _apply_both(sj, st, pairs, ws, mode, 8)


@pytest.mark.parametrize("mode", ["set", "add"])
def test_batches_near_capacity_drop_like_jax(mode):
    """A nearly full store: reweights in place, a burst of inserts fills
    the free slots in ascending order and drops the rest."""
    n = 16
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    sj, st = _store_pair(pairs[:14], n, 16)
    sj, st, stats = _apply_both(sj, st, [pairs[0]], [5.0], mode, 8)
    assert (int(stats.matched), int(stats.dropped)) == (1, 0)
    # delete one, then insert five: three fit, two drop
    sj, st, _ = _apply_both(sj, st, [pairs[3]], [0.0 if mode == "set" else -1.0],
                            mode, 8)
    sj, st, stats = _apply_both(sj, st, pairs[20:25], [1.0] * 5, mode, 8)
    assert (int(stats.inserted), int(stats.dropped)) == (3, 2)


def test_self_loop_slot_is_matched_by_padding_like_jax():
    """A live (0, 0) slot admitted by from_edge_list collides with the
    padding sentinel: padded batches match (and delete) it, as in JAX."""
    sj, st = _store_pair([[0, 0], [0, 1], [2, 3]], 4, 16)
    sj, st, stats = _apply_both(sj, st, [[1, 2]], [1.0], "set", 4)
    assert int(stats.matched) == 3  # three padding entries hit slot 0
    sj, st, _ = _apply_both(sj, st, [[0, 0], [0, 3]], [2.0, 1.0], "add", 4)


def test_duplicate_live_pairs_update_the_lowest_slot():
    sj, st = _store_pair([[3, 4], [1, 2], [5, 6], [1, 2], [1, 2]], 8, 16,
                         weights=[1.0, 2.0, 3.0, 4.0, 5.0])
    for mode in ("set", "add"):
        sj, st, _ = _apply_both(sj, st, [[1, 2], [5, 6]], [7.0, 0.0], mode, 4)
    assert float(st.weight[1]) != 2.0 and float(st.weight[3]) == 4.0


def test_long_random_stream_matches_jax():
    """Inserts, deletes of absent edges, reweights and growth in one
    stream on 50 nodes, in both modes, to a full buffer and past it."""
    rng = np.random.default_rng(3)
    n = 50
    edges = rng.integers(0, n, size=(60, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    sj, st = _store_pair(edges, n, 128, weights=rng.uniform(0.5, 2, len(edges)))
    dropped = 0
    for step in range(12):
        if step == 6:
            sj, st = jgs.grow(sj), gs.grow(st)
        m = int(rng.integers(1, 33))
        pairs = rng.integers(0, n, size=(m, 2))
        ws = rng.choice([0.0, -1.0, 0.25, 1.0, 3.0], size=m)
        mode = "add" if step % 3 == 2 else "set"
        sj, st, stats = _apply_both(sj, st, pairs,
                                    np.abs(ws) if mode == "set" else ws, mode, 32)
        dropped += int(stats.dropped)
    assert dropped > 0 and int(gs.num_edges(st)) > 128


def test_coalesce_and_make_edge_batch_match_jax():
    rng = np.random.default_rng(4)
    pairs = rng.integers(0, 9, size=(40, 2))
    ws = rng.normal(size=40).astype(np.float32)
    for mode in ("set", "add"):
        bj = jgs.coalesce_batch(pairs, ws, mode=mode, pad_to=48)
        bt = gs.coalesce_batch(pairs, ws, mode=mode, pad_to=48, device=CPU)
        for f in ("src", "dst", "weight"):
            _bitwise(getattr(bj, f), getattr(bt, f))
    bj = jgs.make_edge_batch(pairs, ws)
    bt = gs.make_edge_batch(pairs, ws, device=CPU)
    for f in ("src", "dst", "weight"):
        _bitwise(getattr(bj, f), getattr(bt, f))
    with pytest.raises(ValueError, match="pad_to"):
        gs.make_edge_batch(pairs, ws, pad_to=3, device=CPU)


@pytest.mark.parametrize("num_edges", [0, 1, 100, 171, 200, 5000, 2 ** 26 // 2])
def test_capacity_class_matches_jax(num_edges):
    assert gs.capacity_class(num_edges) == jgs.capacity_class(num_edges)
    assert gs.CAPACITY_CLASSES == jgs.CAPACITY_CLASSES


def test_capacity_ladder_end_raises():
    with pytest.raises(ValueError, match="ladder"):
        gs.capacity_class(2 ** 26)


def test_grow_and_degrees_match_jax():
    g = jgraphs.ring_of_cliques(3, 6)[0]
    sj = jgs.from_edge_list(g, capacity=256, num_nodes=20)
    st = gs.from_edge_list(graphs.ring_of_cliques(3, 6, device=CPU)[0],
                           capacity=256, num_nodes=20)
    _same_store(sj, st)
    gj2, gt2 = jgs.grow(sj), gs.grow(st)
    assert gt2.capacity == gj2.capacity == 512
    _same_store(gj2, gt2)
    _same_store(jgs.grow(sj, 2048), gs.grow(st, 2048))
    with pytest.raises(ValueError, match="shrink"):
        gs.grow(st, 128)
    # lazy degrees: a mutation marks them stale; the bound refreshes them
    b = [[2, 3]], [4.0]
    sj, _, _ = jgs.apply_edge_batch(sj, jgs.make_edge_batch(*b, pad_to=4))
    st, _, _ = gs.apply_edge_batch(st, gs.make_edge_batch(*b, pad_to=4,
                                                          device=CPU))
    assert st.deg_dirty and bool(sj.deg_dirty)
    sj, rj = jgs.spectral_radius_upper_bound(sj)
    st, rt = gs.spectral_radius_upper_bound(st)
    _same_store(sj, st)
    np.testing.assert_allclose(float(rt), float(rj), rtol=DEG_RTOL)
    assert gs.refresh_degrees(st) is st


def test_apply_allocates_no_batch_by_capacity_tensor():
    """The lookup is by sorted key: no op of an apply allocates anything
    near the (B, capacity) match (here 64 MiB of bools)."""
    cap, b, n = 1 << 16, 1024, 4096
    rng = np.random.default_rng(5)
    edges = rng.integers(0, n, size=(cap // 2, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    st = gs.from_edge_list(lap.make_edge_list(edges, n, device=CPU),
                           capacity=cap)
    batch = gs.make_edge_batch(rng.integers(0, n, size=(b, 2)), np.ones(b),
                               pad_to=b, device=CPU)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        gs.apply_edge_batch(st, batch)
    largest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < largest < b * cap // 16, largest


# ---------------------------------------------------------------------------
# the row-CSR cache
# ---------------------------------------------------------------------------

def test_edge_rows_of_a_sparse_store_equal_its_live_edges():
    """At 1/16 occupancy the free (0, 0, w = 0) slots sort past the last
    row: the store's rows are those of its live edges alone, and row 0 is
    no hub."""
    n, cap = 300, 4096
    rng = np.random.default_rng(6)
    edges = rng.integers(0, n, size=(cap // 16, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    st = gs.from_edge_list(lap.make_edge_list(
        edges, n, weights=rng.uniform(0.1, 2, len(edges)), device=CPU),
        capacity=cap)
    # a few deletes scatter free slots among the live ones
    st, _, _ = gs.apply_edge_batch(st, gs.make_edge_batch(
        edges[:20], np.zeros(20), device=CPU))
    live = st.weight != 0
    rows = gs.edge_rows(st)
    want = es_ops.build_edge_rows(st.src[live], st.dst[live], st.weight[live], n)
    nnz = int(want.row_ptr[-1])
    _bitwise(rows.row_ptr, want.row_ptr)
    _bitwise(rows.other[:nnz], want.other[:nnz])
    _bitwise(rows.weight[:nnz], want.weight[:nnz])
    assert not bool((rows.weight[nnz:] != 0).any())
    _bitwise(rows.hub_rows[rows.hub_rows < n], want.hub_rows[want.hub_rows < n])
    assert gs.edge_rows(st) is rows  # cached
    st2, _, _ = gs.apply_edge_batch(st, gs.make_edge_batch([[1, 2]], [1.0],
                                                           device=CPU))
    assert gs.edge_rows(st2) is not rows  # a mutation leaves a fresh cache
    assert gs.edge_rows(gs.refresh_degrees(st2)) is gs.edge_rows(st2)


# ---------------------------------------------------------------------------
# dilated operators
# ---------------------------------------------------------------------------

def _padded_pair(seed=7, n=96, e=300, cap=512):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, len(edges)).astype(np.float32)
    sj, st = _store_pair(edges, n, cap, weights=w)
    v = rng.normal(size=(n, 6)).astype(np.float32)
    return sj, st, v


@pytest.mark.parametrize("degree", [1, 7])
def test_dilated_operators_match_jax(degree):
    sj, st, v = _padded_pair()
    c = 0.37 / float(jgs.spectral_radius_upper_bound(sj)[1])
    want = jops.dilated_matvec_arrays(sj.src, sj.dst, sj.weight, jnp.asarray(v),
                                      c, degree)
    vt = torch.from_numpy(v)
    args = (st.src, st.dst, st.weight)
    got = operators.dilated_operator_arrays(*args, c, degree, backend="segment")(vt)
    assert _maxabs(got, want) <= TOL
    assert _maxabs(operators.dilated_matvec_arrays(*args, vt, c, degree), want) <= TOL
    # the store's step, and the kernel path's body over the store's row
    # CSR (the row twin on a CPU panel)
    for fused in (gs.fused_step(st),
                  backend_mod.rows_fused_step(gs.edge_rows(st))):
        got = operators.dilated_step_operator(fused, c, degree)(vt)
        assert _maxabs(got, want) <= TOL
    res_j = jops.dilated_panel_residual(sj.src, sj.dst, sj.weight, jnp.asarray(v),
                                        c, degree)
    res_t = operators.dilated_panel_residual(*args, vt, c, degree)
    assert abs(float(res_t) - float(res_j)) <= TOL


def test_dilated_operator_kernel_backend_refuses_cpu_buffers():
    _, st, _ = _padded_pair()
    with pytest.raises(ValueError, match="CUDA"):
        operators.dilated_operator_arrays(st.src, st.dst, st.weight, 0.1, 3,
                                          backend="kernel")


# ---------------------------------------------------------------------------
# incremental eigen-updates
# ---------------------------------------------------------------------------

def _estimate_pair(seed=8, k=4):
    sj, st, _ = _padded_pair(seed)
    n = sj.num_nodes
    l0 = np.asarray(jlap.laplacian_dense(jgs.as_edge_list(sj)), np.float64)
    v0 = np.linalg.eigh(l0)[1][:, :k].astype(np.float32)
    ej = jupdates.anchor_estimate_arrays(sj.src, sj.dst, sj.weight, jnp.asarray(v0))
    et = updates.anchor_estimate_arrays(st.src, st.dst, st.weight,
                                        torch.from_numpy(v0))
    return sj, st, ej, et, n


def _batch_deltas(seed, n, b=24):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, b)
    dst = src + rng.integers(1, n - src)
    dw = (rng.normal(size=b) * 0.01).astype(np.float32)
    return (src.astype(np.int32), dst.astype(np.int32), dw)


def test_anchor_and_first_order_update_match_jax():
    sj, st, ej, et, n = _estimate_pair()
    # the buffers' anchor, the store's, and the kernel body's (row twin)
    for est in (et, updates.anchor_estimate(gs.fused_step(st), et.v),
                updates.anchor_estimate(
                    backend_mod.rows_fused_step(gs.edge_rows(st)), et.v)):
        for f in ("lam", "v", "drift"):
            assert _maxabs(getattr(est, f), getattr(ej, f)) <= TOL
    src, dst, dw = _batch_deltas(9, n)
    vt = torch.from_numpy(np.array(ej.v))
    assert _maxabs(updates.delta_matvec(*map(torch.from_numpy, (src, dst, dw)), vt),
                   jupdates.delta_matvec(src, dst, dw, ej.v)) <= TOL
    et = convert.eigen_estimate_from_numpy(ej.lam, ej.v, ej.drift, device=CPU)
    for step in range(3):  # three batches, drift accumulating
        src, dst, dw = _batch_deltas(10 + step, n)
        ej = jupdates.first_order_update(ej, src, dst, dw)
        et = updates.first_order_update(et, *map(torch.from_numpy, (src, dst, dw)))
        for f in ("lam", "v", "drift"):
            assert _maxabs(getattr(et, f), getattr(ej, f)) <= TOL, (step, f)
    cfg = updates.UpdateConfig(fallback_ratio=0.5)
    assert bool(updates.should_fallback(et, cfg)) == bool(
        jupdates.should_fallback(ej, jupdates.UpdateConfig(fallback_ratio=0.5)))
    _, flag = updates.update_or_flag(et, torch.tensor([0]), torch.tensor([1]),
                                     torch.tensor([50.0]), cfg)
    assert flag


def test_update_scalars_match_jax():
    lam = np.array([0.3, 0.0, 1.0, 0.1], np.float32)
    _bitwise(updates.min_gap(torch.from_numpy(lam)), jupdates.min_gap(lam))
    dw = np.array([1.0, -2.5, 0.0, 3.0], np.float32)
    _bitwise(updates.delta_norm_bound(torch.from_numpy(dw)),
             jupdates.delta_norm_bound(dw))
    small = updates.EigenEstimate(lam=torch.tensor([0.0, 0.1, 0.5, 1.0]),
                                  v=torch.eye(8)[:, :4], drift=torch.tensor(0.04))
    big = small._replace(drift=torch.tensor(0.06))
    cfg = updates.UpdateConfig(fallback_ratio=0.5)
    assert not bool(updates.should_fallback(small, cfg))
    assert bool(updates.should_fallback(big, cfg))


# ---------------------------------------------------------------------------
# warm re-solves
# ---------------------------------------------------------------------------

def _dilated_op(g, degree=7, strength=6.0):
    rho = float(lap.spectral_radius_upper_bound(g))
    s = limit_neg_exp(degree, scale=strength / rho)
    return operators.series_operator(s, operators.edge_matvec(g, backend="segment"))


def test_warm_start_reconverges_faster_than_cold_and_follows_jax():
    """test_stream.py's bars on the port (warm accepted, residual <= tol,
    fewer warm iterations than cold), and the warm re-solve from the same
    v_prev in both packages, step for step."""
    g, _ = graphs.sbm_graph(150, 3, p_in=0.3, p_out=0.02, seed=0, device=CPU)
    cfg = warm.WarmConfig(tol=5e-3, chunk=10, max_steps=3000, lr=0.3)
    gen = torch.Generator().manual_seed(0)
    state, cold = warm.reconverge(gen, _dilated_op(g), g.num_nodes, 5, cfg)
    assert cold["iterations"] > 0 and cold["residual"] <= cfg.tol
    assert not cold["warm"]
    # churn ~1% of the edges through the store, then re-solve warm
    rng = np.random.default_rng(1)
    e = g.num_edges
    gone = rng.choice(e, size=max(e // 100, 1), replace=False)
    store = gs.from_edge_list(g)
    store, _, _ = gs.apply_edge_batch(store, gs.make_edge_batch(
        np.stack([_np(g.src)[gone], _np(g.dst)[gone]], 1), np.zeros(len(gone)),
        device=CPU))
    store, rho = gs.spectral_radius_upper_bound(store)
    c = 6.0 / float(rho) / 7
    op2 = operators.dilated_operator_arrays(store.src, store.dst, store.weight,
                                            c, 7)
    state2, info = warm.reconverge(gen, op2, g.num_nodes, 5, cfg, v_prev=state.v)
    assert info["warm"] and info["residual"] <= cfg.tol
    assert info["iterations"] < cold["iterations"]
    # the JAX package from the same v_prev on the same buffers
    op2j = jops.dilated_operator_arrays(*(jnp.asarray(_np(x)) for x in (
        store.src, store.dst, store.weight)), c, 7)
    cfgj = jwarm.WarmConfig(tol=5e-3, chunk=10, max_steps=3000, lr=0.3)
    statej, infoj = jwarm.reconverge(jax.random.PRNGKey(0), op2j, g.num_nodes, 5,
                                     cfgj, v_prev=jnp.asarray(_np(state.v)))
    assert infoj["warm"] and infoj["iterations"] == info["iterations"]
    assert abs(infoj["residual"] - info["residual"]) <= STEPS_TOL
    assert _maxabs(state2.v, statej.v) <= STEPS_TOL


def test_restart_test_rejects_garbage_panel():
    g, _ = graphs.ring_of_cliques(4, 10, device=CPU)
    junk = torch.eye(g.num_nodes)[:, :4]
    _, info = warm.warm_start_state(torch.Generator().manual_seed(0),
                                    _dilated_op(g), g.num_nodes, 4, junk,
                                    restart_residual=0.05)
    assert not info["warm"]


# ---------------------------------------------------------------------------
# label tracking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_labels_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = 5
    ref = rng.integers(0, k, 200)
    new = (ref + rng.integers(0, 2, 200) * rng.integers(0, k, 200)) % k
    _bitwise(tracking.overlap_matrix(torch.from_numpy(ref), torch.from_numpy(new), k),
             jtracking.overlap_matrix(jnp.asarray(ref), jnp.asarray(new), k))
    sj, pj = jtracking.match_labels(jnp.asarray(ref), jnp.asarray(new), k)
    st, pt = tracking.match_labels(torch.from_numpy(ref), torch.from_numpy(new), k)
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


def test_greedy_ties_take_the_first_cell_like_jax():
    conf = np.array([[2, 2, 0], [2, 2, 0], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(
        _np(tracking._greedy_perm(torch.from_numpy(conf))),
        np.asarray(jtracking._greedy_perm(jnp.asarray(conf))))


def test_label_tracking_stable_under_permutation_and_noop():
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, 3, size=40))
    tracker = tracking.LabelTracker(3)
    _bitwise(tracker.update(labels), labels)
    relabelled = torch.tensor([2, 0, 1])[labels]
    np.testing.assert_array_equal(_np(tracker.update(relabelled)), _np(labels))
    np.testing.assert_array_equal(_np(tracker.update(tracker.ref)), _np(labels))
    assert tracking.label_churn(labels, relabelled) == jtracking.label_churn(
        _np(labels), _np(relabelled))
    assert tracking.label_churn([], []) == 0.0
    with pytest.raises(ValueError, match="shapes"):
        tracking.label_churn(labels, labels[:3])


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def test_graph_store_from_numpy_round_trips():
    sj, _, _ = _padded_pair()
    sj, _, _ = jgs.apply_edge_batch(sj, jgs.make_edge_batch([[1, 2]], [0.5]))
    st = convert.graph_store_from_numpy(sj.src, sj.dst, sj.weight, sj.deg,
                                        sj.deg_dirty, sj.num_nodes, device=CPU)
    for f in ("src", "dst", "weight", "deg"):
        _bitwise(getattr(st, f), getattr(sj, f))
    assert st.deg_dirty is True and st.num_nodes == sj.num_nodes
    _same_store(jgs.refresh_degrees(sj), gs.refresh_degrees(st))


def test_edge_batch_from_numpy_round_trips():
    bj = jgs.make_edge_batch([[1, 2], [5, 3]], [0.5, 0.0], pad_to=4)
    bt = convert.edge_batch_from_numpy(*bj, device=CPU)
    for f in ("src", "dst", "weight"):
        _bitwise(getattr(bt, f), getattr(bj, f))


def test_eigen_estimate_from_numpy_round_trips():
    _, _, v = _padded_pair()
    ej = jupdates.EigenEstimate(lam=jnp.arange(3.0), v=jnp.asarray(v[:, :3]),
                                drift=jnp.asarray(0.25))
    et = convert.eigen_estimate_from_numpy(*ej, device=CPU)
    for f in ("lam", "v", "drift"):
        _bitwise(getattr(et, f), getattr(ej, f))
