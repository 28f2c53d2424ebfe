"""The port's solve programs (``repro_torch.core.program``) against the
JAX package: the batched group tick, its block-diagonal layout, and the
host-side schedule helpers and forecasts.

Both packages get the same numpy edge buffers, panels, dilation scales
and learning rates.  Tolerances: panels and residuals of a batched tick
to 1e-5 max-abs (the TOL of tests/test_backend.py; the port folds c into
the weights, ``(c w) x`` where JAX computes ``c (w x)``, and sums in
another order); the layout is bitwise equal to ``build_edge_rows`` of
the block-diagonal c-scaled edge list; the schedule helpers and
forecasts are equal float for float (the same host arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks
from repro.core import laplacian as jlap
from repro.core import program as jprogram
from repro.spectral import plan as jplan
from repro_torch.core import graphs, operators, program, solvers
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.spectral import plan as tplan

CPU = "cpu"
TOL = 1e-5


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


def _rand_edges(seed: int, n: int, e: int):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    return edges, w


def _group_buffers(seeds, n: int, e: int):
    """(G, cap) padded numpy buffers of random graphs, through the JAX
    package's make_edge_list/pad_edge_list."""
    gs_ = []
    for s in seeds:
        edges, w = _rand_edges(s, n, e)
        gs_.append(jlap.make_edge_list(edges, n, weights=w))
    cap = max(g.num_edges for g in gs_)
    gs_ = [jlap.pad_edge_list(g, cap) for g in gs_]
    return tuple(np.stack([np.asarray(getattr(g, f)) for g in gs_])
                 for f in ("src", "dst", "weight"))


def _panels(seeds, n: int, k: int) -> np.ndarray:
    return np.stack([np.linalg.qr(np.random.default_rng(s).normal(
        size=(n, k)))[0] for s in seeds]).astype(np.float32)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype))


def _rows(src, dst, w, n: int) -> list:
    """Each member's own row CSR from (G, cap) buffers."""
    return [es_ops.build_edge_rows(_t(s), _t(d), _t(x), n)
            for s, d, x in zip(src, dst, w)]


@pytest.mark.parametrize("method", ["mu_eg", "oja"])
@pytest.mark.parametrize("chunks", [2, (1, 2, 3)], ids=["scalar", "per_session"])
def test_batched_tick_matches_jax(method, chunks):
    """One port tick == JAX's segment build_tick_program on the same
    buffers, panels, cs and lrs, for a scalar multiplier and for
    per-session (G,) chunk budgets (members freeze past their own)."""
    src, dst, w = _group_buffers((10, 11, 12), 40, 150)
    vs = _panels((20, 21, 22), 40, 4)
    cs = np.asarray([0.01, 0.02, 0.04], np.float32)
    lrs = np.asarray([0.1, 0.3, 0.5], np.float32)
    jfn = jprogram.build_tick_program(
        jprogram.StepSchedule(method=method, degree=5, steps=3))
    jv, jres = jfn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                   jnp.asarray(vs), jnp.asarray(cs), jnp.asarray(lrs),
                   jnp.asarray(chunks, jnp.int32))
    prog = program.build_tick_program(
        program.StepSchedule(method=method, degree=5, steps=3), CPU)
    tv, tres = prog(_rows(src, dst, w, 40), _t(cs), _t(vs), _t(lrs), chunks)
    assert tv.shape == (3, 40, 4) and tres.shape == (3,)
    assert float(np.max(np.abs(tv.numpy() - np.asarray(jv)))) <= TOL
    assert float(np.max(np.abs(tres.numpy() - np.asarray(jres)))) <= TOL


def test_tick_with_zero_chunks_only_evaluates():
    src, dst, w = _group_buffers((13, 14), 32, 100)
    vs = _panels((23, 24), 32, 3)
    prog = program.build_tick_program(
        program.StepSchedule(degree=3, steps=2), CPU)
    tv, tres = prog(_rows(src, dst, w, 32), [0.02, 0.03], _t(vs), [0.3, 0.3], 0)
    np.testing.assert_array_equal(tv.numpy(), vs)
    assert bool(torch.all(torch.isfinite(tres)))


def _hub_group():
    """A three-member group whose middle member is a star of 70 leaves
    (its centre's row, 70 entries, is past HUB_THRESHOLD) plus a power-law
    member: the layout must list the hubs of every member."""
    n = 128
    star = np.stack([np.zeros(70, np.int64), np.arange(1, 71)], 1)
    edges, w = _rand_edges(0, n, 200)
    members = [
        lap.make_edge_list(edges, n, weights=w, device=CPU),
        lap.make_edge_list(star, n, device=CPU),
        graphs.power_law_graph(n, avg_degree=8, alpha=2.0, seed=1,
                               device=CPU),
    ]
    cap = max(g.num_edges for g in members) + 17
    members = [lap.pad_edge_list(g, cap) for g in members]
    return members, n


def _member_rows(members, n: int) -> list:
    return [es_ops.build_edge_rows(g.src, g.dst, g.weight, n) for g in members]


def test_group_layout_is_the_block_diagonal_c_scaled_edge_list():
    members, n = _hub_group()
    cs = torch.tensor([0.5, 0.25, 2.0])
    rows = program.group_edge_rows(_member_rows(members, n), cs)
    # the same edges as one edge list: live slots only, member i's nodes
    # moved to i * n + ..., weights times c_i, in the buffers' order
    src, dst, w = [], [], []
    for i, g in enumerate(members):
        live = g.weight != 0
        src.append(g.src[live] + i * n)
        dst.append(g.dst[live] + i * n)
        w.append(g.weight[live] * cs[i])
    want = es_ops.build_edge_rows(torch.cat(src), torch.cat(dst),
                                  torch.cat(w), 3 * n)
    torch.testing.assert_close(rows.row_ptr, want.row_ptr, rtol=0, atol=0)
    live = int(want.row_ptr[-1])
    assert int(rows.row_ptr[-1]) == live
    torch.testing.assert_close(rows.other[:live], want.other[:live],
                               rtol=0, atol=0)
    torch.testing.assert_close(rows.weight[:live], want.weight[:live],
                               rtol=0, atol=0)
    hubs = rows.hub_rows[rows.hub_rows < 3 * n]
    torch.testing.assert_close(hubs, want.hub_rows[want.hub_rows < 3 * n],
                               rtol=0, atol=0)
    # the hub list is ONE ascending list ending in sentinels (the kernel
    # stops at the first), and it holds a hub of the second member
    assert bool(torch.all(hubs[1:] > hubs[:-1]))
    assert bool(torch.all(rows.hub_rows[len(hubs):] == 3 * n))
    assert int(n) in hubs.tolist()
    lengths = (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()
    assert set(hubs.tolist()) == set(
        torch.nonzero(lengths > es_ops.HUB_THRESHOLD)[:, 0].tolist())
    # the layout is that of build_edge_rows over all 2 G cap slots (its
    # shapes and hub list too), and depends only on (G, cap, n): other
    # members and c refill the same buffers, dead entries zeroed
    def slot_list(ms, scales):
        return es_ops.build_edge_rows(
            torch.cat([g.src + i * n for i, g in enumerate(ms)]),
            torch.cat([g.dst + i * n for i, g in enumerate(ms)]),
            torch.cat([g.weight * scales[i] for i, g in enumerate(ms)]), 3 * n)

    full = slot_list(members, cs)
    assert [t.shape for t in rows] == [t.shape for t in full]
    torch.testing.assert_close(rows.hub_rows, full.hub_rows, rtol=0, atol=0)
    cs3 = cs * 3
    other = program.group_edge_rows(_member_rows(members[::-1], n), cs3,
                                    out=rows)
    assert all(a is b for a, b in zip(other, rows))
    want = slot_list(members[::-1], cs3)
    live = int(want.row_ptr[-1])
    for name in ("row_ptr", "weight", "hub_rows"):
        torch.testing.assert_close(getattr(other, name), getattr(want, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(other.other[:live], want.other[:live],
                               rtol=0, atol=0)


def test_group_tick_equals_per_member_chunks():
    """The group tick == run_chunk on each member's own dilated operator,
    with a hub member and a different c and lr per member."""
    members, n = _hub_group()
    cs = [0.01, 0.02, 0.005]
    lrs = [0.2, 0.3, 0.4]
    vs = torch.from_numpy(_panels((30, 31, 32), n, 4))
    prog = program.build_tick_program(
        program.StepSchedule(degree=3, steps=4), CPU)
    out, res = prog(_member_rows(members, n), cs, vs, lrs, (2, 1, 2))
    for i, g in enumerate(members):
        op = operators.dilated_operator_arrays(g.src, g.dst, g.weight, cs[i],
                                               3, backend="segment")
        st = solvers.SolverState(v=vs[i], step=torch.zeros((), dtype=torch.int32))
        st, r = program.run_chunk(op, solvers.mu_eg_step, st, lrs[i],
                                  4 * (2, 1, 2)[i])
        assert float((out[i] - st.v).abs().max()) <= TOL, i
        assert abs(float(res[i]) - float(r)) <= TOL, i


def test_one_program_refills_its_layout_between_sub_batches():
    """Two sub-batches of one occupancy share a program: it refills its
    layout when a slot's rows or c differ from its last call (a rebuilt
    rows object counts as new), never when they repeat, and every call
    equals a fresh program's on the same inputs.  Other shapes raise."""
    members, n = _hub_group()
    rows = _member_rows(members, n)
    again = es_ops.build_edge_rows(members[0].src, members[0].dst,
                                   members[0].weight, n)
    vs = torch.from_numpy(_panels((40, 41), n, 4))
    sched = program.StepSchedule(degree=3, steps=2)
    prog = program.build_tick_program(sched, CPU)
    calls = [([rows[0], rows[1]], [0.01, 0.02], 1),
             ([rows[2], rows[1]], [0.005, 0.03], 2),
             ([rows[2], rows[1]], [0.005, 0.03], 2),
             ([rows[0], rows[1]], [0.01, 0.02], 3),
             ([rows[0], rows[1]], [0.01, 0.04], 4),
             ([again, rows[1]], [0.01, 0.04], 5)]
    for member_rows, cs, fills in calls:
        got = prog(member_rows, cs, vs, [0.3, 0.2], (2, 1))
        assert prog.layout_fills == fills
        want = program.build_tick_program(sched, CPU)(
            member_rows, cs, vs, [0.3, 0.2], (2, 1))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        prog(rows, [0.01, 0.02, 0.03], vs, [0.3, 0.2, 0.1], 1)


def test_sharded_ticks_raise_naming_slice_7():
    # the edge-sharded tick (mesh) is tests/test_torch_distributed.py's and
    # the panel-sharded one (mesh, model_axes) tests/test_torch_model_
    # sharded.py's; here: what build_tick_program refuses and builds
    sched = program.StepSchedule()
    with pytest.raises(ValueError, match="needs a mesh"):
        program.build_tick_program(sched, CPU, model_axes=("model",))
    with pytest.raises(AttributeError):  # a mesh must be a DeviceMesh
        program.build_tick_program(sched, CPU, mesh=object())
    with pytest.raises(AttributeError):
        program.build_tick_program(sched, CPU, mesh=object(),
                                   model_axes=("model",))
    with torch_dist_ranks.one_rank_world() as mesh:
        with pytest.raises(ValueError, match="mesh axes"):
            program.build_tick_program(sched, CPU, mesh=mesh,
                                       model_axes=("pod",))
        prog = program.build_tick_program(sched, CPU, mesh=mesh,
                                          model_axes=("model",))
        assert isinstance(prog, program.ModelShardedTickProgram)
        assert isinstance(program.build_tick_model_sharded(sched, mesh,
                                                           device=CPU),
                          program.ModelShardedTickProgram)
        assert not isinstance(program.build_tick_program(sched, CPU, mesh=mesh),
                              program.ModelShardedTickProgram)


def test_kernel_tick_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        program.build_tick_program(program.StepSchedule(backend="kernel"), CPU)


# ---------------------------------------------------------------------------
# host helpers: equal float for float
# ---------------------------------------------------------------------------

ANCHORS = [
    # (budget, rho_fallback, lam_k, lam_k1, tau_cap)
    (15, 10.0, 0.0, 8.0, None),  # wide gap: identity
    (15, 10.0, 1.0, 1.2, None),  # narrow: limit series
    (15, 10.0, 0.05, 0.2, 6.0),
    (15, 10.0, 2.0, 2.3, None),
    (7, 37.5, 0.3, 0.31, 8.0),
    (101, 3.0, 0.001, 0.002, None),
    (15, 0.0, None, None, None),  # edgeless: degenerate identity
]


@pytest.mark.parametrize("anchors", ANCHORS, ids=lambda a: "-".join(map(str, a)))
def test_schedule_helpers_equal_jax(anchors):
    budget, rho_fb, lam_k, lam_k1, tau_cap = anchors
    kw = dict(k=4, budget=budget, rho_fallback=rho_fb, lam_k=lam_k,
              lam_k1=lam_k1, tau_cap=tau_cap,
              families=("identity", "limit_neg_exp"))
    jp = jplan.plan_dilation(None, **kw)
    tp = tplan.plan_dilation(None, **kw)
    for base_lr in (0.1, 0.3):
        for normalized in (True, False):
            js = jprogram.StepSchedule.from_plan(
                jp, steps=10, base_lr=base_lr, max_degree=budget - 2,
                normalized=normalized)
            ts = program.StepSchedule.from_plan(
                tp, steps=10, base_lr=base_lr, max_degree=budget - 2,
                normalized=normalized)
            assert (ts.method, ts.degree, ts.steps, ts.lr, ts.backend) == \
                (js.method, js.degree, js.steps, js.lr, js.backend)
            assert ts.statics == js.statics
        assert program.session_lr(tp, base_lr) == jprogram.session_lr(jp, base_lr)
    assert program.wanted_scale(tp) == jprogram.wanted_scale(jp)
    for degree in (1, 7, 15):
        assert program.dilation_scale(tp, degree) == \
            jprogram.dilation_scale(jp, degree)
    assert program.LR_BOOST_CAP == jprogram.LR_BOOST_CAP


@pytest.mark.parametrize("max_degree", [1, 6, 7, 15, 41, 101, 251])
def test_schedule_degrees_equal_jax(max_degree):
    assert program.schedule_degrees(max_degree) == \
        jprogram.schedule_degrees(max_degree)


def test_forecasts_equal_jax_on_seeded_inputs():
    rng = np.random.default_rng(0)
    cases = [(float(a), float(b), int(s)) for a, b, s in zip(
        rng.uniform(1e-4, 1.0, 200), rng.uniform(1e-4, 1.0, 200),
        rng.integers(-1, 60, 200))]
    cases += [(float("inf"), 0.1, 20), (0.1, float("nan"), 20),
              (0.0, 0.0, 5), (0.4, 0.1, 0)]
    for prev, res, steps in cases:
        rate = program.contraction_rate(prev, res, steps)
        assert rate == jprogram.contraction_rate(prev, res, steps)
        for tol in (1e-3, 2e-3, 0.5):
            assert program.predicted_steps_to_tol(res, rate, tol) == \
                jprogram.predicted_steps_to_tol(res, rate, tol)
        if rate is not None:
            assert program.predicted_residual(res, rate, steps) == \
                jprogram.predicted_residual(res, rate, steps)
