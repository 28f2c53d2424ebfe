"""The port's edge-sharded paths (``repro_torch.core.distributed``,
``parallel``, the sharded probe, tick and service) against the JAX
package, on S = 2 and S = 4 CPU ranks over gloo.

One world per shard count is spawned once for the module
(``parallel.run_ranks``); every rank runs all cases
(tests/torch_dist_ranks.py) and returns numpy.  In tier-1 JAX sees one
CPU device, so each output is held to JAX's function on that 1-device
mesh where it has one and to JAX's single-device function, within the
JAX package's sharded contract (``TOL`` = 1e-5 max-abs for matvecs,
series, solves from one panel and ticks; the service script with
tests/test_torch_service.py's ``RES_TOL`` on residuals after several
ticks).  Draw-dependent operators take the JAX draws of every shard
(``split(key, S)[s]``) and are held to the mean of JAX's single-shard
estimates.  Layouts are bitwise, and panels are bitwise equal across
ranks.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.compat import default_edge_mesh
from repro.core import distributed as jdist
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import operators as jops
from repro.core import program as jprogram
from repro.core import series as jseries
from repro.core import solvers as jsolvers
from repro.core import walks as jwalks
from repro.kernels.edge_spmm import ops as jes_ops
from repro.spectral import probes as jprobes
from repro.stream import graph_store as jgs
from repro.stream import service as jservice
from repro.stream import sharded as jsharded
from repro_torch import parallel
from repro_torch.core import backend, distributed, program
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.stream import graph_store as gs
from repro_torch.stream import sharded
from repro_torch.stream.service import ServiceConfig

CPU = "cpu"
TOL = 1e-5
RES_TOL = 1e-4
MB_BATCH, MB_DEGREE = 64, 5
WALKERS, WALK_COEFFS = 2000, (0.3, -0.5, 0.2)


def _jgraph(name: str):
    edges, w, n, cap = ranks.case_arrays(name)
    g = jlap.make_edge_list(edges, n, weights=w)
    return jlap.pad_edge_list(g, cap) if cap else g


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def mesh1():
    return default_edge_mesh()


# ---------------------------------------------------------------------------
# the worlds: every case runs once per shard count
# ---------------------------------------------------------------------------

def _inputs(num_shards: int) -> dict:
    """The numpy inputs of every rank: probe vectors, JAX's per-shard
    draws, tick and service panels."""
    key = jax.random.PRNGKey(11)
    probe_v0 = np.stack([np.asarray(jax.random.normal(k, (96,), jnp.float32))
                         for k in jax.random.split(key, 4)], axis=1)
    gc, _ = jgraphs.clique_graph(120, 3, seed=0)
    e = gc.num_edges
    kmb = jax.random.PRNGKey(21)
    sel = np.zeros((num_shards, MB_DEGREE + 1, MB_BATCH), np.int64)
    for i in range(MB_DEGREE + 1):
        keys = jax.random.split(jax.random.fold_in(kmb, i), num_shards)
        for s in range(num_shards):
            sel[s, i] = np.asarray(jax.random.randint(keys[s], (MB_BATCH,), 0, e))
    gr, _ = jgraphs.ring_of_cliques(3, 4)
    inc = jlap.build_edge_incidence(gr)
    deg = len(WALK_COEFFS) - 1
    wkeys = jax.random.split(jax.random.PRNGKey(31), num_shards)
    walks = [tuple(np.asarray(x) for x in jwalks.sample_walks(
        wkeys[s], inc, WALKERS, max(deg, 2))) for s in range(num_shards)]
    coins = np.stack([np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(wkeys[s], 1000 + p), (WALKERS,)))
        for p in range(1, deg + 1)]) for s in range(num_shards)])
    tick_graphs = [ranks.rand_edges(3 + i, 96, 260) for i in range(2)]
    return {
        "probe_v0": probe_v0,
        "draws": {"batch": MB_BATCH, "sel": sel, "walks": walks,
                  "coins": coins, "coeffs": WALK_COEFFS, "walkers": WALKERS,
                  "walk_keys": np.asarray(wkeys)},
        "tick": {"graphs": tick_graphs, "cs": [0.02, 0.035],
                 "vs": np.stack([ranks.panel(60 + i, 96, 4) for i in range(2)]),
                 "lrs": [0.3, 0.2]},
        "resume": _resume_panels(),
    }


def _resume_panels() -> dict:
    """The service script's admission panels (probing off)."""
    resume = {sid: ranks.panel(40 + i, g.num_nodes, 5)
              for i, (sid, g) in enumerate(ranks.service_graphs().items())}
    resume["empty"] = ranks.panel(50, 40, 4)
    return resume


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def world(request):
    num_shards = request.param
    inputs = _inputs(num_shards)
    results = parallel.run_ranks(num_shards, ranks.run_all, inputs,
                                 device=CPU, timeout=300.0)
    return SimpleNamespace(S=num_shards, inputs=inputs,
                           outs=[r.value for r in results],
                           launches=parallel.sum_launches(
                               r.launches for r in results))


def _all_ranks(world, key: str):
    """Every rank's output for ``key``, asserted bitwise equal across the
    ranks (every rank receives the same reduced panels); returns rank 0's."""
    vals = [o[key] for o in world.outs]
    if isinstance(vals[0], dict):
        for k in vals[0]:
            assert parallel.bitwise_equal([v[k] for v in vals]), (key, k)
    else:
        assert parallel.bitwise_equal(vals), key
    return vals[0]


def test_world_shards_and_indices(world):
    assert [o["sidx"] for o in world.outs] == list(range(world.S))
    assert all(o["shards"] == world.S for o in world.outs)
    assert all(c == 0 for c in world.launches.values())  # the CPU twins


# ---------------------------------------------------------------------------
# operators: matvec, blocked matvec, the series on both routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_operators(mesh1):
    out = {}
    for name in ranks.CASE_NAMES:
        g = _jgraph(name)
        v = jnp.asarray(ranks.panel(6, g.num_nodes, 4))
        out[f"{name}/matvec"] = (jops.edge_matvec(g, backend="segment")(v),)
        if name == "weighted":  # a shard_map build costs ~2 s here
            out[f"{name}/matvec"] += (jdist.sharded_laplacian_matvec(mesh1)(
                g.src, g.dst, g.weight, v),)
        rho = float(jlap.spectral_radius_upper_bound(g))
        for key, s in (("series", jseries.limit_neg_exp(7, scale=1.2 / rho)),
                       ("series_blocked",
                        jseries.limit_neg_exp(9, scale=1.0 / rho))):
            out[f"{name}/{key}"] = (
                jdist.distributed_series_operator(mesh1, g, s,
                                                  backend="segment")(v),
                jops.edge_series_operator(g, s, backend="segment")(v))
    return out


@pytest.mark.parametrize("name", ranks.CASE_NAMES)
@pytest.mark.parametrize("kind", ["matvec", "blocked", "series",
                                  "series_blocked"])
def test_sharded_operator_matches_jax(world, jax_operators, name, kind):
    got = _all_ranks(world, f"{name}/{kind}")
    ref = "matvec" if kind == "blocked" else kind
    for want in jax_operators[f"{name}/{ref}"]:
        assert _maxabs(got, want) <= TOL, (name, kind)


@pytest.mark.parametrize("name", ranks.CASE_NAMES)
def test_series_issues_one_all_reduce_per_factor(world, name):
    for o in world.outs:
        assert o[f"{name}/series_psums"] == (7, 0)


def test_several_edge_axes_reduce_in_their_group(world, jax_operators):
    """A ("pod", "data") mesh: sharding over both axes (S shards) and
    over "data" alone (S / 2 shards, two groups) give the same series."""
    want = jax_operators["non_aligned/series"][1]
    pods = 2 if world.S % 2 == 0 else 1
    for axes, shards in (("pod+data", world.S), ("data", world.S // pods)):
        got = _all_ranks(world, f"axes/{axes}")
        assert _maxabs(got, want) <= TOL, axes
        assert {o[f"axes/{axes}/shards"] for o in world.outs} == {shards}
        assert sorted(o[f"axes/{axes}/sidx"] for o in world.outs) == sorted(
            list(range(shards)) * (world.S // shards))


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def test_distributed_solve_matches_jax(world, mesh1):
    g = _jgraph("weighted")
    rho = float(jlap.spectral_radius_upper_bound(g))
    s = jseries.limit_neg_exp(7, scale=1.2 / rho)
    cfg = jsolvers.SolverConfig(method="mu_eg", lr=0.3, steps=10, eval_every=5,
                                k=4, seed=0, backend="segment")
    init = jnp.asarray(ranks.panel(12, g.num_nodes, 4))
    single, _ = jsolvers.run_solver(
        jops.edge_series_operator(g, s, backend="segment"), g.num_nodes, cfg,
        init_v=init)
    meshed, _ = jdist.distributed_solve(mesh1, g, s, cfg, backend="segment",
                                        init_v=init)
    got = _all_ranks(world, "solve/v")
    assert _maxabs(got, single.v) <= TOL
    assert _maxabs(got, meshed.v) <= TOL


def test_distributed_solve_recovers_cliques(world):
    """The sharded solve meets the clustering bars: the panel spans the
    bottom-3 eigenvectors of dense eigh (tests/test_distributed.py's 0.08)
    and the labels recover the cliques (tests/test_clustering.py's > 0.95)."""
    _all_ranks(world, "clique/v")
    err = _all_ranks(world, "clique/subspace_error")
    assert err[-1] < 0.08, err
    assert min(o["clique/agreement"] for o in world.outs) > 0.95


# ---------------------------------------------------------------------------
# the sharded probe
# ---------------------------------------------------------------------------

def test_sharded_probe_matches_jax(world, mesh1):
    g = _jgraph("weighted")
    key = jax.random.PRNGKey(11)
    n_real = jnp.asarray(g.num_nodes, jnp.int32)
    refs = (jprobes.probe_edge_arrays(g.src, g.dst, g.weight, key, n_real,
                                      num_nodes=g.num_nodes),
            jprobes.probe_sharded_edge_arrays(mesh1, g.src, g.dst, g.weight,
                                              key, n_real,
                                              num_nodes=g.num_nodes))
    ritz = _all_ranks(world, "probe/ritz")
    lam = _all_ranks(world, "probe/lambda_max")
    trace = _all_ranks(world, "probe/trace")
    for want in refs:
        assert abs(lam - float(want.lambda_max)) <= 1e-4 * float(want.lambda_max)
        assert abs(trace - float(want.trace)) <= 1e-4 * float(want.trace)
        np.testing.assert_allclose(ritz, np.asarray(want.ritz), atol=1e-3)


# ---------------------------------------------------------------------------
# the stochastic operators: each rank its own draw, averaged
# ---------------------------------------------------------------------------

def test_minibatch_operator_is_the_mean_of_jax_shards(world):
    gc, _ = jgraphs.clique_graph(120, 3, seed=0)
    rho = float(jlap.spectral_radius_upper_bound(gc))
    s = jseries.limit_neg_exp(MB_DEGREE, scale=2.0 / rho)
    sel = jnp.asarray(world.inputs["draws"]["sel"])

    def keyed(i, u):  # i may be traced (the series' fori_loop)
        return sum(jlap.minibatch_laplacian_matvec(
            gc.src[sel[r, i]], gc.dst[sel[r, i]], gc.weight[sel[r, i]], u,
            gc.num_edges) for r in range(world.S)) / world.S

    v = jnp.asarray(ranks.panel(14, 120, 3))
    want = np.asarray(s.lambda_star * v - s.apply_fn(keyed, v))
    got = _all_ranks(world, "minibatch")
    assert _maxabs(got, want) <= TOL * max(1.0, float(np.abs(want).max()))
    drawn = _all_ranks(world, "minibatch/drawn")
    assert np.isfinite(drawn).all() and _maxabs(drawn, got) > 0


@pytest.mark.parametrize("mode", ["importance", "rejection"])
def test_walk_operator_is_the_mean_of_jax_shards(world, mode):
    gr, _ = jgraphs.ring_of_cliques(3, 4)
    inc = jlap.build_edge_incidence(gr)
    v = jnp.eye(gr.num_nodes)
    keys = world.inputs["draws"]["walk_keys"]
    est = 0.0
    for s in range(world.S):
        wb = jwalks.WalkBatch(*(jnp.asarray(a)
                                for a in world.inputs["draws"]["walks"][s]))
        acc = WALK_COEFFS[0] * v
        for p in range(1, len(WALK_COEFFS)):
            acc = acc + WALK_COEFFS[p] * jwalks.estimate_power_matvec(
                wb, gr, inc, p, v, mode=mode,
                key=jax.random.fold_in(jnp.asarray(keys[s]), 1000 + p))
        est = est + acc / world.S
    want = np.asarray(0.7 * v - est)
    got = _all_ranks(world, f"walks/{mode}")
    assert _maxabs(got, want) <= TOL * max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the edge-sharded group tick
# ---------------------------------------------------------------------------

def test_sharded_tick_matches_jax(world):
    t = world.inputs["tick"]
    stores = [jgs.from_edge_list(jlap.make_edge_list(e, 96, weights=w),
                                 capacity=512) for e, w in t["graphs"]]
    stack = lambda f: jnp.stack([f(st) for st in stores])  # noqa: E731
    tick = jprogram.build_tick_program(jprogram.StepSchedule(
        degree=5, steps=4, backend="segment"))
    vs, res = tick(stack(lambda st: st.src), stack(lambda st: st.dst),
                   stack(lambda st: st.weight), jnp.asarray(t["vs"]),
                   jnp.asarray(t["cs"], jnp.float32),
                   jnp.asarray(t["lrs"], jnp.float32),
                   jnp.asarray(ranks.TICK_CHUNKS, jnp.int32))
    assert _maxabs(_all_ranks(world, "tick/vs"), vs) <= TOL
    assert _maxabs(_all_ranks(world, "tick/res"), res) <= TOL


def test_sharded_tick_counts_and_captures_nothing(world):
    """degree plain all_reduces per dilated apply: (steps x max chunks +
    the residual evaluation) applies; an eager program captures none."""
    applies = 4 * max(ranks.TICK_CHUNKS) + 1
    for o in world.outs:
        assert o["tick/psums"] == (5 * applies, 0)
        assert o["tick/captures"] == 0


def test_tuple_psum_is_one_fused_all_reduce(world):
    total = sum(range(world.S))
    a, b = (_all_ranks(world, f"psum/tuple/{i}") for i in range(2))
    np.testing.assert_array_equal(a, np.full((3,), total, np.float32))
    np.testing.assert_array_equal(b, np.full((2, 2), 2 * total, np.float32))
    assert all(o["psum/tuple_counts"] == (0, 1) for o in world.outs)


# ---------------------------------------------------------------------------
# the edge-sharded service against JAX's single-device service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_service_run():
    resume = _resume_panels()
    svc = jservice.StreamingService(jservice.ServiceConfig(
        backend="segment", **ranks.service_common()))
    g_sbm, _ = jgraphs.sbm_graph(120, 3, p_in=0.35, p_out=0.03, seed=1)
    jgraphs_ = {"weighted": _jgraph("weighted"), "capacity_padded": g_sbm,
                "non_aligned": _jgraph("non_aligned")}
    for sid, g in jgraphs_.items():
        svc.add_graph(sid, g, resume_panel=resume[sid])
    run = {"tick1": svc.tick(),
           "panels1": {sid: np.asarray(svc.panel(sid))
                       for sid in svc.session_ids()}}
    stats = svc.apply_updates("weighted", *ranks.UPDATE)
    run["stats"] = tuple(int(x) for x in stats)
    run["ticks"] = [svc.tick() for _ in range(ranks.SCRIPT_TICKS)]
    summary = svc.evict("non_aligned")
    run["evicted"] = (summary["residual"], summary["ticks"], summary["panel"])
    run["until"] = svc.run_until_converged(max_ticks=ranks.UNTIL_TICKS)
    run["info"] = {sid: svc.session_info(sid) for sid in svc.session_ids()}
    run["counters"] = (svc.tick_invocations, svc.device_work,
                       svc.compile_count)
    empty = jservice.StreamingService(jservice.ServiceConfig(
        backend="segment", **dict(ranks.service_common(), k=4, degree=5,
                                  steps_per_tick=3)))
    empty.add_graph("empty", jlap.make_edge_list(np.zeros((0, 2), np.int64),
                                                 40),
                    resume_panel=resume["empty"])
    run["empty/tick"] = empty.tick()
    run["empty/v"] = np.asarray(empty.panel("empty"))
    return run


def test_sharded_service_script_matches_jax(world, jax_service_run):
    want = jax_service_run
    o = world.outs[0]
    assert all(x["svc/capacities_balanced"] for x in world.outs)
    for sid, r in want["tick1"].items():
        assert abs(o["svc/tick1"][sid] - r) <= TOL, sid
        assert _maxabs(_all_ranks(world, "svc/panels1")[sid],
                       want["panels1"][sid]) <= TOL, sid
    assert o["svc/stats"] == want["stats"]
    for got_t, want_t in zip(o["svc/ticks"], want["ticks"]):
        assert got_t.keys() == want_t.keys()
        for sid in want_t:
            assert abs(got_t[sid] - want_t[sid]) <= RES_TOL, sid
    res, ticks, pnl = o["svc/evicted"]
    assert ticks == want["evicted"][1]
    assert abs(res - want["evicted"][0]) <= RES_TOL
    assert _maxabs(pnl, want["evicted"][2]) <= RES_TOL
    assert o["svc/until"] == want["until"]
    for sid, ji in want["info"].items():
        ti = o["svc/info"][sid]
        for f in ("converged", "ticks", "degree", "family", "solves",
                  "edge_capacity", "num_edges"):
            assert ti[f] == ji[f], (sid, f)
        assert abs(ti["residual"] - ji["residual"]) <= RES_TOL, sid
    invocations, work, programs, captures = o["svc/counters"]
    assert (invocations, work, programs) == want["counters"]
    assert captures == 0
    for x in world.outs[1:]:
        assert x["svc/counters"] == o["svc/counters"]
        assert x["svc/info"] == o["svc/info"]


def test_sharded_edgeless_admission(world, jax_service_run):
    """Every shard's slice all padding: the tick gives the one-device
    panel, finite, on every rank."""
    v = _all_ranks(world, "empty/v")
    assert np.isfinite(v).all()
    assert _maxabs(v, jax_service_run["empty/v"]) <= TOL
    assert world.outs[0]["empty/tick"].keys() == \
        jax_service_run["empty/tick"].keys()


# ---------------------------------------------------------------------------
# host-side layouts (no world needed)
# ---------------------------------------------------------------------------

FIELDS = ("u_local", "other", "weight", "chunk_block", "deg", "block_n",
          "block_e", "num_chunks", "num_nodes", "num_shards")


def _assert_same_blocking(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, int):
            assert a == b, f
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert got.block_chunks.shape == (got.num_shards, got.num_blocks + 1)


@pytest.mark.parametrize("num_shards", [1, 4, 8])
@pytest.mark.parametrize("name", ranks.CASE_NAMES)
def test_sharded_node_blocking_bitwise_and_sums_to_the_matvec(name, num_shards):
    gj = jdist.pad_edges_for_mesh(_jgraph(name), num_shards)
    edges, w, n, cap = ranks.case_arrays(name)
    gt = lap.make_edge_list(edges, n, weights=w, device=CPU)
    gt = distributed.pad_edges_for_mesh(
        lap.pad_edge_list(gt, cap) if cap else gt, num_shards)
    for a, b in zip((gt.src, gt.dst, gt.weight), (gj.src, gj.dst, gj.weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sb = backend.sharded_blocking_for(gt, num_shards, block_n=64)
    _assert_same_blocking(sb, jes_ops.build_sharded_node_blocking(
        gj.src, gj.dst, gj.weight, n, num_shards, block_n=64))
    v = torch.from_numpy(ranks.panel(3, n, 4))
    acc = sum(es_ops.edge_spmm_blocked(sb.shard(s), v)
              for s in range(num_shards))
    want = lap.laplacian_dense(gt) @ v
    assert _maxabs(acc, want) <= TOL


def test_all_padding_shard_contributes_exact_zeros():
    g = distributed.pad_edges_for_mesh(
        lap.make_edge_list(np.array([[0, 1], [1, 2], [2, 3]]), 40, device=CPU), 8)
    sb = backend.sharded_blocking_for(g, 8, block_n=16)
    v = torch.from_numpy(ranks.panel(4, 40, 3))
    per = g.num_edges // 8
    for s in (3, 7):
        out = es_ops.edge_spmm_blocked(sb.shard(s), v)
        assert torch.equal(out, torch.zeros_like(v))
        sl = slice(s * per, (s + 1) * per)
        for out in (es_ops.edge_spmm(g.src[sl], g.dst[sl], g.weight[sl], v),
                    lap.edge_matvec_arrays(g.src[sl], g.dst[sl],
                                           g.weight[sl], v)):
            assert torch.equal(out, torch.zeros_like(v))


def test_edgeless_store_sharded_blocking_matches_jax():
    gt = lap.make_edge_list(np.zeros((0, 2), np.int64), 32, device=CPU)
    gj = jlap.make_edge_list(np.zeros((0, 2), np.int64), 32)
    st = gs.from_edge_list(gt, capacity=256)
    sb = gs.sharded_node_blocking(st, 8, block_n=16)
    _assert_same_blocking(sb, jgs.sharded_node_blocking(
        jgs.from_edge_list(gj, capacity=256), 8, block_n=16))
    assert sb.num_chunks == es_ops.next_pow2(sb.num_blocks)
    v = torch.from_numpy(ranks.panel(5, 32, 2))
    for s in range(8):
        assert torch.equal(es_ops.edge_spmm_blocked(sb.shard(s), v),
                           torch.zeros_like(v))


def test_unbalanced_buffer_is_refused():
    edges, w, n, _ = ranks.case_arrays("weighted")
    g = lap.make_edge_list(edges, n, weights=w, device=CPU)
    assert g.num_edges % 7 != 0
    with pytest.raises(ValueError, match="pad_edges_for_mesh"):
        backend.sharded_blocking_for(g, 7)
    with pytest.raises(ValueError, match="num_shards"):
        backend.sharded_blocking_for(g, 0)


def test_balanced_capacity_equals_jax():
    for cap in (1, 7, 256, 1000, 1 << 20):
        for s in (0, 1, 2, 3, 4, 7, 8):
            assert sharded.balanced_capacity(cap, s) == \
                jsharded.balanced_capacity(cap, s)


def test_panel_sharding_refused_naming_slice_7b():
    """Panel sharding is ported (tests/test_torch_model_sharded.py); what
    it still refuses: model_axes without a mesh, and axes the mesh lacks.
    A mesh with model_axes builds the panel-sharded program."""
    with pytest.raises(ValueError, match="requires a mesh"):
        ServiceConfig(model_axes=("model",))
    with pytest.raises(ValueError, match="needs a mesh"):
        program.build_tick_program(program.StepSchedule(), CPU,
                                   model_axes=("model",))
    with pytest.raises(ValueError, match="mesh axes"):
        ServiceConfig(mesh=SimpleNamespace(mesh_dim_names=("data",)),
                      model_axes=("model",))
    with ranks.one_rank_world() as mesh:
        data_only = parallel.make_mesh((1,), ("data",), CPU)
        with pytest.raises(ValueError, match="mesh axes"):
            program.build_tick_program(program.StepSchedule(), CPU,
                                       mesh=data_only, model_axes=("model",))
        prog = program.build_tick_program(program.StepSchedule(), CPU,
                                          mesh=mesh, model_axes=("model",))
        assert isinstance(prog, program.ModelShardedTickProgram)
        assert (prog.num_shards, prog.shard, prog.captures) == (1, 0, 0)
        assert ServiceConfig(mesh=mesh, model_axes=("model",)).model_axes == \
            ("model",)
