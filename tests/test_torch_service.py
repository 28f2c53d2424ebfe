"""The port's multi-tenant streaming service
(``repro_torch.stream.service``) against the JAX package's, and the
service's own properties on the CPU (segment path).

A run in both packages starts every tenant from one numpy panel
(``resume_panel``) with probing off (the probes draw from jax.random and
torch.Generator), so both follow the same plans and the same scheduler
decisions: tick invocations, device work, multiplied ticks and converged
flags are equal, per-session residuals agree to 1e-4 (the panels agree
to ~1e-6 per tick; the residual of a converged session is read at
tolerance, so a rounding difference moves it little), and the labels of
the well-separated tenants meet the JAX test's agreement bar (> 0.9) in
both packages (the weak-structure tenants have no bar in the JAX fleet
test either).  The host helpers
(``_split_by_multiplier``, ``_tick_multipliers``) are equal exactly.
The property tests are counterparts of the JAX service tests in
tests/test_stream.py and tests/test_program.py, at their sizes and bars.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs
from repro.stream import service as jservice
from repro_torch.core import graphs, program
from repro_torch.core import laplacian as lap
from repro_torch.core.kmeans import cluster_agreement
from repro_torch.stream import service
from repro_torch.stream.service import (
    ServiceConfig, StreamingService, UnknownSessionError,
)

CPU = "cpu"
RES_TOL = 1e-4


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

SVC_KW = dict(k=4, num_clusters=3, degree=7, steps_per_tick=25, lr=0.3,
              tol=5e-3, dilation_strength=6.0)
SVC_CFG = ServiceConfig(**SVC_KW)
SVC = dataclasses.replace(SVC_CFG, steps_per_tick=10)


def _svc(cfg=SVC_CFG) -> StreamingService:
    return StreamingService(cfg, device=CPU)


# ---------------------------------------------------------------------------
# both packages
# ---------------------------------------------------------------------------

FLEET = [  # (sid, p_in, p_out, seed): fast and slow tenants
    ("fast0", 0.45, 0.01, 0), ("fast1", 0.45, 0.01, 1),
    ("slow0", 0.16, 0.06, 10), ("slow1", 0.16, 0.06, 11),
]


@pytest.mark.parametrize("schedule", ["residual_decay", "round_robin"])
def test_service_run_matches_jax(schedule):
    kw = dict(SVC_KW, steps_per_tick=10, tol=2e-3, probe_spectrum=False,
              tick_schedule=schedule)
    jsvc = jservice.StreamingService(jservice.ServiceConfig(**kw))
    tsvc = StreamingService(ServiceConfig(**kw), device=CPU)
    truths = {}
    for sid, p_in, p_out, seed in FLEET:
        jg, lab = jgraphs.sbm_graph(60, 3, p_in=p_in, p_out=p_out, seed=seed)
        tg, tlab = graphs.sbm_graph(60, 3, p_in=p_in, p_out=p_out, seed=seed,
                                    device=CPU)
        np.testing.assert_array_equal(np.asarray(lab), tlab)
        panel = np.random.default_rng(seed + 100).normal(
            size=(60, 4)).astype(np.float32)
        jsvc.add_graph(sid, jg, num_clusters=3, edge_capacity=1024,
                       resume_panel=panel)
        tsvc.add_graph(sid, tg, num_clusters=3, edge_capacity=1024,
                       resume_panel=panel)
        truths[sid] = tlab
    jsvc.run_until_converged(max_ticks=400)
    tsvc.run_until_converged(max_ticks=400)
    assert tsvc.all_converged and jsvc.all_converged
    assert tsvc.tick_invocations == jsvc.tick_invocations
    assert tsvc.device_work == jsvc.device_work
    assert tsvc.multiplied_ticks == jsvc.multiplied_ticks
    assert (schedule == "round_robin") == (tsvc.multiplied_ticks == 0)
    assert tsvc.compile_count == jsvc.compile_count
    agree = []
    for sid in truths:
        ji, ti = jsvc.session_info(sid), tsvc.session_info(sid)
        for f in ("converged", "ticks", "degree", "family", "solves"):
            assert ti[f] == ji[f], (sid, f)
        assert ti["lr"] == pytest.approx(ji["lr"], rel=1e-6)
        assert abs(ti["residual"] - ji["residual"]) <= RES_TOL, sid
        if sid.startswith("fast"):
            agree += [float(cluster_agreement(torch.from_numpy(np.array(
                labels)), truths[sid], 3))
                for labels in (tsvc.labels(sid), jsvc.labels(sid))]
    assert np.mean(agree) > 0.9, agree


def test_split_by_multiplier_equals_jax_on_seeded_inputs():
    rng = np.random.default_rng(0)
    for _ in range(300):
        g = int(rng.integers(1, 12))
        mults = rng.choice([1, 1, 2, 3, 4, 5, 8, 16], size=g).astype(np.int64)
        members = [f"m{i}" for i in range(g)]
        got = service._split_by_multiplier(members, mults)
        want = jservice._split_by_multiplier(members, mults)
        assert [(m, list(x)) for m, x in got] == \
            [(m, list(x)) for m, x in want]


@pytest.mark.parametrize("schedule", ["residual_decay", "round_robin"])
def test_tick_multipliers_equal_jax_on_seeded_inputs(schedule):
    kw = dict(SVC_KW, steps_per_tick=5, max_tick_multiplier=8,
              tick_schedule=schedule)
    tsvc = StreamingService(ServiceConfig(**kw), device=CPU)
    jsvc = jservice.StreamingService(jservice.ServiceConfig(**kw))
    rng = np.random.default_rng(1)
    members = []
    for _ in range(400):
        rate = rng.choice([None, 0.0, 1.0, 1.2, float(rng.uniform(0.5, 1.0)),
                           float(rng.uniform(0.99, 1.0))])
        residual = float(10 ** rng.uniform(-3.5, 0.0))
        members.append(SimpleNamespace(rate=rate, residual=residual))
    np.testing.assert_array_equal(tsvc._tick_multipliers(members),
                                  jsvc._tick_multipliers(members))


def test_node_capacity_class_equals_jax():
    for n in (1, 2, 40, 63, 64, 65, 200, 4096, 4097, 1 << 20):
        assert service.node_capacity_class(n) == \
            jservice.node_capacity_class(n)


# ---------------------------------------------------------------------------
# the service's own properties (counterparts of the JAX service tests)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eight_session_service():
    svc = _svc()
    truths = {}
    for i in range(8):
        g, lab = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=i,
                                  device=CPU)
        svc.add_graph(f"g{i}", g, num_clusters=3, edge_capacity=1024)
        truths[f"g{i}"] = lab
    svc.run_until_converged(max_ticks=120)
    return svc, truths


def test_service_eight_sessions_share_group_logarithmic_programs(
        eight_session_service):
    svc, truths = eight_session_service
    group_keys = {key for key, _ in svc._compiled}
    assert len(group_keys) == 1
    occs = {occ for _, occ in svc._compiled}
    assert all(occ == 1 << (occ.bit_length() - 1) for occ in occs)
    assert max(occs) <= 8
    assert svc.compile_count <= 4
    for sid in truths:
        assert svc.session_info(sid)["converged"], sid


def test_service_labels_recover_communities(eight_session_service):
    svc, truths = eight_session_service
    agree = [float(cluster_agreement(torch.from_numpy(svc.labels(sid)),
                                     truths[sid], 3)) for sid in truths]
    assert np.mean(agree) > 0.9, agree


def test_service_noop_update_keeps_labels_and_convergence(
        eight_session_service):
    svc, _ = eight_session_service
    before = svc.labels("g0")
    src, dst, w = svc.live_edges("g0")
    stats = svc.apply_updates("g0", [[int(src[0]), int(dst[0])]],
                              [float(w[0])], mode="set")
    info = svc.session_info("g0")
    assert int(stats.matched) == 1
    assert info["converged"] and info["fallbacks"] == 0
    np.testing.assert_array_equal(before, svc.labels("g0"))


def test_service_update_fallback_and_warm_reconverge(eight_session_service):
    svc, _ = eight_session_service
    programs = svc.compile_count
    src, dst, _ = svc.live_edges("g1")
    rng = np.random.default_rng(2)
    sel = rng.choice(len(src), size=len(src) // 4, replace=False)
    svc.apply_updates("g1", np.stack([src[sel], dst[sel]], 1),
                      np.zeros(len(sel)), mode="set")
    info = svc.session_info("g1")
    assert info["fallbacks"] == 1 and not info["converged"]
    ticks_before = info["ticks"]
    svc.run_until_converged(max_ticks=120)
    info = svc.session_info("g1")
    assert info["converged"]
    assert info["ticks"] - ticks_before <= ticks_before
    # the update and re-solve stayed in the one (class, degree) group, at
    # an occupancy bucket it had: no new program
    assert len({key for key, _ in svc._compiled}) == 1
    assert svc.compile_count == programs


def test_service_buffer_overflow_grows_capacity_class():
    svc = _svc(dataclasses.replace(SVC_CFG, steps_per_tick=5))
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    svc.add_graph("tiny", g, num_clusters=3, edge_capacity=64)
    n = g.num_nodes
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    stats = svc.apply_updates("tiny", pairs, np.full(len(pairs), 0.5))
    info = svc.session_info("tiny")
    assert info["edge_capacity"] == 256
    assert int(stats.dropped) == 0
    assert info["num_edges"] == len(pairs)


def test_service_overflow_grows_multiple_classes_without_loss():
    svc = _svc(dataclasses.replace(SVC_CFG, steps_per_tick=5))
    g, _ = graphs.ring_of_cliques(4, 10, device=CPU)
    svc.add_graph("burst", g, num_clusters=3, edge_capacity=256)
    n = g.num_nodes
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    stats = svc.apply_updates("burst", pairs, np.full(len(pairs), 0.5))
    info = svc.session_info("burst")
    assert int(stats.dropped) == 0
    assert info["edge_capacity"] == 1024  # 256 -> 512 -> 1024
    assert info["num_edges"] == len(pairs)


def test_add_graph_rejects_underprovisioned_k():
    svc = _svc()
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    with pytest.raises(ValueError, match="tracked"):
        svc.add_graph("bad", g, num_clusters=4)  # needs 5 > k=4


def test_edgeless_admission_recovers_after_updates():
    svc = _svc(dataclasses.replace(SVC_CFG, steps_per_tick=5))
    g0 = lap.make_edge_list(np.zeros((0, 2), np.int64), 40, device=CPU)
    svc.add_graph("empty", g0, num_clusters=3, edge_capacity=256)
    svc.apply_updates("empty", [[0, 1], [1, 2], [2, 3], [3, 0]],
                      [1.0, 1.0, 1.0, 1.0])
    res = svc.tick()["empty"]
    sess = svc._sessions["empty"]
    assert np.isfinite(res)
    assert sess.rho > 0.0
    assert bool(torch.all(torch.isfinite(sess.v)))


def test_unknown_session_raises_typed_error():
    svc = _svc(dataclasses.replace(SVC_CFG, steps_per_tick=5))
    g, _ = graphs.ring_of_cliques(3, 6, device=CPU)
    svc.add_graph("here", g, num_clusters=3)
    for fn in (svc.labels, svc.session_info, svc.evict, svc.panel,
               svc.live_edges, svc.capacity_class):
        with pytest.raises(UnknownSessionError, match="never"):
            fn("never")
    with pytest.raises(UnknownSessionError):
        svc.apply_updates("never", [[0, 1]], [1.0])
    assert issubclass(UnknownSessionError, KeyError)
    assert svc.has_session("here") and svc.session_ids() == ["here"]
    summary = svc.evict("here")
    assert summary["n"] == g.num_nodes
    assert not svc.has_session("here")
    with pytest.raises(UnknownSessionError, match="here"):
        svc.evict("here")
    with pytest.raises(UnknownSessionError, match="here"):
        svc.labels("here")
    with pytest.raises(ValueError, match="already exists"):
        svc.add_graph("x", g, num_clusters=3)
        svc.add_graph("x", g, num_clusters=3)


def test_converged_session_reenters_ticking_after_update():
    cfg = dataclasses.replace(SVC_CFG, steps_per_tick=25, tol=5e-4)
    svc = _svc(cfg)
    g, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=3, device=CPU)
    svc.add_graph("s", g, num_clusters=3, edge_capacity=1024)
    assert svc.run_until_converged(max_ticks=400) < 400
    info = svc.session_info("s")
    assert info["converged"] and info["residual"] <= cfg.tol
    svc.apply_updates("s", [[0, 25], [5, 30]], [0.02, 0.02], mode="add")
    info = svc.session_info("s")
    assert info["fallbacks"] == 0  # cheap path, not a re-solve
    assert not info["converged"]  # re-entered: residual re-measured
    assert info["residual"] > cfg.tol
    ticks_before = info["ticks"]
    assert svc.run_until_converged(max_ticks=400) < 400
    info = svc.session_info("s")
    assert info["converged"] and info["ticks"] > ticks_before


def test_mixed_contraction_group_schedules_per_session():
    cfg = dataclasses.replace(SVC_CFG, steps_per_tick=5,
                              max_tick_multiplier=8, eval_payoff=2.0)
    svc = _svc(cfg)
    for i, sid in enumerate(("near", "far")):
        g, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=40 + i,
                                device=CPU)
        svc.add_graph(sid, g, num_clusters=3, edge_capacity=1024)
    near, far = svc._sessions["near"], svc._sessions["far"]
    near.residual, near.rate = cfg.tol * 1.5, 0.8
    far.residual, far.rate = 0.5, 0.995
    mults = svc._tick_multipliers([near, far])
    assert mults[0] == 1
    assert mults[1] == cfg.max_tick_multiplier
    before = svc.multiplied_ticks
    svc.tick()
    assert svc.multiplied_ticks == before + 1
    assert len({key for key, _ in svc._compiled}) == 1


def test_split_sub_batches_of_one_occupancy_share_a_program():
    """Multipliers (1, 1, 8, 8) split a group into two sub-batches of
    occupancy 2: both run through the one occupancy-2 program, which
    refills its layout at each alternation, and every member's panel and
    residual equal its own dilated operator's run_chunk from the same
    panel, c and lr."""
    from repro_torch.core import operators, solvers
    from repro_torch.stream import graph_store as gs
    cfg = dataclasses.replace(SVC_CFG, steps_per_tick=3,
                              max_tick_multiplier=8, eval_payoff=2.0)
    svc = _svc(cfg)
    for i in range(4):
        g, _ = graphs.sbm_graph(48, 3, p_in=0.4, p_out=0.03, seed=50 + i,
                                device=CPU)
        svc.add_graph(f"s{i}", g, num_clusters=3, edge_capacity=512)
    sess = [svc._sessions[f"s{i}"] for i in range(4)]
    for tick in range(2):
        for s_, far in zip(sess, (False, False, True, True)):
            s_.residual, s_.rate = (0.5, 0.995) if far else (cfg.tol * 1.5, 0.8)
        mults = svc._tick_multipliers(sess)
        np.testing.assert_array_equal(mults, [1, 1, 8, 8])
        assert [len(m) for m, _ in service._split_by_multiplier(sess, mults)] \
            == [2, 2]
        before = [(s_.v, program.dilation_scale(s_.plan, svc._session_degree(
            s_)), s_.lr, s_.store, svc._session_degree(s_)) for s_ in sess]
        inv, fills = svc.tick_invocations, svc.layout_fills
        out = svc.tick()
        assert svc.tick_invocations == inv + 2
        assert svc.layout_fills == fills + 2
        assert svc.compile_count == 1
        assert [occ for _, occ in svc._compiled] == [2]
        for s_, (v, c, lr, store, deg), mult in zip(sess, before, mults):
            op = operators.dilated_step_operator(
                gs.fused_step(store, "segment"), c, deg)
            st, res = program.run_chunk(
                op, solvers.mu_eg_step,
                solvers.SolverState(v=v, step=torch.zeros((), dtype=torch.int32)),
                lr, cfg.steps_per_tick * int(mult))
            assert float((s_.v - st.v).abs().max()) <= 1e-5, s_.sid
            assert abs(out[s_.sid] - float(res)) <= 1e-5, s_.sid


def test_per_session_schedules_do_not_grow_programs():
    """Sessions with different lr, dilation scale and rho share one
    program; the program set only grows along the pow2 occupancy
    ladder."""
    svc = _svc(SVC)
    for i in range(5):
        rng = np.random.default_rng(30 + i)
        e = 140 + 17 * i
        edges = np.stack([rng.integers(0, 48, e), rng.integers(0, 48, e)], 1)
        edges = edges[edges[:, 0] != edges[:, 1]]
        w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
        svc.add_graph(f"s{i}", lap.make_edge_list(edges, 48, weights=w,
                                                  device=CPU),
                      num_clusters=3, edge_capacity=512)
    scales = {round(s.plan.scale, 6) for s in svc._sessions.values()}
    assert len(scales) > 1
    svc.tick()
    svc.tick()
    group_keys = {key for key, _ in svc._compiled}
    assert {key[1] for key in group_keys} <= set(
        program.schedule_degrees(SVC.degree))
    assert svc.compile_count == len(group_keys)
    svc.run_until_converged(max_ticks=200)
    assert svc.compile_count <= len(group_keys) * (1 + int(math.log2(8)))
    for _, occ in svc._compiled:
        assert occ == 1 << (occ.bit_length() - 1)


def test_converged_sessions_cost_zero_device_work():
    svc = _svc(SVC)
    for i in range(2):
        g, _ = graphs.sbm_graph(50, 3, p_in=0.4, p_out=0.02, seed=i,
                                device=CPU)
        svc.add_graph(f"g{i}", g, num_clusters=3, edge_capacity=512)
    svc.tick()
    base_work = svc.device_work
    assert base_work >= 2 * SVC.steps_per_tick
    svc._sessions["g0"].converged = True
    svc.tick()
    assert svc.device_work - base_work == svc.cfg.steps_per_tick
    svc._sessions["g1"].converged = True
    work, inv = svc.device_work, svc.tick_invocations
    assert svc.tick() == {}
    assert svc.device_work == work and svc.tick_invocations == inv


def test_evicted_panel_warm_starts_readmission():
    svc = _svc(SVC)
    g, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=7, device=CPU)
    svc.add_graph("t", g, num_clusters=3, edge_capacity=1024)
    svc.run_until_converged(max_ticks=100)
    cold_ticks = svc.session_info("t")["ticks"]
    assert cold_ticks >= 2
    summary = svc.evict("t")
    panel = summary["panel"]
    assert isinstance(panel, np.ndarray)
    assert panel.shape == (g.num_nodes, SVC.k)
    assert not svc.has_session("t")
    svc.add_graph("t", g, num_clusters=3, edge_capacity=1024,
                  resume_panel=panel)
    svc.run_until_converged(max_ticks=100)
    info = svc.session_info("t")
    assert info["converged"]
    assert info["ticks"] < cold_ticks
    np.testing.assert_array_equal(svc._sessions["t"].v[g.num_nodes:].numpy(),
                                  0.0)
    assert tuple(svc.panel("t").shape) == (g.num_nodes, SVC.k)
    assert svc.evict_converged().keys() == {"t"}


def test_resume_panel_shape_validated():
    svc = _svc(SVC)
    g, _ = graphs.sbm_graph(40, 2, p_in=0.4, p_out=0.02, seed=0, device=CPU)
    with pytest.raises(ValueError, match="resume_panel"):
        svc.add_graph("bad", g, num_clusters=3,
                      resume_panel=np.zeros((10, SVC.k), np.float32))


def test_residual_decay_scheduler_beats_round_robin():
    cfg = dataclasses.replace(SVC, steps_per_tick=10, tol=2e-3)
    rr = _svc(dataclasses.replace(cfg, tick_schedule="round_robin"))
    sched = _svc(cfg)
    for svc in (rr, sched):
        for sid, p_in, p_out, seed in FLEET:
            g, _ = graphs.sbm_graph(60, 3, p_in=p_in, p_out=p_out, seed=seed,
                                    device=CPU)
            svc.add_graph(sid, g, num_clusters=3, edge_capacity=1024)
        svc.run_until_converged(max_ticks=400)
    assert rr.all_converged and sched.all_converged
    assert sched.tick_invocations < rr.tick_invocations
    for sid, *_ in FLEET:
        assert sched.session_info(sid)["residual"] <= cfg.tol
    assert sched.multiplied_ticks > 0 and rr.multiplied_ticks == 0
    assert sched.compile_count <= rr.compile_count + 1


def test_service_config_refuses_mesh_and_unknown_backend():
    # a mesh must be a DeviceMesh naming the edge and model axes (edge
    # sharding is tests/test_torch_distributed.py's, panel sharding
    # tests/test_torch_model_sharded.py's); model_axes need a mesh
    with pytest.raises(ValueError, match="mesh axes"):
        ServiceConfig(mesh=object())
    with pytest.raises(ValueError, match="requires a mesh"):
        ServiceConfig(model_axes=("model",))
    with pytest.raises(ValueError, match=r"\['model'\] not in mesh axes"):
        ServiceConfig(mesh=SimpleNamespace(mesh_dim_names=("data",)),
                      model_axes=("model",))
    ServiceConfig(mesh=SimpleNamespace(mesh_dim_names=("data", "model")),
                  model_axes=("model",))
    ServiceConfig(edge_axes=("data", "model"))  # without a mesh: unused
    with pytest.raises(ValueError, match="tick_block_n"):
        ServiceConfig(tick_block_n=256)
    ServiceConfig(tick_block_n=512, edge_axes=["data"])  # the defaults
    with pytest.raises(ValueError, match="backend"):
        ServiceConfig(backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        StreamingService(ServiceConfig(backend="kernel"), device=CPU)
