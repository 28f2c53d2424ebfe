"""The port's panel (model-axis) sharding against the JAX package: the
destination-aligned layouts, a shard's owned rows (the rectangular K2
launch and its plain twin), the panel-sharded tick, probe and service,
on S = 2 and S = 4 CPU ranks over gloo.

One world per shard count is spawned once for the module
(``parallel.run_ranks``); every rank runs all cases
(``tests/torch_dist_ranks.run_model``) and returns numpy.  In tier-1 JAX
sees one CPU device, so each world output is held to JAX's function on a
(1, 1) ("data", "model") mesh, to JAX's per-shard functions (which need
no mesh) and to the port's own one-device function, within ``TOL`` =
1e-5 max-abs.  Layouts are bitwise the JAX package's, and panels are
bitwise equal across ranks.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.compat import default_edge_mesh
from repro.core import graphs as jgraphs
from repro.core import laplacian as jlap
from repro.core import program as jprogram
from repro.kernels.edge_spmm import ops as jes_ops
from repro.spectral import probes as jprobes
from repro.stream import graph_store as jgs
from repro.stream import service as jservice
from repro_torch import parallel
from repro_torch.core import backend, program
from repro_torch.core import laplacian as lap
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.kernels.edge_spmm import ref as es_ref
from repro_torch.stream import graph_store as gs

CPU = "cpu"
TOL = 1e-5
BLOCK_N = ranks.MODEL_BLOCK_N
FIELDS = ("u_local", "other", "weight", "chunk_block", "deg", "block_n",
          "block_e", "num_chunks", "num_nodes", "num_shards")
SKEW_SEEDS = list(range(1, 11))


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _graph(name: str):
    """(port EdgeList, JAX EdgeList) of one of the shared case graphs."""
    edges, w, n, cap = ranks.case_arrays(name)
    jg = jlap.make_edge_list(edges, n, weights=w)
    return ranks._graph(name), (jlap.pad_edge_list(jg, cap) if cap else jg)


@pytest.fixture(scope="module")
def mesh1():
    return default_edge_mesh()  # (1, 1) ("data", "model")


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    key = jax.random.PRNGKey(11)
    probe_v0 = np.stack([np.asarray(jax.random.normal(k, (96,), jnp.float32))
                         for k in jax.random.split(key, 4)], axis=1)
    resume = {sid: ranks.panel(40 + i, g.num_nodes, 5)
              for i, (sid, g) in enumerate(ranks.service_graphs().items())}
    return {
        "probe_v0": probe_v0,
        "tick": {"graphs": [ranks.rand_edges(3 + i, 96, 260) for i in range(2)],
                 "cs": [0.02, 0.035],
                 "vs": np.stack([ranks.panel(60 + i, 96, 4) for i in range(2)]),
                 "lrs": [0.3, 0.2]},
        "resume": resume,
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def world(request):
    num_shards = request.param
    inputs = _inputs()
    results = parallel.run_ranks(num_shards, ranks.run_model, inputs,
                                 device=CPU, timeout=300.0)
    return SimpleNamespace(S=num_shards, inputs=inputs,
                           outs=[r.value for r in results],
                           launches=parallel.sum_launches(
                               r.launches for r in results))


def _all_ranks(world, key: str):
    """Every rank's output for ``key``, asserted bitwise equal across the
    ranks; returns rank 0's."""
    vals = [o[key] for o in world.outs]
    if isinstance(vals[0], dict):
        for k in vals[0]:
            assert parallel.bitwise_equal([v[k] for v in vals]), (key, k)
    else:
        assert parallel.bitwise_equal(vals), key
    return vals[0]


def test_world_model_shards_and_indices(world):
    assert [o["model/sidx"] for o in world.outs] == list(range(world.S))
    assert all(o["model/shards"] == world.S for o in world.outs)
    assert all(c == 0 for c in world.launches.values())  # the CPU twins


# ---------------------------------------------------------------------------
# owned rows: one rank's rows, concatenated in rank order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(ranks.MODEL_AB))
@pytest.mark.parametrize("name", ranks.CASE_NAMES)
def test_owned_rows_assemble_the_fused_step(world, name, tag):
    tg, jg = _graph(name)
    n = tg.num_nodes
    v = ranks.panel(6, n, 4)
    alpha, beta = ranks.MODEL_AB[tag]
    got = np.concatenate([o[f"model_rows/{name}/{tag}"]
                          for o in world.outs])[:n]
    dense = alpha * (lap.laplacian_dense(tg).numpy() @ v) + beta * v
    assert _maxabs(got, dense) <= TOL
    mb = jes_ops.build_model_sharded_blocking(
        np.asarray(jg.src), np.asarray(jg.dst), np.asarray(jg.weight), n,
        world.S, block_n=BLOCK_N)
    want = np.concatenate([np.asarray(jes_ops.model_local_rows(
        mb.u_local[s], mb.other[s], mb.weight[s], mb.chunk_block[s],
        mb.deg[s], jnp.asarray(v), jnp.asarray([alpha, beta], jnp.float32),
        s * mb.rows_per_shard, block_n=mb.block_n, block_e=mb.block_e,
        num_chunks=mb.num_chunks, padded_nodes=mb.padded_nodes,
        use_kernel=False)) for s in range(world.S)])[:n]
    assert _maxabs(got, want) <= TOL
    if tag == "plain":  # the JAX-equal layout's shard: the same rows
        via_blocking = np.concatenate([o[f"model_rows/{name}/blocking"]
                                       for o in world.outs])[:n]
        np.testing.assert_array_equal(via_blocking, got)


# ---------------------------------------------------------------------------
# the panel-sharded tick
# ---------------------------------------------------------------------------

def _jax_model_tick(mesh1, method: str, g: int):
    """JAX's build_tick_model_sharded on the (1, 1) mesh (S = 1 layouts)."""
    tick_in = _inputs()["tick"]
    mbs = []
    for e, w in tick_in["graphs"][:g]:
        st = jgs.from_edge_list(jlap.make_edge_list(e, 96, weights=w),
                                capacity=512)
        mbs.append(jgs.model_sharded_blocking(st, 1, block_n=BLOCK_N))
    assert len({mb.num_chunks for mb in mbs}) == 1  # one static layout
    stack = lambda f: jnp.stack([f(mb) for mb in mbs])  # noqa: E731
    sched = jprogram.StepSchedule(method=method, degree=ranks.MODEL_DEGREE,
                                  steps=ranks.MODEL_STEPS, backend="segment")
    tick = jprogram.build_tick_program(
        sched, layout=(mbs[0].block_n, mbs[0].num_chunks, mbs[0].block_e),
        mesh=mesh1, model_axes=("model",))
    return tick(stack(lambda b: b.u_local), stack(lambda b: b.other),
                stack(lambda b: b.weight), stack(lambda b: b.chunk_block),
                stack(lambda b: b.deg), jnp.asarray(tick_in["vs"][:g]),
                jnp.asarray(tick_in["cs"][:g], jnp.float32),
                jnp.asarray(tick_in["lrs"][:g], jnp.float32),
                jnp.asarray(ranks.MODEL_CHUNKS[g], jnp.int32))


def _port_one_device_tick(method: str, g: int):
    tick_in = _inputs()["tick"]
    stores = [gs.from_edge_list(lap.make_edge_list(e, 96, weights=w,
                                                   device=CPU), capacity=512)
              for e, w in tick_in["graphs"][:g]]
    prog = program.build_tick_program(program.StepSchedule(
        method=method, degree=ranks.MODEL_DEGREE, steps=ranks.MODEL_STEPS,
        backend="segment"), CPU)
    return prog([gs.edge_rows(st) for st in stores], tick_in["cs"][:g],
                torch.from_numpy(tick_in["vs"][:g]), tick_in["lrs"][:g],
                ranks.MODEL_CHUNKS[g])


@pytest.fixture(scope="module")
def model_tick_refs(mesh1):
    return {(m, g): (_jax_model_tick(mesh1, m, g), _port_one_device_tick(m, g))
            for m, g in ranks.MODEL_TICKS}


@pytest.mark.parametrize("method,g", ranks.MODEL_TICKS)
def test_model_tick_matches_jax_and_one_device(world, model_tick_refs, method,
                                               g):
    key = f"model_tick/{method}/{g}"
    vs, res = _all_ranks(world, f"{key}/vs"), _all_ranks(world, f"{key}/res")
    assert np.isfinite(vs).all()
    for want_vs, want_res in model_tick_refs[(method, g)]:
        assert _maxabs(vs, want_vs) <= TOL, (method, g)
        assert _maxabs(res, want_res) <= TOL, (method, g)
    assert world.outs[0]["model/rows_per_shard"] * world.S >= 96


@pytest.mark.parametrize("method,g", ranks.MODEL_TICKS)
def test_model_tick_collective_budget(world, method, g):
    """At run time: per mu-EG step ``degree - 1`` plain all_reduces and
    exactly 1 fused (rows + gram); Oja ``degree`` plain and none fused;
    the residual evaluation ``degree`` plain.  Eager: nothing captured."""
    steps = ranks.MODEL_STEPS * int(np.max(ranks.MODEL_CHUNKS[g]))
    deg = ranks.MODEL_DEGREE
    if method == "mu_eg":
        want = ((deg - 1) * steps + deg, steps)
    else:
        want = (deg * steps + deg, 0)
    for o in world.outs:
        key = f"model_tick/{method}/{g}"
        assert o[f"{key}/psums"] == want
        assert o[f"{key}/captures"] == 0
        assert o[f"{key}/program"] == "ModelShardedTickProgram"


# ---------------------------------------------------------------------------
# the panel-sharded probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model_probe(mesh1):
    _, jg = _graph("weighted")
    mb = jes_ops.build_model_sharded_blocking(
        np.asarray(jg.src), np.asarray(jg.dst), np.asarray(jg.weight),
        jg.num_nodes, 1, block_n=BLOCK_N)
    return jprobes.probe_model_sharded(
        mesh1, mb, jax.random.PRNGKey(11),
        jnp.asarray(jg.num_nodes, jnp.int32), num_steps=ranks.MODEL_PROBE_STEPS)


@pytest.mark.parametrize("tag", ["blocking", "rows"])
def test_model_probe_matches_jax_and_edge_sharded(world, jax_model_probe, tag):
    got = _all_ranks(world, f"model_probe/{tag}")
    edges = _all_ranks(world, "model_probe/edges")
    for want in (jax_model_probe, edges):
        want = {f: np.asarray(want[f] if isinstance(want, dict)
                              else getattr(want, f))
                for f in ("lambda_max", "trace", "ritz", "weights")}
        lam = float(want["lambda_max"])
        assert abs(got["lambda_max"] - lam) <= TOL * lam
        assert abs(got["trace"] - float(want["trace"])) <= TOL * float(
            want["trace"])
        assert _maxabs(got["ritz"], want["ritz"]) <= TOL * lam
        assert _maxabs(got["weights"], want["weights"]) <= 1e-4
    # one all_reduce assembles each Lanczos matvec
    assert all(o["model_probe/psums"] == (ranks.MODEL_PROBE_STEPS, 0)
               for o in world.outs)


# ---------------------------------------------------------------------------
# the panel-sharded service against JAX's one-device service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model_service_run():
    resume = _inputs()["resume"]
    svc = jservice.StreamingService(jservice.ServiceConfig(
        backend="segment", **ranks.service_common()))
    g_sbm, _ = jgraphs.sbm_graph(120, 3, p_in=0.35, p_out=0.03, seed=1)
    graphs_ = {"weighted": _graph("weighted")[1], "capacity_padded": g_sbm,
               "non_aligned": _graph("non_aligned")[1]}
    for sid, g in graphs_.items():
        svc.add_graph(sid, g, resume_panel=resume[sid])
    run = {"tick1": svc.tick(),
           "panels1": {sid: np.asarray(svc.panel(sid))
                       for sid in svc.session_ids()}}
    svc.apply_updates("weighted", *ranks.UPDATE)
    run["tick2"] = svc.tick()
    run["panels2"] = {sid: np.asarray(svc.panel(sid))
                      for sid in svc.session_ids()}
    return run


def test_model_service_matches_jax_one_device(world, jax_model_service_run):
    want = jax_model_service_run
    o = world.outs[0]
    for tick in ("tick1", "tick2"):
        assert o[f"msvc/{tick}"].keys() == want[tick].keys()
        for sid, r in want[tick].items():
            assert abs(o[f"msvc/{tick}"][sid] - r) <= TOL, (tick, sid)
    for panels in ("panels1", "panels2"):
        got = _all_ranks(world, f"msvc/{panels}")
        for sid, p in want[panels].items():
            assert _maxabs(got[sid], p) <= TOL, (panels, sid)
    for x in world.outs[1:]:
        assert x["msvc/tick2"] == o["msvc/tick2"]


def test_model_service_updates_empty_the_shard_rows_cache(world):
    for o in world.outs:
        assert o["msvc/cached_after_tick"]
        assert not o["msvc/cached_after_update"]
        assert o["msvc/cached_after_tick2"]
        # one program per group key, eager: none captures
        assert o["msvc/programs"] == o["msvc/group_keys"]
        assert o["msvc/captures"] == 0
        assert o["msvc/program_types"] == ["ModelShardedTickProgram"]


def test_model_service_probe_plans_as_one_device(world):
    """Probing on: the owned-rows probe draws the one-device service's
    vectors, so both plan alike up to the order of the sums."""
    plans = _all_ranks(world, "msvc/plans")
    for sid, (rho, degree, lr, family) in plans["one_device"].items():
        m_rho, m_degree, m_lr, m_family = plans["model"][sid]
        assert (m_degree, m_family) == (degree, family), sid
        assert abs(m_rho - rho) <= TOL * rho, sid
        assert abs(m_lr - lr) <= TOL * lr, sid


# ---------------------------------------------------------------------------
# host-side layouts and owned rows (no world needed)
# ---------------------------------------------------------------------------

def _assert_same_blocking(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, int):
            assert a == b, f
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for prop in ("rows_per_shard", "padded_nodes", "num_blocks",
                 "padded_half_edges"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.statics == want.statics
    assert got.block_chunks.shape == (got.num_shards, got.num_blocks + 1)


def _assert_same_rows(got: es_ops.EdgeRows, want: es_ops.EdgeRows):
    """Equal on the live entries and the hub list."""
    np.testing.assert_array_equal(got.row_ptr.numpy(), want.row_ptr.numpy())
    live = int(want.row_ptr[-1])
    for f in ("other", "weight"):
        np.testing.assert_array_equal(getattr(got, f)[:live].numpy(),
                                      getattr(want, f)[:live].numpy())
    n = want.row_ptr.shape[0] - 1
    np.testing.assert_array_equal(got.hub_rows[got.hub_rows < n].numpy(),
                                  want.hub_rows[want.hub_rows < n].numpy())


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ranks.CASE_NAMES)
def test_model_sharded_blocking_bitwise(name, num_shards):
    tg, jg = _graph(name)
    mb = backend.model_blocking_for(tg, num_shards, block_n=BLOCK_N)
    _assert_same_blocking(mb, jes_ops.build_model_sharded_blocking(
        np.asarray(jg.src), np.asarray(jg.dst), np.asarray(jg.weight),
        jg.num_nodes, num_shards, block_n=BLOCK_N))
    for s in range(num_shards):
        _assert_same_rows(es_ops.build_model_shard_rows(
            tg.src, tg.dst, tg.weight, tg.num_nodes, num_shards, s,
            block_n=BLOCK_N), es_ops.blocking_rows(mb.shard(s)))


@pytest.mark.parametrize("case", ["edgeless", "capacity_padded"])
def test_store_model_sharded_blocking_matches_jax(case):
    if case == "edgeless":
        edges, w, n, cap = np.zeros((0, 2), np.int64), None, 32, 256
    else:
        edges, w, n, _ = ranks.case_arrays("weighted")
        cap = 1024
    st = gs.from_edge_list(lap.make_edge_list(edges, n, weights=w, device=CPU),
                           capacity=cap)
    jst = jgs.from_edge_list(jlap.make_edge_list(edges, n, weights=w),
                             capacity=cap)
    for num_shards in (1, 2, 4, 8):
        mb = gs.model_sharded_blocking(st, num_shards, block_n=16)
        _assert_same_blocking(mb, jgs.model_sharded_blocking(
            jst, num_shards, block_n=16))
        v = torch.from_numpy(ranks.panel(5, st.num_nodes, 3))
        for s in range(num_shards):
            rows = es_ops.build_model_shard_rows(
                st.src, st.dst, st.weight, st.num_nodes, num_shards, s,
                block_n=16)
            _assert_same_rows(rows, es_ops.blocking_rows(mb.shard(s)))
            out = es_ops.model_local_rows(rows, v, 1.0, 0.0,
                                          s * mb.rows_per_shard)
            assert out.shape == (mb.rows_per_shard, 3)
            if case == "edgeless":
                assert torch.equal(out, torch.zeros_like(out))


def _skewed_case(seed: int):
    """tests/test_skew_blocking.py's power-law case: distinct weights,
    some zero (capacity-padding) slots, a random block size."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 400))
    g = jgraphs.power_law_graph(
        n, avg_degree=float(rng.uniform(2.0, 12.0)), alpha=2.5, seed=seed)
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    w = (np.arange(1, len(src) + 1, dtype=np.float32)
         * rng.uniform(0.5, 1.5)).astype(np.float32)
    w[rng.uniform(size=len(src)) < 0.15] = 0.0
    block_n = int(rng.choice([8, 16, 32, 64]))
    return src, dst, w, n, block_n


def _rows_half_edges(rows: es_ops.EdgeRows, row_offset: int) -> list:
    counts = (rows.row_ptr[1:] - rows.row_ptr[:-1]).numpy()
    live = int(rows.row_ptr[-1])
    u = np.repeat(np.arange(len(counts)), counts) + row_offset
    return sorted(zip(u.tolist(), rows.other[:live].tolist(),
                      rows.weight[:live].tolist()))


@pytest.mark.parametrize("seed", SKEW_SEEDS)
def test_model_sharded_slices_consistent(seed):
    """The port's _check_model_sharded_slices_consistent: shard s's row
    CSR holds exactly the live half-edges destined to its row range, in
    local rows, its row weights sum to the global degrees, the union
    covers every live half-edge once, and the layout is JAX's."""
    src, dst, w, n, block_n = _skewed_case(seed)
    num_shards = int(np.random.default_rng(seed + 1).choice([2, 4, 8]))
    mb = es_ops.build_model_sharded_blocking(src, dst, w, n, num_shards,
                                             block_n=block_n, device=CPU)
    _assert_same_blocking(mb, jes_ops.build_model_sharded_blocking(
        src, dst, w, n, num_shards, block_n=block_n))
    r = mb.rows_per_shard
    assert mb.num_chunks == es_ops.next_pow2(mb.num_chunks)
    live = w != 0
    want_all = sorted(
        list(zip(src[live].tolist(), dst[live].tolist(), w[live].tolist()))
        + list(zip(dst[live].tolist(), src[live].tolist(), w[live].tolist())))
    deg_full = np.zeros(mb.padded_nodes, np.float32)
    np.add.at(deg_full, src, w)
    np.add.at(deg_full, dst, w)
    t = [torch.from_numpy(a) for a in (src.astype(np.int32),
                                       dst.astype(np.int32), w)]
    got_all = []
    for s in range(num_shards):
        rows = es_ops.build_model_shard_rows(*t, n, num_shards, s,
                                             block_n=block_n)
        got = _rows_half_edges(rows, s * r)
        assert got == [he for he in want_all if s * r <= he[0] < (s + 1) * r]
        got_all.extend(got)
        deg_rows = torch.zeros(r).index_add_(0, torch.repeat_interleave(
            torch.arange(r), (rows.row_ptr[1:] - rows.row_ptr[:-1]).long()),
            rows.weight[:int(rows.row_ptr[-1])])
        np.testing.assert_allclose(deg_rows.numpy(),
                                   deg_full[s * r:(s + 1) * r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(mb.deg[s].numpy(),
                                      deg_full[s * r:(s + 1) * r])
    assert sorted(got_all) == want_all


@pytest.mark.parametrize("tag", sorted(ranks.MODEL_AB))
@pytest.mark.parametrize("seed", SKEW_SEEDS[:4])
def test_model_local_rows_match_jax_on_skewed_graphs(seed, tag):
    """Concatenated owned rows == JAX's model_local_rows per shard on its
    segment form and its kernel (interpret mode, as
    tests/test_skew_blocking.py runs it), and == alpha L v + beta v."""
    src, dst, w, n, block_n = _skewed_case(seed)
    rng = np.random.default_rng(seed + 20_000)
    k = int(rng.integers(1, 5))
    num_shards = int(rng.choice([2, 4]))
    v = rng.normal(size=(n, k)).astype(np.float32)
    alpha, beta = ranks.MODEL_AB[tag]
    mb = es_ops.build_model_sharded_blocking(src, dst, w, n, num_shards,
                                             block_n=block_n, device=CPU)
    r = mb.rows_per_shard
    t = [torch.from_numpy(a) for a in (src.astype(np.int32),
                                       dst.astype(np.int32), w)]
    got = np.concatenate([es_ops.model_local_rows(
        es_ops.build_model_shard_rows(*t, n, num_shards, s, block_n=block_n),
        torch.from_numpy(v), alpha, beta, s * r).numpy()
        for s in range(num_shards)])
    plain = np.concatenate([es_ops.model_local_rows(
        es_ops.blocking_rows(mb.shard(s)), torch.from_numpy(v), alpha, beta,
        s * r, use_kernel=False).numpy() for s in range(num_shards)])
    np.testing.assert_array_equal(got, plain)
    want = alpha * np.asarray(jlap.edge_matvec_arrays(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.asarray(v))) + beta * v
    scale = max(1.0, float(np.abs(want).max()))
    assert _maxabs(got[:n], want) <= TOL * scale
    jm = jes_ops.build_model_sharded_blocking(src, dst, w, n, num_shards,
                                              block_n=block_n)
    ab = jnp.asarray([alpha, beta], jnp.float32)
    for use_kernel in (False, True):
        ref = np.concatenate([np.asarray(jes_ops.model_local_rows(
            jm.u_local[s], jm.other[s], jm.weight[s], jm.chunk_block[s],
            jm.deg[s], jnp.asarray(v), ab, jnp.asarray(s * r, jnp.int32),
            block_n=jm.block_n, block_e=jm.block_e,
            num_chunks=jm.num_chunks, padded_nodes=jm.padded_nodes,
            use_kernel=use_kernel, interpret=True))
            for s in range(num_shards)])
        assert _maxabs(got, ref) <= TOL * scale, use_kernel


def test_model_all_padding_shard_inert():
    """tests/test_skew_blocking.py's all-padding shards: every edge lands
    in shard 0, so shards 1..3 are zero operators (exact zeros, no NaN)
    on the rectangular form and on the plain twin."""
    rng = np.random.default_rng(5)
    n, block_n, num_shards = 64, 8, 4
    rows_owned = 16
    src = rng.integers(0, rows_owned, 40)
    dst = rng.integers(0, rows_owned, 40)
    keep = src != dst
    w = rng.uniform(0.5, 1.5, keep.sum()).astype(np.float32)
    mb = es_ops.build_model_sharded_blocking(
        src[keep], dst[keep], w, n, num_shards, block_n=block_n, device=CPU)
    assert mb.rows_per_shard == rows_owned
    v = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    t = [torch.from_numpy(a.astype(np.int32)) for a in (src[keep], dst[keep])]
    for s in (1, 3):
        assert (mb.weight[s].numpy() == 0.0).all()
        rows = es_ops.build_model_shard_rows(*t, torch.from_numpy(w), n,
                                             num_shards, s, block_n=block_n)
        assert int(rows.row_ptr[-1]) == 0
        start = s * rows_owned
        for out in (
                es_ops.model_local_rows(rows, v, 1.0, 0.0, start),
                es_ops.model_local_rows(es_ops.blocking_rows(mb.shard(s)), v,
                                        1.0, 0.0, start, use_kernel=False),
                es_ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                      v, 1.0, 0.0,
                                      v_self=v[start:start + rows_owned])):
            assert not torch.isnan(out).any()
            assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("name", ranks.CASE_NAMES)
def test_rectangular_twin_with_v_self_is_the_square_twin(name):
    g = ranks._graph(name)
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    v = torch.from_numpy(ranks.panel(8, g.num_nodes, 5))
    for alpha, beta in ((1.0, 0.0), (-0.2, 1.0)):
        square = es_ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                       v, alpha, beta)
        assert torch.equal(es_ref.edge_spmm_rows(
            rows.row_ptr, rows.other, rows.weight, v, alpha, beta,
            v_self=v), square)
        assert torch.equal(es_ops.edge_spmm_rows_nb(rows, v, alpha, beta,
                                                     v_self=v), square)
    # (n,) panels round-trip through a column with their v_self
    vec = v[:, 0].contiguous()
    assert torch.equal(es_ops.edge_spmm_rows_nb(rows, vec, -0.2, 1.0,
                                                v_self=vec),
                       es_ops.edge_spmm_rows_nb(rows, vec, -0.2, 1.0))


def test_model_local_rows_pads_past_the_panel():
    """The last shard's rows may run past the real nodes: they read zero
    rows and come out zero."""
    g = ranks._graph("weighted")  # 96 nodes, R = 64 at S = 2
    v = torch.from_numpy(ranks.panel(9, 96, 3))
    rows = es_ops.build_model_shard_rows(g.src, g.dst, g.weight, 96, 2, 1,
                                         block_n=BLOCK_N)
    assert rows.row_ptr.shape[0] - 1 == 64
    out = es_ops.model_local_rows(rows, v, -0.1, 1.0, 64)
    assert torch.equal(out[32:], torch.zeros_like(out[32:]))
    want = (-0.1 * (lap.laplacian_dense(g) @ v) + v)[64:]
    assert _maxabs(out[:32], want) <= TOL


def test_one_rank_panel_sharded_tick_is_the_one_device_tick():
    """S = 1 in this process: the panel-sharded program is the one-device
    tick up to the order of the sums."""
    tick_in = _inputs()["tick"]
    with ranks.one_rank_world() as mesh:
        stores = [gs.from_edge_list(lap.make_edge_list(
            e, 96, weights=w, device=CPU), capacity=512)
            for e, w in tick_in["graphs"]]
        sched = program.StepSchedule(degree=5, steps=3, backend="segment")
        prog = program.build_tick_program(sched, CPU, mesh=mesh,
                                          model_axes=("model",))
        got = prog([gs.model_shard_rows(st, mesh) for st in stores],
                   tick_in["cs"], torch.from_numpy(tick_in["vs"]),
                   tick_in["lrs"], (2, 1))
    want = program.build_tick_program(sched, CPU)(
        [gs.edge_rows(st) for st in stores], tick_in["cs"],
        torch.from_numpy(tick_in["vs"]), tick_in["lrs"], (2, 1))
    for a, b in zip(got, want):
        assert _maxabs(a, b) <= TOL


def test_sharded_module_exports_the_jax_names():
    from repro.stream import sharded as jsharded
    from repro_torch.stream import sharded

    assert set(sharded.__all__) == set(jsharded.__all__)
    with ranks.one_rank_world() as mesh:
        assert sharded.num_model_shards(mesh) == program.num_model_shards(
            mesh, ("model",)) == 1
        assert sharded.num_edge_shards(mesh, ("data", "model")) == 1
        assert isinstance(sharded.build_tick_model_sharded(
            program.StepSchedule(), mesh, device=CPU),
            program.ModelShardedTickProgram)
