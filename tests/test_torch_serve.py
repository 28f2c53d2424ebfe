"""The port's serving layer (``repro_torch.serve``) against the JAX
package's (``repro.serve``), and its own properties on the CPU.

The eight tests of tests/test_serve.py are ported at their sizes and
bars.  The comparisons run both packages on the same inputs, built with
numpy from a seed: one script of admits (shared ``resume_panel``s,
probing off), pushes of both modes with duplicate keys, manual steps
and an evict drives both ``Server``s, and versions, pipeline counters
and every ``BatchStats`` the drain produced are equal, residuals within
1e-4; the staging buffer's flush and the latency histogram's
percentiles are equal exactly.  The process shell is booted as a
subprocess with ``--device cpu`` (and without a card, to show the device
rule).  Every network wait and ``communicate`` has a timeout.
"""
import json
import os
import select
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import Server as JServer, ServerConfig as JServerConfig
from repro.serve import metrics as jmetrics
from repro.serve import server as jserver
from repro.stream.service import ServiceConfig as JServiceConfig
from repro_torch.core import graphs
from repro_torch.core.kmeans import cluster_agreement
from repro_torch.serve import Server, ServerConfig, VersionedResults
from repro_torch.serve import server as tserver
from repro_torch.serve.http import ServeHTTP, _jsonable
from repro_torch.serve.metrics import (LATENCY_BUCKET_FACTOR,
                                       LatencyHistogram, ServeMetrics)
from repro_torch.stream.service import ServiceConfig, UnknownSessionError

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
RES_TOL = 1e-4
SVC_KW = dict(k=4, num_clusters=3, degree=7, steps_per_tick=25, lr=0.3,
              tol=5e-3, dilation_strength=6.0)
SERVE_SVC = ServiceConfig(**SVC_KW)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for this module's many small-tensor ops, as in
    tests/test_torch_service.py; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _server(**kw) -> Server:
    return Server(ServerConfig(service=SERVE_SVC, **kw), device=CPU)


def _sbm_edges(seed: int, n: int = 60):
    g, truth = graphs.sbm_graph(n, 3, p_in=0.4, p_out=0.02, seed=seed,
                                device=CPU)
    edges = torch.stack([g.src, g.dst], dim=1).numpy()
    return edges, g.weight.numpy(), n, truth


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_latency_histogram_percentiles_conservative():
    h = LatencyHistogram()
    samples = [1e-5] * 98 + [0.5, 0.9]
    for s in samples:
        h.record(s)
    assert h.count == 100
    # the reported quantile is the holding bucket's UPPER edge: at least
    # the true quantile (SLO-conservative), within one bucket factor
    F = LATENCY_BUCKET_FACTOR
    assert 1e-5 <= h.percentile(0.50) <= 1e-5 * F
    assert 0.5 <= h.percentile(0.99) <= 0.5 * F  # 99th of 100 = 0.5
    assert 0.9 <= h.percentile(1.0) <= 0.9 * F
    assert h.percentile(0.0) > 0.0  # min sample's bucket, not 0
    assert h.max_s == 0.9
    assert abs(h.mean_s - np.mean(samples)) < 1e-9
    with pytest.raises(ValueError):
        h.percentile(1.5)
    assert LatencyHistogram().percentile(0.99) == 0.0  # empty => 0


def test_serve_metrics_aggregate_threaded():
    m = ServeMetrics(("push", "labels"))

    def hammer():
        for _ in range(200):
            m.record("push", 2e-6)
            m.inc("staged_batches")

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = m.snapshot()
    assert snap["counters"]["staged_batches"] == 800
    assert snap["latency"]["push"]["count"] == 800
    assert snap["latency"]["labels"]["count"] == 0
    with m.timed("labels"):
        pass
    assert m.percentile("labels", 0.5) > 0.0
    assert m.percentile("nope", 0.5) == 0.0


def test_latency_histogram_equals_jax_on_seeded_samples():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(-9.0, 2.5, 3000),
                              [0.0, -1.0, 1e-6, 1e9]]).tolist()
    got, want = LatencyHistogram(), jmetrics.LatencyHistogram()
    assert got.EDGES == want.EDGES
    tm, jm = ServeMetrics(("a",)), jmetrics.ServeMetrics(("a",))
    for s in samples:
        got.record(s)
        want.record(s)
        tm.record("a", s)
        jm.record("a", s)
    assert got.counts == want.counts
    for q in np.linspace(0.0, 1.0, 101):
        assert got.percentile(q) == want.percentile(q)
    assert got.summary() == want.summary()
    assert tm.snapshot()["latency"] == jm.snapshot()["latency"]


# ---------------------------------------------------------------------------
# versioned results store
# ---------------------------------------------------------------------------

def test_versioned_results_monotone_versions_and_lazy_labels():
    store = VersionedResults()
    store.register("a", 3)
    with pytest.raises(ValueError):
        store.register("a", 3)  # live duplicate
    with pytest.raises(UnknownSessionError):
        store.commit("ghost", {}, None)
    panel = torch.eye(4)
    calls = []

    def labeler(p):
        calls.append(1)
        return np.asarray([0, 1, 2, 0])

    assert store.commit("a", {"residual": 1.0}, panel) == 1
    assert store.commit("a", {"residual": 0.5}, panel) == 2
    assert store.version("a") == 2
    assert store.summary("a")["version"] == 2  # summary carries version
    lab, version, churn = store.labels("a", labeler)
    assert version == 2 and churn == 0.0
    assert lab.dtype == np.int32
    np.testing.assert_array_equal(lab, [0, 1, 2, 0])
    store.labels("a", labeler)
    assert len(calls) == 1  # cached: one labeler run per version
    # a permuted relabelling of the next version serves STABLE ids
    store.commit("a", {"residual": 0.4}, panel)
    lab2, version2, churn2 = store.labels(
        "a", lambda p: np.asarray([1, 2, 0, 1]))  # same partition, permuted
    assert version2 == 3
    np.testing.assert_array_equal(lab2, lab)  # tracker mapped ids back
    assert churn2 == 0.0  # measured guarantee: no genuine movement
    # eviction tombstones: reads 404 but re-registration works
    store.evict("a")
    with pytest.raises(UnknownSessionError):
        store.summary("a")
    with pytest.raises(UnknownSessionError):
        store.evict("a")  # not idempotent, same as the engine
    store.register("a", 3)
    assert store.commit("a", {}, panel) == 1  # fresh lineage
    assert store.stats()["commits"] == 4


def test_committed_version_stays_bitwise_after_later_ticks_and_updates():
    """A version's panel is the store's own clone: later ticks, updates
    and re-solves of the engine leave it, and the labels served at its
    version, bit for bit as they were."""
    srv = _server()
    edges, w, n, _ = _sbm_edges(15)
    srv.admit("a", edges, n, weights=w, edge_capacity=1024)
    for _ in range(3):
        srv.step()
    first = srv.labels("a")
    rv = srv.results._sessions["a"].latest
    assert rv.version == first["version"]
    panel, labels = rv.panel.clone(), first["labels"].copy()
    live = srv.service.panel("a")
    assert rv.panel.untyped_storage().data_ptr() != \
        live.untyped_storage().data_ptr()
    assert torch.equal(rv.panel, live)  # a clone of the committed state
    for i in range(4):
        srv.push("a", [[i, i + 7], [i + 1, i + 9]], [0.5, 1.5], mode="add")
        srv.step()
        srv.step()
    assert srv.results.version("a") > first["version"]
    assert not torch.equal(srv.service.panel("a"), panel)  # engine moved
    assert torch.equal(rv.panel, panel)  # ... the committed version did not
    np.testing.assert_array_equal(rv.labels, labels)


# ---------------------------------------------------------------------------
# server (manual stepping: deterministic pipeline semantics)
# ---------------------------------------------------------------------------

def test_server_pipeline_manual_steps_end_to_end():
    srv = _server()
    assert srv.device == torch.device(CPU)
    edges, w, n, truth = _sbm_edges(11)
    out = srv.admit("a", edges, n, weights=w, num_clusters=3,
                    edge_capacity=1024)
    assert out["version"] == 1  # queryable before the first tick
    # staging alone must not touch the engine: no programs, no version
    c0 = srv.service.compile_count
    for i in range(6):
        r = srv.push("a", [[i, i + 1]], [0.5], mode="add")
        assert r["staged"] == 1 and r["applied"] == 0
    assert srv.service.compile_count == c0
    assert srv.results.version("a") == 1
    assert r["queue_depth"] == 6
    # drain + tick until converged
    for _ in range(200):
        srv.step()
        if srv.service.all_converged:
            break
    assert srv.service.all_converged
    lab = srv.labels("a")
    assert lab["version"] > 1
    agree = float(cluster_agreement(torch.from_numpy(lab["labels"]),
                                    truth, 3))
    assert agree > 0.9
    # repeated query at one version: identical bytes, zero churn
    again = srv.labels("a")
    assert again["version"] == lab["version"]
    np.testing.assert_array_equal(again["labels"], lab["labels"])
    s = srv.summary("a")
    assert s["converged"] and s["version"] == lab["version"]
    # staged batches all landed
    m = srv.metrics
    assert m.counter("applied_batches") > 0
    assert m.counter("dropped_batches") == 0
    ev = srv.evict("a")
    assert np.asarray(ev["panel"]).shape[0] == n  # resumable panel
    for fn in (lambda: srv.labels("a"), lambda: srv.summary("a"),
               lambda: srv.evict("a"),
               lambda: srv.push("a", [[0, 1]], [1.0])):
        with pytest.raises(UnknownSessionError):
            fn()
    # a batch staged just before eviction is dropped, not applied
    srv.admit("b", edges, n, weights=w, edge_capacity=1024)
    srv.push("b", [[0, 1]], [1.0])
    srv.evict("b")
    assert m.counter("dropped_batches") == 1


def test_server_serialized_pipeline_applies_inline():
    srv = _server(pipeline="serialized")
    edges, w, n, _ = _sbm_edges(12)
    srv.admit("s", edges, n, weights=w, edge_capacity=1024)
    r = srv.push("s", [[0, 1]], [0.5], mode="add")
    # the baseline has no staging: the batch applies under the engine
    # lock and commits a fresh version before returning
    assert r["staged"] == 0 and r["applied"] == 1
    assert r["version"] == 2 == srv.results.version("s")
    with pytest.raises(ValueError):
        srv.push("s", [[0, 1]], [1.0], mode="xor")
    with pytest.raises(ValueError):
        srv.push("s", [[0, 1]], [1.0, 2.0])  # length mismatch
    with pytest.raises(ValueError):
        ServerConfig(pipeline="bogus")


def test_server_drains_capacity_classes_through_one_pad():
    """The drain groups staged sessions by capacity class and pins ONE
    pow2 batch pad per class; a different-capacity session forms its
    own class, and the padded applies land identically to the
    serialized pipeline's unpadded inline applies."""
    srv = _server()
    base = _server(pipeline="serialized")
    edges, w, n, _ = _sbm_edges(21)
    for s in (srv, base):
        s.admit("a", edges, n, weights=w, edge_capacity=1024)
        s.admit("b", edges, n, weights=w, edge_capacity=1024)
        s.admit("c", edges, n, weights=w, edge_capacity=2048)
    assert (srv.service.capacity_class("a")
            == srv.service.capacity_class("b")
            != srv.service.capacity_class("c"))
    pushes = [("a", [[0, 5], [1, 6], [2, 7]]), ("b", [[3, 8]]),
              ("c", [[4, 9]])]
    for s in (srv, base):
        for sid, es in pushes:
            s.push(sid, es, [0.5] * len(es), mode="add")
    srv.step()
    assert srv.metrics.counter("drain_classes") == 2  # {a, b} and {c}
    assert srv.metrics.counter("applied_batches") == 3
    assert srv.metrics.counter("dropped_batches") == 0
    # padding is a no-op on the stores: padded slots carry zero weight
    for sid in ("a", "b", "c"):
        for field in ("weight", "src", "dst"):
            assert torch.equal(
                getattr(srv.service._sessions[sid].store, field),
                getattr(base.service._sessions[sid].store, field)), field


# ---------------------------------------------------------------------------
# both packages: one script of admits, pushes and an evict
# ---------------------------------------------------------------------------

COUNTERS = ("admitted", "staged_batches", "applied_batches",
            "dropped_batches", "commits", "ticks", "drain_classes",
            "evicted")


def _record_applies(svc, log):
    """Wrap ``svc.apply_updates`` to log every apply and its BatchStats
    as plain Python values."""
    inner = svc.apply_updates

    def apply_updates(sid, edges, weights, mode="set", pad_to=None):
        stats = inner(sid, edges, weights, mode=mode, pad_to=pad_to)
        log.append((sid, np.asarray(edges).tolist(),
                    np.asarray(weights).tolist(), mode, pad_to,
                    tuple(int(x) for x in stats)))
        return stats

    svc.apply_updates = apply_updates


@pytest.mark.parametrize("pipeline", ["double_buffer", "serialized"])
def test_server_script_matches_jax(pipeline):
    kw = dict(SVC_KW, steps_per_tick=10, probe_spectrum=False)
    tsrv = Server(ServerConfig(service=ServiceConfig(**kw),
                               pipeline=pipeline), device=CPU)
    jsrv = JServer(JServerConfig(service=JServiceConfig(**kw),
                                 pipeline=pipeline))
    tlog, jlog = [], []
    _record_applies(tsrv.service, tlog)
    _record_applies(jsrv.service, jlog)
    rng = np.random.default_rng(7)
    for sid, seed, cap in (("a", 31, 1024), ("b", 32, 1024),
                           ("c", 33, 2048)):
        edges, w, n, _ = _sbm_edges(seed)
        panel = rng.normal(size=(n, 4)).astype(np.float32)
        outs = [s.admit(sid, edges, n, weights=w, num_clusters=3,
                        edge_capacity=cap, resume_panel=panel)
                for s in (tsrv, jsrv)]
        assert outs[0]["version"] == outs[1]["version"] == 1

    def push(sid, mode, size):
        e = rng.integers(0, 60, size=(size, 2))
        e = e[e[:, 0] != e[:, 1]]
        e = np.concatenate([e, e[:2, ::-1]])  # duplicate keys, reversed
        wts = rng.choice([0.25, 0.5, 1.0, 2.0], size=len(e))
        outs = [s.push(sid, e, wts, mode=mode) for s in (tsrv, jsrv)]
        assert outs[0] == outs[1]

    def same_state():
        for c in COUNTERS:
            assert tsrv.metrics.counter(c) == jsrv.metrics.counter(c), c
        assert tlog == jlog
        for sid in tsrv.service.session_ids():
            assert tsrv.results.version(sid) == jsrv.results.version(sid)
            ti, ji = tsrv.summary(sid), jsrv.summary(sid)
            for f in ("version", "converged", "ticks", "num_edges",
                      "solves", "incremental_updates", "fallbacks"):
                assert ti[f] == ji[f], (sid, f)
            assert abs(ti["residual"] - ji["residual"]) <= RES_TOL, sid

    for rnd in range(4):
        push("a", "add", 5)
        push("b", "set", 3)
        push("c", "add" if rnd % 2 else "set", 4)
        push("a", "set", 2)
        for s in (tsrv, jsrv):
            s.step()
            s.step()
        same_state()
    push("b", "add", 3)
    outs = [s.evict("b") for s in (tsrv, jsrv)]
    np.testing.assert_allclose(outs[0]["panel"], outs[1]["panel"],
                               atol=RES_TOL)
    for _ in range(6):
        for s in (tsrv, jsrv):
            s.step()
    same_state()
    assert tsrv.metrics.counter("ticks") > 0 and len(tlog) >= 16
    assert tsrv.metrics.counter("dropped_batches") == \
        (pipeline == "double_buffer")  # b's last push, staged past evict
    assert tsrv.service.compile_count == jsrv.service.compile_count
    assert tsrv.stats()["results"] == jsrv.stats()["results"]


def test_pending_buffer_flush_equals_jax_on_seeded_merges():
    rng = np.random.default_rng(3)
    got, want = tserver._PendingBuffer(), jserver._PendingBuffer()
    for _ in range(60):
        e = rng.integers(0, 12, size=(int(rng.integers(1, 9)), 2))
        w = rng.normal(size=len(e)).astype(np.float32)
        mode = ("set", "add")[int(rng.integers(2))]
        assert got.merge(e, w, mode) == want.merge(e, w, mode)
    assert got.batches_staged == want.batches_staged == 60
    assert got.slots == want.slots
    for (te, tw, tm), (je, jw, jm) in zip(got.flush_batches(),
                                          want.flush_batches(),
                                          strict=True):
        assert tm == jm and te.dtype == je.dtype and tw.dtype == jw.dtype
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tw, jw)


# ---------------------------------------------------------------------------
# concurrency: threaded ingest + queries against a live engine thread
# ---------------------------------------------------------------------------

def test_server_concurrent_ingest_no_lost_updates():
    """Interleaved push/query threads against the running engine:
    every `add` lands exactly once (weights prove it), served result
    versions never go backwards, and staging builds no programs."""
    srv = _server(idle_sleep_s=0.001)
    edges, w, n, _ = _sbm_edges(13)
    # the accounting session: a path graph whose high node ids are
    # untouched, so each pusher thread owns fresh (40+t, 41+t) slots
    path = np.stack([np.arange(19), np.arange(1, 20)], axis=1)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with srv:
            srv.admit("query", edges, n, weights=w, num_clusters=3,
                      edge_capacity=1024)
            srv.admit("acc", path, 60, num_clusters=3, edge_capacity=1024)
            pushes_per_thread, num_push = 25, 4
            errors = []
            versions = []

            def pusher(t):
                try:
                    for _ in range(pushes_per_thread):
                        srv.push("acc", [[40 + t, 41 + t]], [1.0],
                                 mode="add")
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def querier():
                try:
                    seen = []
                    for _ in range(60):
                        seen.append(srv.summary("query")["version"])
                        srv.labels("query")
                    versions.append(seen)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = ([threading.Thread(target=pusher, args=(t,))
                        for t in range(num_push)]
                       + [threading.Thread(target=querier)
                          for _ in range(2)])
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            assert not errors, errors
            assert srv.flush(timeout=60.0)
            # no lost updates: thread t's accumulated weight is exact
            src, dst, ws = srv.service.live_edges("acc")
            got = {(int(a), int(b)): float(x)
                   for a, b, x in zip(src, dst, ws)}
            for t in range(num_push):
                assert got[(40 + t, 41 + t)] == pushes_per_thread, (t, got)
            for seen in versions:
                assert all(a <= b for a, b in zip(seen, seen[1:])), seen
            mc = srv.metrics
            assert mc.counter("staged_batches") == \
                pushes_per_thread * num_push
            assert mc.counter("applied_batches") >= 1
            assert mc.counter("dropped_batches") == 0
            assert srv.wait_converged(timeout=120.0)
            # one capacity class end to end: the pipeline added no
            # programs beyond the engine's pow2 occupancy buckets
            assert len({key for key, _ in srv.service._compiled}) == 1
    finally:
        sys.setswitchinterval(switch)
    assert not srv.running  # context exit drained and stopped cleanly
    snap = srv.stats()
    assert snap["latency"]["push"]["count"] == 100
    assert snap["latency"]["push"]["p99_s"] > 0.0
    assert snap["gauges"]["tick_utilization"] > 0.0


# ---------------------------------------------------------------------------
# HTTP front end and the process shell
# ---------------------------------------------------------------------------

def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_roundtrip_and_error_mapping():
    edges, w, n, truth = _sbm_edges(14)
    with ServeHTTP(_server()) as front:
        base = f"http://{front.host}:{front.port}"
        assert _req(base + "/healthz")[0] == 200
        code, out = _req(base + "/v1/sessions/h1", "POST",
                         {"edges": edges.tolist(), "num_nodes": n,
                          "weights": w.tolist(), "num_clusters": 3,
                          "edge_capacity": 1024})
        assert code == 200 and out["version"] == 1
        code, out = _req(base + "/v1/sessions/h1/edges", "POST",
                         {"edges": [[0, 1]], "weights": [0.5],
                          "mode": "add"})
        assert code == 200 and out["staged"] == 1
        assert front.app.wait_converged(timeout=120.0)
        code, out = _req(base + "/v1/sessions/h1/labels")
        assert code == 200 and out["version"] >= 1
        agree = float(cluster_agreement(torch.tensor(out["labels"]),
                                        truth, 3))
        assert agree > 0.9
        code, out = _req(base + "/v1/sessions/h1")
        assert code == 200 and out["converged"]
        code, out = _req(base + "/metrics")
        assert code == 200
        assert out["latency"]["push"]["count"] == 1
        assert out["engine"]["sessions"] == 1
        assert set(out["engine"]["kernel_launches"]) >= {"edge_spmm"}
        # error mapping: 404 unknown sid, 400 malformed, 404 bad route
        assert _req(base + "/v1/sessions/ghost/labels")[0] == 404
        assert _req(base + "/v1/sessions/ghost", "DELETE")[0] == 404
        assert _req(base + "/v1/sessions/h1/edges", "POST",
                    {"edges": [[0, 1]]})[0] == 400
        assert _req(base + "/v1/sessions/zz", "POST",
                    {"edges": [[0, 1]]})[0] == 400  # missing num_nodes
        assert _req(base + "/nope")[0] == 404
        code, out = _req(base + "/v1/sessions/h1", "DELETE")
        assert code == 200 and "panel" not in out  # stripped on the wire
        assert _req(base + "/v1/sessions/h1")[0] == 404
    assert not front.app.running


def test_jsonable_turns_tensors_into_lists():
    out = _jsonable({"a": torch.arange(3), "b": [torch.tensor(1.5)],
                     "c": (np.int64(2), np.float32(0.5), np.bool_(True)),
                     "d": np.arange(2), "e": "x"})
    assert out == {"a": [0, 1, 2], "b": [1.5], "c": [2, 0.5, True],
                   "d": [0, 1], "e": "x"}
    json.dumps(out)


def _shell(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def test_main_shell_serves_on_cpu_and_stops_on_sigterm():
    proc = _shell("--device", "cpu", "--num-clusters", "3", "--k", "4",
                  "--degree", "7", "--steps-per-tick", "10")
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "no banner within 120 s"
        banner = proc.stdout.readline().strip()
        assert banner.startswith("SERVING "), banner
        port = dict(kv.split("=") for kv in banner.split()[1:])["port"]
        base = f"http://127.0.0.1:{port}"
        edges, w, n, truth = _sbm_edges(0)
        code, out = _req(base + "/v1/sessions/p", "POST",
                         {"edges": edges.tolist(), "num_nodes": n,
                          "weights": w.tolist(), "num_clusters": 3})
        assert code == 200 and out["version"] == 1
        code, out = _req(base + "/v1/sessions/p/labels")
        assert code == 200 and len(out["labels"]) == n
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
        assert proc.returncode == 0, stderr
        assert stdout.strip().splitlines()[-1] == "STOPPED"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_main_shell_without_card_exits_with_the_device_rule():
    proc = _shell(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 2
    assert "SERVING" not in stdout
    assert "device='cpu'" in stderr
