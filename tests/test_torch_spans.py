"""The port's program spans (``repro_torch.spans``) on the CPU: off without
a profiler, host ranges as ``cpu_op`` events on the profiler's clock
under one, the clustering job's tree of spans, the device events and
allocator counts on a (faked) card, and k-means unchanged by them.  The
card's own test is in ``test_torch_cuda.py``."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import ClusteringConfig, SolverConfig, graphs
from repro_torch.core import kmeans as km
from repro_torch.core import spectral_cluster


@pytest.fixture(autouse=True)
def empty_log():
    spans.clear()
    yield
    spans.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class _FakeEvent:
    made = []
    clock = 0  # records so far, each 1.5 ms after the last

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        _FakeEvent.made.append(self)

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock * 1.5

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    """A card as the span module sees one: CUDA initialised, timing
    events, the allocator's counters (each read adds 3 allocs, 2 frees)
    and a flag for a stream that captures."""
    state = {"capturing": False, "reads": 0}

    def memory_stats():
        state["reads"] += 1
        return {"num_device_alloc": 3 * state["reads"],
                "num_device_free": 2 * state["reads"], "other": 7}

    _FakeEvent.made, _FakeEvent.clock = [], 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    return state


def test_a_span_without_a_profiler_records_nothing(fake_card, monkeypatch):
    ranges = []
    monkeypatch.setattr(spans, "_RecordFunctionFast",
                        lambda name: ranges.append(name))

    @spans.span("sped.outer", allocs=True)
    def work():
        with spans.span("sped.inner"):
            return 7

    assert work() == 7
    assert spans.records() == []
    assert ranges == [] and _FakeEvent.made == [] and fake_card["reads"] == 0


def test_nested_spans_are_cpu_ops_on_the_profilers_clock():
    with _cpu_profile() as prof:
        with spans.span("sped.outer"):
            with spans.span("sped.inner"):
                torch.ones(64).sum()
            with spans.span("sped.inner"):
                torch.ones(64).sum()
    recs = spans.records()
    assert [r.name for r in recs] == ["sped.inner", "sped.inner", "sped.outer"]
    outer = recs[-1]
    assert outer.parent is None
    assert [r.parent for r in recs[:2]] == [outer.index, outer.index]
    assert all(r.device_ms is None and r.allocs is None for r in recs)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("sped.")]
    assert sorted(e.name() for e in events) == sorted(r.name for r in recs)
    for e in events:
        assert not e.is_user_annotation()
        assert str(e.device_type()).endswith("CPU")
    for r in recs:  # each record within 1 ms of one range of its name
        assert any(abs(e.start_ns() - r.start_ns) < 1_000_000
                   and abs(e.start_ns() + e.duration_ns() - r.end_ns)
                   < 1_000_000 for e in events if e.name() == r.name)
        assert r.start_ns <= r.end_ns


def test_a_span_on_a_card_times_on_events_and_counts_the_allocator(fake_card):
    with _cpu_profile():
        with spans.span("sped.cluster", allocs=True):
            with spans.span("sped.solve"):
                fake_card["capturing"] = True
                with spans.span("sped.in_capture"):
                    pass
                fake_card["capturing"] = False
    recs = {r.name: r for r in spans.records()}
    assert recs["sped.in_capture"].device_ms is None  # host only
    assert len(_FakeEvent.made) == 4
    assert recs["sped.solve"].device_ms == pytest.approx(1.5)
    assert recs["sped.cluster"].device_ms == pytest.approx(4.5)
    assert recs["sped.cluster"].allocs == {"num_device_alloc": 3,
                                           "num_device_free": 2}
    assert recs["sped.solve"].allocs is None
    assert fake_card["reads"] == 2


def test_the_log_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(spans, "_log", spans.collections.deque(maxlen=3))
    with _cpu_profile():
        for i in range(5):
            with spans.span(f"sped.{i}"):
                pass
    assert [r.name for r in spans.records()] == ["sped.2", "sped.3",
                                                 "sped.4"]


def test_threads_the_profiler_does_not_follow_record_nothing():
    """The profiler collects on the thread that started it: spans on
    other threads stay off, and the main thread's parents hold while
    they run."""
    started, stop = threading.Barrier(5), threading.Event()

    def work(t):
        started.wait(timeout=30)
        while not stop.is_set():
            with spans.span(f"sped.t{t}"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    try:
        with _cpu_profile():
            started.wait(timeout=30)
            for _ in range(50):
                with spans.span("sped.outer"):
                    with spans.span("sped.inner"):
                        pass
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    recs = spans.records()
    by_index = {r.index: r for r in recs}
    assert {r.name for r in recs} == {"sped.outer", "sped.inner"}
    inner = [r for r in recs if r.name == "sped.inner"]
    assert len(inner) == 50
    assert all(by_index[r.parent].name == "sped.outer" for r in inner)


def _job_cfg(steps=6, eval_every=2, restarts=3):
    return ClusteringConfig(num_clusters=3, degree=7, kmeans_restarts=restarts,
                            solver=SolverConfig(steps=steps,
                                                eval_every=eval_every,
                                                lr=0.1))


@pytest.mark.parametrize("steps,eval_every,restarts", [(6, 2, 3), (5, 5, 1)])
def test_a_job_records_the_tree_of_its_phases(steps, eval_every, restarts):
    g, _ = graphs.sparse_sbm_graph(300, 3, 8.0, 0.5, seed=0, device="cpu")
    with _cpu_profile():
        spectral_cluster(g, _job_cfg(steps, eval_every, restarts))
    recs = spans.records()
    names = [r.name for r in recs]
    for name in ("sped.cluster", "sped.prep", "sped.solve", "sped.post"):
        assert names.count(name) == 1
    assert names.count("sped.eval") == steps // eval_every
    assert names.count("sped.kmeans.init") == restarts
    assert names.count("sped.kmeans.lloyd") == restarts
    assert names.count("sped.capture") == 0  # no graph on the CPU
    index = {r.name: r.index for r in recs}
    parent_of = {"sped.cluster": None, "sped.prep": "sped.cluster",
                 "sped.solve": "sped.cluster", "sped.post": "sped.cluster",
                 "sped.eval": "sped.solve", "sped.kmeans.init": "sped.post",
                 "sped.kmeans.lloyd": "sped.post"}
    for r in recs:
        want = parent_of[r.name]
        assert r.parent == (None if want is None else index[want])
    order = sorted(recs, key=lambda r: r.start_ns)
    assert [r.name for r in order][:3] == ["sped.cluster", "sped.prep",
                                           "sped.solve"]


def test_kmeans_is_bitwise_the_same_with_spans_on():
    x = torch.randn(500, 4, generator=torch.Generator().manual_seed(3))
    off = km.kmeans(torch.Generator().manual_seed(9), x, 5, restarts=3)
    with _cpu_profile():
        on = km.kmeans(torch.Generator().manual_seed(9), x, 5, restarts=3)
    assert len(spans.records()) == 6
    for a, b in zip(off, on):
        assert torch.equal(a, b)
