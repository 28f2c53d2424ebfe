"""The readers of the program's span log (``layers/<metric>.py`` over
``program_spans``) on a made-up timeline and span log, worked out by
hand; and nothing read where the log is empty or the program has none."""
from __future__ import annotations

import sys

import pytest

from repro_torch import spans
from spedbench import cell as cells
from spedbench import run as bench
from spedbench import trace

MS = 1_000_000
READERS = ("prep_span_ms", "step_span_ms", "eval_ms", "post_span_ms",
           "kmeans_init_ms", "kmeans_lloyd_ms", "captures_per_job",
           "device_allocs_per_job")


def _log(device=True):
    """Two recorded jobs, a record between them and a third job span with
    no ``sped.cluster``: (index, name, parent, start ms, device ms)."""
    rows = [
        # job 1, in the job span [0, 100) ms
        (0, "sped.cluster", None, 1, 98.0), (1, "sped.prep", 0, 1, 5.0),
        (2, "sped.solve", 0, 7, 40.0), (3, "sped.eval", 2, 20, 2.0),
        (4, "sped.eval", 2, 40, 3.0), (5, "sped.capture", 2, 8, 0.5),
        (6, "sped.post", 0, 48, 50.0), (7, "sped.kmeans.init", 6, 48, 10.0),
        (8, "sped.kmeans.lloyd", 6, 58, 30.0),
        (9, "sped.kmeans.init", 6, 70, 11.0),
        (10, "sped.kmeans.lloyd", 6, 71, 29.0),
        # between the job spans: no job's
        (11, "sped.prep", None, 150, 1000.0),
        # job 2, in [200, 300) ms: one evaluation, no capture, one restart
        (12, "sped.cluster", None, 201, 80.0), (13, "sped.prep", 12, 201, 7.0),
        (14, "sped.solve", 12, 208, 30.0), (15, "sped.eval", 14, 230, 5.0),
        (16, "sped.post", 12, 240, 40.0),
        (17, "sped.kmeans.init", 16, 240, 9.0),
        (18, "sped.kmeans.lloyd", 16, 250, 31.0),
        # job 3, in [400, 500) ms: no sped.cluster, so no job of the program
        (19, "sped.eval", None, 410, 500.0),
    ]
    allocs = {0: {"num_device_alloc": 10, "num_device_free": 4},
              12: {"num_device_alloc": 6, "num_device_free": 6}}
    return [spans.Record(i, name, parent, start * MS, start * MS + MS,
                         device_ms=ms if device else None,
                         allocs=allocs.get(i) if device else None)
            for i, name, parent, start, ms in rows]


def _ctx(steps=5):
    tl = trace.Timeline(device=[], host=[],
                        jobs=[(0, 100 * MS), (200 * MS, 300 * MS),
                              (400 * MS, 500 * MS)],
                        start=0, end=500 * MS)
    return bench.LayerContext(tl, {"steps": steps}, {}, steps_run=3 * steps)


# by hand: the mean of job 1's and job 2's values
WANT = {"prep_span_ms": (5.0 + 7.0) / 2,
        "step_span_ms": ((40.0 - 5.0) / 5 + (30.0 - 5.0) / 5) / 2,
        "eval_ms": (5.0 + 5.0) / 2,
        "post_span_ms": (50.0 + 40.0) / 2,
        "kmeans_init_ms": (21.0 + 9.0) / 2,
        "kmeans_lloyd_ms": (59.0 + 31.0) / 2,
        "captures_per_job": (1 + 0) / 2,
        "device_allocs_per_job": (14 + 12) / 2}


def _read(metric, ctx, log, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: log)
    return cells.reader(metric)(ctx)


@pytest.mark.parametrize("metric", READERS)
def test_reader_on_a_made_up_span_log(metric, monkeypatch):
    assert _read(metric, _ctx(), _log(), monkeypatch) == pytest.approx(
        WANT[metric])


@pytest.mark.parametrize("metric", READERS)
def test_reader_without_device_events(metric, monkeypatch):
    """A log of a CPU run: no device ms, no allocator counts; the count
    of captures still reads."""
    got = _read(metric, _ctx(), _log(device=False), monkeypatch)
    assert got == (WANT[metric] if metric == "captures_per_job" else None)


@pytest.mark.parametrize("metric", READERS)
def test_reader_on_an_empty_span_log(metric, monkeypatch):
    assert _read(metric, _ctx(), [], monkeypatch) is None
    # records outside every job span are no job's
    outside = [r for r in _log() if r.index == 11]
    assert _read(metric, _ctx(), outside, monkeypatch) is None


@pytest.mark.parametrize("metric", READERS)
def test_reader_without_the_span_module(metric, monkeypatch):
    """An older program has no ``repro_torch.spans``: nothing to read."""
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert cells.reader(metric)(_ctx()) is None
