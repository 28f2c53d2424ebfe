"""Serving observability: latency histograms, counters, and gauges.

Pure-host, dependency-free instrumentation for the request layer.  The
design constraints come from the ingest pipeline:

* recording must be CHEAP and lock-short — every request on the hot
  path records exactly one histogram sample and a couple of counter
  bumps, so a single mutex with O(1) critical sections is enough even
  with many ingest/query threads;
* percentiles must be computable WITHOUT retaining samples — the load
  generator drives tens of thousands of requests, so latencies land in
  geometric buckets (factor ``LATENCY_BUCKET_FACTOR`` from 1us), and
  p50/p99 are read off the cumulative bucket counts.  The reported
  quantile is the upper edge of its bucket: an over-estimate by at most
  one bucket factor, i.e. SLO-conservative.

``ServeMetrics`` is the aggregate the server owns: one histogram per
request type (admit / push / labels / summary / evict), counters for
the pipeline (staged / applied / dropped batches, commits, ticks), and
gauges (queue depth, tick utilization).  ``snapshot()`` returns a plain
JSON-able dict — the payload of the HTTP front end's ``/metrics``.
"""
from __future__ import annotations

import threading
import time

LATENCY_BUCKET_FACTOR = 1.6
_BASE_S = 1e-6  # first bucket upper edge: 1 microsecond
_NUM_BUCKETS = 48  # 1.6^48 * 1us ~ 6.3e3 s: covers any sane request


def _bucket_edges() -> list[float]:
    return [_BASE_S * LATENCY_BUCKET_FACTOR ** i for i in range(_NUM_BUCKETS)]


class LatencyHistogram:
    """Fixed geometric-bucket latency histogram (seconds).

    Not internally locked — the owning :class:`ServeMetrics` serializes
    access; standalone use from one thread is fine.
    """

    __slots__ = ("counts", "count", "total_s", "max_s")

    EDGES = _bucket_edges()

    def __init__(self):
        self.counts = [0] * _NUM_BUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        lo, hi = 0, _NUM_BUCKETS - 1
        # binary search for the first bucket whose upper edge covers it
        while lo < hi:
            mid = (lo + hi) // 2
            if seconds <= self.EDGES[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    def percentile(self, q: float) -> float:
        """Latency (seconds) at quantile ``q`` in [0, 1]: the upper edge
        of the bucket holding the q-th sample (0.0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = max(1, int(q * self.count + 0.999999))  # ceil, >= 1
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.EDGES[i]
        return self.EDGES[-1]

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean_s,
            "p50_s": self.percentile(0.50),
            "p99_s": self.percentile(0.99),
            "max_s": self.max_s,
        }


class ServeMetrics:
    """Thread-safe aggregate of per-request-type latency histograms plus
    pipeline counters and gauges."""

    def __init__(self, ops: tuple[str, ...] = ()):
        self._lock = threading.Lock()
        self._hists: dict[str, LatencyHistogram] = {
            op: LatencyHistogram() for op in ops}
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def record(self, op: str, seconds: float) -> None:
        with self._lock:
            h = self._hists.get(op)
            if h is None:
                h = self._hists[op] = LatencyHistogram()
            h.record(seconds)

    def timed(self, op: str):
        """Context manager: ``with metrics.timed("labels"): ...``."""
        return _Timer(self, op)

    def inc(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + by

    def set_gauge(self, gauge: str, value: float) -> None:
        with self._lock:
            self._gauges[gauge] = float(value)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def percentile(self, op: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(op)
            return h.percentile(q) if h is not None else 0.0

    def snapshot(self) -> dict:
        """JSON-able point-in-time view (the ``/metrics`` payload)."""
        with self._lock:
            return {
                "uptime_s": time.perf_counter() - self._t0,
                "latency": {op: h.summary()
                            for op, h in sorted(self._hists.items())},
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
            }


class _Timer:
    __slots__ = ("_metrics", "_op", "_t0")

    def __init__(self, metrics: ServeMetrics, op: str):
        self._metrics = metrics
        self._op = op

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._metrics.record(self._op, time.perf_counter() - self._t0)
        return False


__all__ = [
    "LATENCY_BUCKET_FACTOR",
    "LatencyHistogram",
    "ServeMetrics",
]
