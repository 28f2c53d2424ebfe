"""Request-level serving layer over the port's streaming engine.

- server.py  - ``Server``: admit/push/labels/summary/evict API with the
  double-buffered async ingest/tick pipeline (and the ``serialized``
  A/B baseline), on ``device`` (``None`` = the CUDA card).
- results.py - ``VersionedResults``: monotonic result versions over
  owned panel clones, stable cluster ids, lazy label materialization;
  reads never touch the engine.
- metrics.py - ``ServeMetrics``: per-request latency histograms
  (p50/p99), pipeline counters, gauges.
- http.py    - ``ServeHTTP``: stdlib JSON-over-HTTP front end
  (``UnknownSessionError`` -> 404, ``ValueError`` -> 400).
- __main__.py - ``python -m repro_torch.serve`` process shell with
  clean SIGTERM shutdown and a ``--device`` flag.
"""
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.results import ResultVersion, VersionedResults
from repro_torch.serve.server import Server, ServerConfig

__all__ = [
    "LatencyHistogram",
    "ResultVersion",
    "ServeMetrics",
    "Server",
    "ServerConfig",
    "VersionedResults",
]
