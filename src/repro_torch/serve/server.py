"""Request-level serving over :class:`~repro_torch.stream.service.StreamingService`.

``Server`` is the in-process front end (the HTTP shell in
:mod:`repro_torch.serve.http` is a thin adapter over it) exposing the
five request types - **admit** a graph, **push** an edge batch, query
**labels**, query a session **summary**, **evict** - with the process
concerns the library does not have:

* **async ingest / tick pipeline** (``pipeline="double_buffer"``, the
  default): pushes DO NOT touch the solve engine.  Each push merges its
  edges into a host-side staging buffer (mode-aware last-write-wins /
  accumulate semantics per edge key, so N pushes against one session
  flush as one coalesced ``apply_updates`` instead of N) and returns
  immediately.  A dedicated engine thread swaps the double buffer each
  iteration - ingest keeps filling the fresh front buffer while the
  engine drains the back buffer and runs the scheduled tick - so ingest
  and ticking do not serialize.  ``pipeline="serialized"`` is the
  baseline without staging (each push applies inline under the engine
  lock, contending with ticks), kept for the A/B comparison.
* **versioned reads**: ``labels``/``summary`` are served from the last
  committed :class:`~repro_torch.serve.results.VersionedResults`
  version - monotonic version ids, stable cluster ids (the store's own
  per-session tracker), and NO engine lock on the query path, so a slow
  tick never stalls a read.
* **observability**: per-request-type latency histograms (p50/p99 via
  :mod:`repro_torch.serve.metrics`), pipeline counters (staged /
  applied / dropped batches, commits, ticks), queue-depth and
  tick-utilization gauges and the kernel launch counts, all surfaced by
  :meth:`Server.stats`.

Thread model: ONE engine thread owns every ``StreamingService`` call
(the engine lock exists only because ``admit``/``evict``/serialized
pushes run on request threads); any number of request threads stage
pushes and read results concurrently.  On the card the engine's first
call of a tick program captures its CUDA graphs while request threads
may be labelling on the results store's stream; the capture is thread-local
(``core.operators.capture_graph``), so their allocations and
synchronizations do not invalidate it.  Unknown or evicted session ids
raise :class:`~repro_torch.stream.service.UnknownSessionError` end to
end - the HTTP layer maps it to 404.

The server and its sessions live on ``device`` (``None`` = the card,
raising without one); the admitted edge lists are moved there.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import laplacian as lap
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.results import VersionedResults
from repro_torch.stream.service import (
    ServiceConfig,
    StreamingService,
    UnknownSessionError,
    panel_labels,
)

REQUEST_OPS = ("admit", "push", "labels", "summary", "evict")
PIPELINES = ("double_buffer", "serialized")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    service: ServiceConfig = ServiceConfig()
    pipeline: str = "double_buffer"  # | "serialized" (A/B baseline)
    idle_sleep_s: float = 0.002  # engine-thread wait when nothing to do
    drop_evicted_results: bool = False  # True = free memory eagerly

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r}")


class _PendingBuffer:
    """Host-side accumulation of staged edge updates for one session.

    Merge semantics reproduce sequential application order per edge key
    (keys are canonicalized (min, max) pairs, matching the store):
    ``set`` overwrites whatever is pending, ``add`` accumulates onto a
    pending value of either mode.  Flushing yields at most one batch
    per mode, so a burst of pushes costs one ``apply_updates`` each.
    """

    __slots__ = ("slots", "batches_staged")

    def __init__(self):
        self.slots: dict[tuple[int, int], list] = {}
        self.batches_staged = 0

    def merge(self, edges: np.ndarray, weights: np.ndarray,
              mode: str) -> int:
        self.batches_staged += 1
        slots = self.slots
        for (a, b), w in zip(edges, weights):
            key = (int(a), int(b)) if a <= b else (int(b), int(a))
            slot = slots.get(key)
            if mode == "set" or slot is None:
                slots[key] = [mode, float(w)]
            else:
                slot[1] += float(w)
        return len(edges)

    def flush_batches(self):
        """Yield (edges, weights, mode) - one coalesced batch per mode."""
        by_mode: dict[str, tuple[list, list]] = {}
        for (a, b), (mode, w) in self.slots.items():
            pairs, ws = by_mode.setdefault(mode, ([], []))
            pairs.append((a, b))
            ws.append(w)
        for mode, (pairs, ws) in by_mode.items():
            yield (np.asarray(pairs, np.int64),
                   np.asarray(ws, np.float32), mode)


def _pairs(edges):
    """(E, 2) node pairs: a tensor stays a tensor (on its device), the
    rest becomes int64 numpy."""
    if isinstance(edges, torch.Tensor):
        return edges.reshape(-1, 2)
    return np.asarray(edges, np.int64).reshape(-1, 2)


class Server:
    """In-process serving front end; see the module docstring."""

    def __init__(self, cfg: ServerConfig = ServerConfig(), device=None):
        self.cfg = cfg
        self.service = StreamingService(cfg.service, device=device)
        self.device = self.service.device
        self.results = VersionedResults()
        self.metrics = ServeMetrics(REQUEST_OPS)
        self._engine_lock = threading.RLock()
        self._stage_lock = threading.Lock()
        self._front: dict[str, _PendingBuffer] = {}
        self._known: set[str] = set()
        self._labelers: dict[str, object] = {}
        self._wake = threading.Event()
        self._drain_cond = threading.Condition()
        self._drained_seq = 0
        self._tick_busy_s = 0.0
        self._t0 = time.perf_counter()
        self._stop_flag = False
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def admit(self, sid: str, edges, num_nodes: int, weights=None,
              num_clusters: int | None = None,
              edge_capacity: int | None = None,
              resume_panel=None) -> dict:
        """Admit a graph ((E, 2) pairs: numpy, a list or a tensor);
        commits result version 1 immediately, so labels/summary are
        queryable before the first tick lands."""
        with self.metrics.timed("admit"):
            g = lap.make_edge_list(_pairs(edges), int(num_nodes),
                                   weights=weights, device=self.device)
            svc_cfg = self.cfg.service
            clusters = num_clusters or svc_cfg.num_clusters
            with self._engine_lock:
                self.service.add_graph(
                    sid, g, num_clusters=num_clusters,
                    edge_capacity=edge_capacity,
                    resume_panel=resume_panel)
                self.results.register(sid, clusters)
                version = self._commit(sid)
            labeler = lambda panel: panel_labels(
                panel, clusters, drop_trivial=svc_cfg.drop_trivial,
                seed=svc_cfg.seed,
                kmeans_restarts=svc_cfg.kmeans_restarts)
            with self._stage_lock:
                self._known.add(sid)
                self._labelers[sid] = labeler
            self.metrics.inc("admitted")
            self._wake.set()
            summary = self.summary_unmetered(sid)
            summary["version"] = version
            return summary

    def push(self, sid: str, edges, weights, mode: str = "set") -> dict:
        """Stage (or, serialized pipeline, apply) one edge batch."""
        with self.metrics.timed("push"):
            if mode not in ("set", "add"):
                raise ValueError(f"unknown update mode {mode!r}")
            edges = np.asarray(edges, np.int64).reshape(-1, 2)
            weights = np.atleast_1d(np.asarray(weights, np.float32))
            if len(weights) != len(edges):
                raise ValueError(
                    f"{len(edges)} edges but {len(weights)} weights")
            if self.cfg.pipeline == "serialized":
                with self._engine_lock:
                    stats = self.service.apply_updates(
                        sid, edges, weights, mode=mode)
                    version = self._commit(sid)
                self.metrics.inc("applied_batches")
                return {"staged": 0, "applied": int(len(edges)),
                        "matched": int(stats.matched),
                        "version": version, "queue_depth": 0}
            with self._stage_lock:
                if sid not in self._known:
                    raise UnknownSessionError(sid)
                buf = self._front.setdefault(sid, _PendingBuffer())
                n = buf.merge(edges, weights, mode)
                depth = sum(len(b.slots) for b in self._front.values())
            self.metrics.inc("staged_batches")
            self.metrics.set_gauge("queue_depth", depth)
            self._wake.set()
            return {"staged": n, "applied": 0,
                    "version": self.results.version(sid),
                    "queue_depth": depth}

    def labels(self, sid: str) -> dict:
        """Stable-id cluster assignment of the last committed version.

        Served entirely from the versioned results store: no engine
        lock, and repeated queries at one version are cached."""
        with self.metrics.timed("labels"):
            with self._stage_lock:
                labeler = self._labelers.get(sid)
            if labeler is None:
                raise UnknownSessionError(sid)
            lab, version, churn = self.results.labels(sid, labeler)
            return {"sid": sid, "version": version, "churn": churn,
                    "labels": lab}

    def summary(self, sid: str) -> dict:
        """Last committed session summary (carries its version)."""
        with self.metrics.timed("summary"):
            return self.summary_unmetered(sid)

    def summary_unmetered(self, sid: str) -> dict:
        out = self.results.summary(sid)
        out["sid"] = sid
        return out

    def evict(self, sid: str) -> dict:
        """Remove a session; staged-but-undrained batches are dropped
        (counted in ``dropped_batches``).  The returned summary carries
        the live panel (numpy) for ``admit(resume_panel=...)``
        re-admission."""
        with self.metrics.timed("evict"):
            with self._stage_lock:
                self._known.discard(sid)
                self._labelers.pop(sid, None)
                pending = self._front.pop(sid, None)
            if pending is not None:
                self.metrics.inc("dropped_batches",
                                 pending.batches_staged)
            with self._engine_lock:
                summary = self.service.evict(sid)
            self.results.evict(sid, drop=self.cfg.drop_evicted_results)
            self.metrics.inc("evicted")
            return summary

    def stats(self) -> dict:
        """Observability snapshot: latency histograms, pipeline
        counters/gauges, engine and results-store state, and the
        process's kernel launch counts."""
        snap = self.metrics.snapshot()
        uptime = max(time.perf_counter() - self._t0, 1e-9)
        snap["gauges"]["tick_utilization"] = self._tick_busy_s / uptime
        snap["results"] = self.results.stats()
        with self._engine_lock:
            svc = self.service
            snap["engine"] = {
                "sessions": len(svc.session_ids()),
                "all_converged": svc.all_converged,
                "compile_count": svc.compile_count,
                "tick_invocations": svc.tick_invocations,
                "device_work": svc.device_work,
                "multiplied_ticks": svc.multiplied_ticks,
                "kernel_launches": kernels.launch_counts(),
            }
        return snap

    # ------------------------------------------------------------------
    # the ingest/tick pipeline
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: swap the double buffer, apply the
        drained batches, run one scheduled tick, commit touched
        versions.  Returns True when any work happened.  The background
        thread calls this in a loop; tests may drive it manually on an
        un-started server."""
        with self._stage_lock:
            staged, self._front = self._front, {}
        touched = []
        drained = 0
        with self._engine_lock:
            # Per-capacity-class drain batching: staged sessions group
            # by their (node, edge) capacity class, and each class pins
            # ONE batch pad (pow2 of its largest coalesced batch) for
            # every member's apply, so a class's applies share one
            # batch shape.
            classes: dict[tuple, list] = {}
            for sid, buf in staged.items():
                try:
                    ck = self.service.capacity_class(sid)
                except UnknownSessionError:
                    self.metrics.inc("dropped_batches",
                                     buf.batches_staged)
                    continue
                classes.setdefault(ck, []).append(
                    (sid, buf, list(buf.flush_batches())))
            if classes:
                self.metrics.inc("drain_classes", len(classes))
            for members in classes.values():
                pad = max((len(edges) for _, _, batches in members
                           for edges, _, _ in batches), default=0)
                for sid, buf, batches in members:
                    try:
                        for edges, ws, mode in batches:
                            self.service.apply_updates(
                                sid, edges, ws, mode=mode, pad_to=pad)
                        touched.append(sid)
                        drained += buf.batches_staged
                        self.metrics.inc("applied_batches",
                                         buf.batches_staged)
                    except UnknownSessionError:
                        self.metrics.inc("dropped_batches",
                                         buf.batches_staged)
            ticked = {}
            if self.service.session_ids() and not self.service.all_converged:
                t0 = time.perf_counter()
                ticked = self.service.tick()
                self._tick_busy_s += time.perf_counter() - t0
                self.metrics.inc("ticks")
            for sid in {*touched, *ticked}:
                try:
                    self._commit(sid)
                except UnknownSessionError:
                    pass  # raced an eviction; tombstone already served
        if staged:
            with self._stage_lock:
                depth = sum(len(b.slots) for b in self._front.values())
            self.metrics.set_gauge("queue_depth", depth)
        with self._drain_cond:
            self._drained_seq += 1
            self._drain_cond.notify_all()
        return bool(drained or ticked)

    def _commit(self, sid: str) -> int:
        """Version commit point - caller holds the engine lock.  The
        store keeps a clone of the live panel."""
        summary = self.service.session_info(sid)
        version = self.results.commit(sid, summary,
                                      self.service.panel(sid))
        self.metrics.inc("commits")
        return version

    def _serve_loop(self) -> None:
        while not self._stop_flag:
            if not self.step():
                self._wake.wait(timeout=self.cfg.idle_sleep_s)
                self._wake.clear()
        self.step()  # final drain: stop() loses no staged update

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Server":
        if self.running:
            raise RuntimeError("server already started")
        self._stop_flag = False
        self._thread = threading.Thread(
            target=self._serve_loop, name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the engine thread after a final drain (clean shutdown:
        every staged batch is applied or counted dropped)."""
        if self._thread is None:
            return
        self._stop_flag = True
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("engine thread did not stop in time")
        self._thread = None

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until every batch staged before the call has been
        drained (applied or dropped).  Returns False on timeout."""
        if not self.running:
            self.step()
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stage_lock:
                pending = bool(self._front)
            with self._drain_cond:
                seq = self._drained_seq
            self._wake.set()
            with self._drain_cond:
                ok = self._drain_cond.wait_for(
                    lambda: self._drained_seq > seq,
                    timeout=max(deadline - time.monotonic(), 0.0))
            if not pending and ok:
                # an empty front buffer followed by one full step
                # boundary: any in-flight drain has landed
                with self._stage_lock:
                    if not self._front:
                        return True
        return False

    def wait_converged(self, timeout: float = 120.0) -> bool:
        """Block until staged work is drained AND every session's panel
        is at tolerance."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.flush(timeout=max(deadline - time.monotonic(),
                                          0.0)):
                return False
            with self._engine_lock:
                done = self.service.all_converged
            with self._stage_lock:
                pending = bool(self._front)
            if done and not pending:
                return True
            if not self.running:
                self.step()
            else:
                time.sleep(0.005)
        return False


__all__ = ["PIPELINES", "REQUEST_OPS", "Server", "ServerConfig"]
