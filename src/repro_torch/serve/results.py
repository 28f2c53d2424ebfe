"""Versioned results store: queries never touch the solve engine.

The serving layer's reads (``labels`` / ``summary``) are decoupled from
the engine by committing a :class:`ResultVersion` per session at
well-defined commit points (admission, after staged updates apply,
after every tick that moved a session).  Queries are served from the
LAST COMMITTED version:

* **monotonic version ids** - per-session versions only ever increase
  (and a global commit counter orders commits across sessions), so a
  client polling ``labels`` can reason about freshness: a response
  carries the version its labels were solved under, and two responses
  with the same version are byte-identical;
* **owned panels** - a commit stores a CLONE of the panel it is given,
  so no later tick, update or re-solve of the engine can write into a
  committed version (the engine's panels are torch tensors, and the
  service's ``panel`` is a view of a live one).  On the card the commit
  also records an event on the committing stream; labelling runs on the
  store's own stream, which waits on that event before the labeler reads
  the panel, so it never queues behind the engine's later ticks and never
  reads a panel whose clone has not landed.  Request threads share that
  one stream, so the caching allocator keeps one pool for their
  labelling.  It is a high-priority stream: PyTorch hands out
  default-priority streams round robin from one pool, which also holds
  the stream a CUDA graph capture records on, and work another thread
  put on a capturing stream would be captured with it;
* **stable cluster ids** - the store owns one
  :class:`~repro_torch.stream.tracking.LabelTracker` per session, fed
  in commit order, so the ids a CLIENT sees are stable across
  re-solves and k-means reruns; per-commit
  :func:`~repro_torch.stream.tracking.label_churn` is the measured
  guarantee (0.0 between consecutive queries unless the communities
  actually moved);
* **lazy labels** - committing is cheap (a summary dict and a panel
  clone); the k-means labelling of a version is materialized on FIRST
  query and cached on the version, under a per-session lock so
  concurrent queries do not race the tracker.

Labels cross the seam as numpy: the labeler returns host labels, the
tracker runs on them as a CPU tensor, and ``labels`` returns int32
numpy ids.  Eviction keeps the session's FINAL version queryable by
default (``drop_evicted=False`` is the server's choice): a client that
raced an eviction still gets its 404 from the tombstone rather than a
half-removed map.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.stream import tracking
from repro_torch.stream.service import UnknownSessionError


@dataclasses.dataclass
class ResultVersion:
    """One committed solve state of one session (immutable once built;
    ``labels``/``churn`` materialize lazily under the session lock)."""

    version: int  # per-session, monotonically increasing from 1
    commit_seq: int  # global commit order across sessions
    summary: dict  # engine session_info at commit time (+ "version")
    panel: torch.Tensor  # (n, k) panel the labels solve from (owned)
    ready: torch.cuda.Event | None = None  # the panel's clone landed
    labels: np.ndarray | None = None  # stable ids, lazily materialized
    churn: float | None = None  # label_churn vs the previous labelling


def _own(panel: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """(a clone of ``panel`` no engine code holds, the event after the
    clone on the card)."""
    panel = panel.clone()
    if not panel.is_cuda:
        return panel, None
    ready = torch.cuda.Event()
    ready.record()
    return panel, ready


class _SessionResults:
    __slots__ = ("lock", "tracker", "latest", "labelled", "evicted")

    def __init__(self, num_clusters: int):
        self.lock = threading.Lock()
        self.tracker = tracking.LabelTracker(num_clusters)
        self.latest: ResultVersion | None = None
        self.labelled: np.ndarray | None = None  # the last stable ids
        self.evicted = False


class VersionedResults:
    """Map of session id -> committed result versions (latest wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: dict[str, _SessionResults] = {}
        self._commit_seq = 0
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    # -- writes (engine/tick thread) -----------------------------------

    def register(self, sid: str, num_clusters: int) -> None:
        with self._lock:
            if sid in self._sessions and not self._sessions[sid].evicted:
                raise ValueError(f"session {sid!r} already registered")
            self._sessions[sid] = _SessionResults(num_clusters)

    def commit(self, sid: str, summary: dict, panel: torch.Tensor) -> int:
        """Commit a new version for ``sid`` (a clone of ``panel``);
        returns the version id."""
        with self._lock:
            sr = self._sessions.get(sid)
            if sr is None or sr.evicted:
                raise UnknownSessionError(sid)
            self._commit_seq += 1
            seq = self._commit_seq
        panel, ready = _own(panel)
        with sr.lock:
            version = 1 if sr.latest is None else sr.latest.version + 1
            summary = dict(summary)
            summary["version"] = version
            sr.latest = ResultVersion(
                version=version, commit_seq=seq, summary=summary,
                panel=panel, ready=ready)
            return version

    def evict(self, sid: str, drop: bool = False) -> None:
        """Tombstone (default) or fully drop a session's results."""
        with self._lock:
            sr = self._sessions.get(sid)
            if sr is None or sr.evicted:
                raise UnknownSessionError(sid)
            if drop:
                del self._sessions[sid]
            else:
                sr.evicted = True

    # -- reads (query threads) -----------------------------------------

    def _label(self, rv: ResultVersion, labeler):
        """``labeler(rv.panel)`` - on the card, on the store's labelling
        stream after the commit's event.  The labeler returns host
        labels, so its reads of the panel have finished when it
        returns."""
        if rv.ready is None:
            return labeler(rv.panel)
        device = rv.panel.device
        with self._lock:
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(
                    device, priority=-1)
        stream.wait_event(rv.ready)
        with torch.cuda.stream(stream):
            return labeler(rv.panel)

    def _live(self, sid: str) -> _SessionResults:
        with self._lock:
            sr = self._sessions.get(sid)
        if sr is None or sr.evicted or sr.latest is None:
            raise UnknownSessionError(sid)
        return sr

    def has(self, sid: str) -> bool:
        with self._lock:
            sr = self._sessions.get(sid)
            return sr is not None and not sr.evicted

    def version(self, sid: str) -> int:
        return self._live(sid).latest.version

    def summary(self, sid: str) -> dict:
        """The last committed summary (carries its ``version``)."""
        sr = self._live(sid)
        with sr.lock:
            return dict(sr.latest.summary)

    def labels(self, sid: str, labeler) -> tuple[np.ndarray, int, float]:
        """(stable labels, version, churn) of the last committed version.

        ``labeler(panel) -> raw host labels`` runs at most once per
        version (cached); the raw labelling feeds the store's tracker so
        served ids stay stable across versions.  ``churn`` is the
        fraction of nodes whose stable id moved since the previously
        LABELLED version (0.0 for the first).
        """
        sr = self._live(sid)
        with sr.lock:
            rv = sr.latest
            if rv.labels is None:
                raw = torch.as_tensor(np.asarray(self._label(rv, labeler)))
                stable = sr.tracker.update(raw).numpy().astype(np.int32)
                rv.churn = (tracking.label_churn(sr.labelled, stable)
                            if sr.labelled is not None else 0.0)
                rv.labels = sr.labelled = stable
            return rv.labels.copy(), rv.version, rv.churn

    def stats(self) -> dict:
        with self._lock:
            live = [s for s in self._sessions.values() if not s.evicted]
            return {
                "sessions": len(live),
                "evicted": len(self._sessions) - len(live),
                "commits": self._commit_seq,
            }


__all__ = ["ResultVersion", "VersionedResults"]
