"""Program spans: named ranges of the clustering job's phases, on the
torch profiler's clock.

A span is on only while a torch profiler collects on the calling
thread; off, entering one is one check.  On, it records a host range as
a ``cpu_op`` (``_RecordFunctionFast``: unlike ``record_function`` it is
never copied onto the trace's device timeline), two timing events on the
current CUDA stream (none on a stream that is capturing a graph), and a
:class:`Record` in a bounded in-memory log that :func:`records` returns.
The program writes the log nowhere.  ``span(name)`` is a context manager
or a function decorator.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

CAPACITY = 4096  # records kept; the oldest go first
ALLOC_KEYS = ("num_device_alloc", "num_device_free")


@dataclasses.dataclass
class Record:
    """One closed span.  ``start_ns`` and ``end_ns`` are host times (Unix
    ns, the profiler's clock) taken inside its ``cpu_op``; ``parent`` is
    the ``index`` of the span it ran in; ``device_ms`` is the time between
    its two CUDA events (None on the CPU or inside a capture); ``allocs``
    the caching allocator's ``cudaMalloc`` / ``cudaFree`` calls during it
    (``ALLOC_KEYS``), for a span opened with ``allocs=True`` on a card;
    ``events`` holds its two CUDA events until :func:`records` reads them."""

    index: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int | None = None
    device_ms: float | None = None
    allocs: dict[str, int] | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


_log: collections.deque[Record] = collections.deque(maxlen=CAPACITY)
_index = itertools.count()
_open = threading.local()  # .stack: this thread's open records


def _alloc_counts() -> dict[str, int]:
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOC_KEYS}


class span:
    """A context manager, or a decorator of a function each call of which
    is one span.  ``allocs`` also records the allocator's calls."""

    __slots__ = ("name", "allocs", "_rec", "_fn_range", "_allocs0")

    def __init__(self, name: str, allocs: bool = False):
        self.name = name
        self.allocs = allocs
        self._rec = None

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, self.allocs):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        if not _profiler_enabled():
            return self
        self._fn_range = _RecordFunctionFast(self.name)
        self._fn_range.__enter__()
        stack = _open.__dict__.setdefault("stack", [])
        cuda = (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())
        events = None
        if cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._allocs0 = _alloc_counts() if cuda and self.allocs else None
        self._rec = Record(next(_index), self.name,
                           stack[-1].index if stack else None,
                           time.time_ns(), events=events)
        stack.append(self._rec)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        self._rec = None
        if rec.events is not None:
            rec.events[1].record()
        if self._allocs0 is not None:
            now = _alloc_counts()
            rec.allocs = {k: now[k] - self._allocs0[k] for k in ALLOC_KEYS}
        rec.end_ns = time.time_ns()
        _open.stack.pop()
        _log.append(rec)
        self._fn_range.__exit__(None, None, None)
        return False


def records() -> list[Record]:
    """The closed spans kept, in the order they closed (a parent after
    its children), each ``device_ms`` resolved: this waits for a span's
    end event, which a caller that has synchronised the card never does."""
    out = list(_log)
    for rec in out:
        if rec.events is not None:
            rec.events[1].synchronize()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            rec.events = None
    return out


def clear() -> None:
    _log.clear()
