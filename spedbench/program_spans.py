"""The program's span log (``repro_torch.spans.records()``) cut into the
traced jobs, for the readers of program spans and counters
(``spedbench/layers/``).  A record belongs to the job span of the
timeline in which its host start lies; both are on the profiler's clock.
A program without the log, or one that recorded no job, leaves nothing
to read."""
from __future__ import annotations

import importlib

JOB = "sped.cluster"  # the program's span around a whole job


def jobs(ctx) -> list[list] | None:
    """For each job span of ``ctx.timeline`` that holds the program's
    ``sped.cluster`` span, the records that start inside it; None where
    there is no such job."""
    try:
        spans = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    recs = spans.records()
    out = []
    for start, end in ctx.timeline.jobs:
        inside = [r for r in recs if start <= r.start_ns <= end]
        if any(r.name == JOB for r in inside):
            out.append(inside)
    return out or None


def mean_over_jobs(ctx, value) -> float | None:
    """The mean of ``value(records)`` over the recorded jobs for which it
    is not None; None where it is None for all."""
    vals = [v for v in map(value, jobs(ctx) or []) if v is not None]
    return sum(vals) / len(vals) if vals else None


def device_ms(records, name: str) -> float | None:
    """The summed ``device_ms`` of the records named ``name``; None where
    there is none, or one ran without device events."""
    ms = [r.device_ms for r in records if r.name == name]
    return None if not ms or None in ms else sum(ms)


def span_ms(ctx, name: str) -> float | None:
    """Device ms of the spans named ``name`` a job."""
    return mean_over_jobs(ctx, lambda recs: device_ms(recs, name))
