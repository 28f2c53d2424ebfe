"""The traced window: a ``torch.profiler`` trace reduced to the device's
intervals, the host's operations and the benchmark's job spans, all in
nanoseconds on the profiler's one clock.

The per-layer readers (``spedbench/layers/``) read a :class:`Timeline`;
this module also gives the device's busy time and the breakdown of the
result line.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

JOB_SPAN = "spedbench.job"
NAME_CHARS = 160


@dataclasses.dataclass
class Timeline:
    device: list[tuple[str, int, int]]  # (name, start, end), by start
    host: list[tuple[str, int, int]]  # host operations (name, start, end)
    jobs: list[tuple[int, int]]  # the benchmark's job spans
    start: int  # the traced window
    end: int

    def kernels(self, pattern: str) -> list[tuple[str, int, int]]:
        rx = re.compile(pattern)
        return [e for e in self.device if rx.search(e[0])]

    def in_job(self, events, job: tuple[int, int]):
        return [e for e in events if job[0] <= e[1] <= job[1]]


def from_profiler(prof) -> Timeline:
    """The kineto events of a finished ``torch.profiler.profile``; the
    window runs from the start of the first job span to the end of the
    last (or over the device's events where there is no span)."""
    device, host, jobs = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        on_host = str(ev.device_type()).endswith("CPU")
        if name == JOB_SPAN:
            if on_host:  # not its device-side copy
                jobs.append((s, e))
        elif on_host:  # operators, runtime calls, annotations
            host.append((name, s, e))
        else:  # kernels, copies and sets on the card
            device.append((name, s, e))
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    jobs.sort()
    start = jobs[0][0] if jobs else (device[0][1] if device else 0)
    end = jobs[-1][1] if jobs else max((d[2] for d in device), default=0)
    return Timeline(device=device, host=host, jobs=jobs, start=start, end=end)


def busy_intervals(tl: Timeline) -> list[tuple[int, int]]:
    """The union of the device's intervals inside the window."""
    out: list[list[int]] = []
    for _, s, e in tl.device:
        s, e = max(s, tl.start), min(e, tl.end)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(tl: Timeline) -> int:
    return sum(e - s for s, e in busy_intervals(tl))


def _host_at(tl: Timeline, t: int) -> str:
    """The innermost host operation running at ``t`` (the latest started
    of those that span it, among the 4096 started last), or 'host idle'."""
    j = bisect.bisect_right(tl.host, t, key=lambda h: h[1])
    for name, _, e in reversed(tl.host[max(0, j - 4096):j]):
        if e >= t:
            return name
    return "host idle"


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device by the host operation running in their middle, each
    in seconds."""
    by_name: dict[str, int] = {}
    for name, s, e in tl.device:
        if e > tl.start and s < tl.end:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (min(e, tl.end) - max(s, tl.start))
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    gaps = []
    prev = tl.start
    for s, e in busy_intervals(tl) + [(tl.end, tl.end)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    idle = [[_host_at(tl, t0 + g // 2)[:NAME_CHARS], g / 1e9]
            for g, t0 in gaps[:top]]
    return {"device_ops": [[n, v / 1e9] for n, v in ops], "idle_gaps": idle}
