"""The reader of k-means' kernel launches (``layers/kmeans_dist_calls_per_job``)
on made-up launch counts, and nothing read where the program launched none
or has no such kernel."""
from __future__ import annotations

import pytest

from spedbench import cell as cells
from spedbench import run as bench
from spedbench import trace

MS = 1_000_000


def _ctx(launches, jobs=1):
    tl = trace.Timeline(device=[], host=[],
                        jobs=[(i * 100 * MS, (i + 1) * 100 * MS)
                              for i in range(jobs)],
                        start=0, end=jobs * 100 * MS)
    return bench.LayerContext(tl, {}, launches, steps_run=5 * jobs)


@pytest.mark.parametrize("launches,jobs,want", [
    ({"kmeans_dist": 440, "edge_spmm_nb": 1255}, 1, 440.0),
    ({"kmeans_dist": 880}, 2, 440.0),
    ({"kmeans_dist": 55, "gram2k": 5}, 1, 55.0),
])
def test_reads_the_launches_a_job(launches, jobs, want):
    read = cells.reader("kmeans_dist_calls_per_job")
    assert read(_ctx(launches, jobs)) == pytest.approx(want)


@pytest.mark.parametrize("launches,jobs", [
    ({"kmeans_dist": 0, "edge_spmm_nb": 1255}, 1),  # launched none
    ({"edge_spmm_nb": 1255, "gram2k": 5}, 1),  # a program without the kernel
    (None, 1),  # no counts at all
    ({"kmeans_dist": 440}, 0),  # no traced job
])
def test_reads_nothing_without_launches(launches, jobs):
    assert cells.reader("kmeans_dist_calls_per_job")(_ctx(launches, jobs)) is None
