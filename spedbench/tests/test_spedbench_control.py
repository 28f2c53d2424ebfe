"""The control and the planted faults fail the committed limits, at a size
a CPU test holds.

The control is the reference computed on TF32 inputs in the program's
place (chip readings at the cells' own sizes: PERF.md).  The faults run
a whole benchmark run on the CPU with the timed path broken underneath:
a solver step that returns its state unchanged, half of the edges left
out with the rest doubled to stand for them (``control.half_edges``),
and an answer altered where it is produced (one cluster's labels merged
into another).  A one-chip cell has no exchange between chips to leave
out.
"""
from __future__ import annotations

import time

import pytest
import torch

from spedbench import run as bench
from spedbench.reference import compare, pipeline

from .conftest import CELLS


def _run(cell):
    return bench.run(cell, 987654321987, 0.01, False, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, tiny_cell):
    from repro_torch.core import laplacian
    from repro_torch.core.clustering import spectral_cluster
    from spedbench import cell as cells

    cell = tiny_cell(name)
    n, k = cell.config["num_nodes"], cell.config["num_clusters"]
    edges = cells.generator(cell)(cell.config, 5, "cpu")
    g = laplacian.make_edge_list(edges, n, device="cpu")
    labels, info = spectral_cluster(g, bench.clustering_config(cell, 5))
    v = info["eigvecs"]
    ref = pipeline.solve(edges, n, cell.clustering, cell.solver, k, 5)
    ref_labels = pipeline.labels(v, cell.clustering, k, 5)
    sound = compare.numbers(v, labels, ref, ref_labels)
    assert compare.judge(sound, cell.limits)[0], sound
    ctl = pipeline.solve(edges, n, cell.clustering, cell.solver, k, 5,
                         tf32=True)
    ctl_labels = pipeline.labels(v, cell.clustering, k, 5, tf32=True)
    control = compare.numbers(ctl.v, ctl_labels, ref, ref_labels)
    assert control["eigvec_err"] > cell.limits["eigvec_err"], control
    assert not compare.judge(control, cell.limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_cell):
    result = _run(tiny_cell(name))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_caught(name, tiny_cell, monkeypatch):
    from repro_torch.core import program

    monkeypatch.setattr(program, "apply_solver_step",
                        lambda step_fn, state, av, lr: state)
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checks"]["eigvec_err"]["value"] == pytest.approx(1.0, rel=1e-3)


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out_is_caught(name, tiny_cell):
    """The series on every other edge, each doubled: the Laplacian's
    mean kept, half of its terms left out."""
    from spedbench import control

    cell = tiny_cell(name)
    with control.half_edges():
        result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["eigvec_err"]["value"] > cell.limits["eigvec_err"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_caught(name, tiny_cell, monkeypatch):
    from repro_torch.core import kmeans

    real = kmeans.kmeans

    def altered(generator, x, k, iters=25, restarts=8):
        out = real(generator, x, k, iters=iters, restarts=restarts)
        labels = torch.where(out.labels == 1, 0, out.labels)
        return out._replace(labels=labels)

    monkeypatch.setattr(kmeans, "kmeans", altered)
    cell = tiny_cell(name)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["eigvec_err"]["value"] < cell.limits["eigvec_err"]
    assert result["checks"]["label_mismatch"]["value"] > 0.0
