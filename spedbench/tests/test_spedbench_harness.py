"""The harness: ``BENCHMARK.json`` against the benchmark's contract, each
cell loaded from its files by name, the per-layer readers on a made-up
trace, the import check, and the runs that must print no result."""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from spedbench import cell as cells
from spedbench import roofline, trace
from spedbench import run as bench

from .conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract(bench_json):
    b = bench_json
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["spedbench"] and b["command"][:2] == ["python3", "-m"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("spedbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        assert (ROOT / "spedbench" / "layers" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_from_its_files(name):
    c = cells.load(name)
    assert c.chips == 1 and c.steps >= 1
    assert callable(cells.generator(c))
    assert set(c.limits) == {"eigvec_err", "label_mismatch"}
    assert [m["name"] for m in c.end_to_end] == ["cluster_s", "peak_gib",
                                                 "setup_s"]
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_committed_configs_name_the_pipeline_reference(name):
    from spedbench.reference import pipeline

    assert cells.reference(cells.load(name)) is pipeline


def _naming(cell, reference):
    return dataclasses.replace(cell, config={**cell.config,
                                             "reference": reference})


@pytest.mark.parametrize("path", [
    "src/repro_torch/core/kmeans.py", "/spedbench/reference/pipeline.py",
    "spedbench/../src/ref.py", "spedbench/reference/pipeline.json"])
def test_a_reference_outside_the_benchmark_is_refused(path):
    with pytest.raises(ValueError):
        cells.reference(_naming(cells.load("sbm4m.limit251"), path))


@pytest.mark.parametrize("entry", ["run", "control"])
def test_a_config_gets_the_reference_it_names(entry, tiny_cell, monkeypatch):
    """A config that names another module has the run and the control
    call that module's ``solve`` and ``labels``."""
    from spedbench import control
    from spedbench.reference import compare, pipeline

    calls = []
    other = types.ModuleType("spedbench.reference.other")

    def solve(*args, **kwargs):
        calls.append("solve")
        return pipeline.solve(*args, **kwargs)

    def labels(*args, **kwargs):
        calls.append("labels")
        return pipeline.labels(*args, **kwargs)

    other.solve, other.labels = solve, labels
    monkeypatch.setitem(sys.modules, other.__name__, other)
    cell = _naming(tiny_cell("sbm4m.limit251"), "spedbench/reference/other.py")
    assert cells.reference(cell) is other
    if entry == "run":
        assert bench.run(cell, 13, 0.01, False, "cpu", time.time())["correct"]
        assert calls == ["solve", "labels"]
    else:
        out = control.readings(cell, 13, "cpu")
        assert compare.judge(out["program"], cell.limits)[0]
        assert calls == ["solve", "labels"] * 2


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no-such.cell")


def _timeline():
    ms = 1_000_000
    device = [("row_gather_kernel<4>", 10 * ms, 14 * ms),
              ("row_gather_kernel<4>", 14 * ms, 18 * ms),
              ("gram2k_partial_kernel", 18 * ms, 19 * ms),
              ("panel_mix_rows_kernel", 19 * ms, 20 * ms),
              ("reduce_kernel", 30 * ms, 90 * ms)]
    host = [("aten::sum", 20 * ms, 29 * ms)]
    return trace.Timeline(device=device, host=host, jobs=[(0, 100 * ms)],
                          start=0, end=100 * ms)


def test_readers_on_a_made_up_trace():
    shapes = {"n": 1 << 22, "k": 32, "half_edges": 71_299_936, "degree": 2,
              "steps": 1, "estimation": "exact_edges"}
    ctx = bench.LayerContext(_timeline(), shapes,
                             {"edge_spmm_nb": 2, "edge_spmm": 0}, steps_run=1)
    read = {m: cells.reader(m)(ctx) for m in (
        "prep_ms", "post_ms", "solve_step_ms", "step_roofline",
        "spmm_calls_per_step", "spmm_roofline", "eg_roofline",
        "device_idle_pct")}
    assert read["prep_ms"] == pytest.approx(10.0)
    assert read["post_ms"] == pytest.approx(80.0)
    assert read["solve_step_ms"] == pytest.approx(10.0)
    assert read["spmm_calls_per_step"] == 2.0
    k2 = roofline.bound_s(roofline.k2_bytes(71_299_936, 1 << 22, 32),
                          roofline.k2_flops(71_299_936, 1 << 22, 32))
    assert read["spmm_roofline"] == pytest.approx(100 * k2 / 4e-3)
    assert read["step_roofline"] == pytest.approx(
        100 * roofline.step_bound_s(shapes) / 10e-3)
    eg = roofline.bound_s(roofline.eg_bytes(1 << 22, 32),
                          roofline.eg_flops(1 << 22, 32))
    assert read["eg_roofline"] == pytest.approx(100 * eg / 2e-3)
    assert read["device_idle_pct"] == pytest.approx(30.0)


def test_readers_find_nothing_in_an_empty_trace():
    ctx = bench.LayerContext(trace.Timeline([], [], [], 0, 0), {"steps": 1},
                             {}, steps_run=0)
    for m in ("prep_ms", "post_ms", "solve_step_ms", "step_roofline",
              "spmm_calls_per_step", "spmm_roofline", "eg_roofline",
              "device_idle_pct"):
        assert cells.reader(m)(ctx) is None


def test_breakdown_names_the_longest_ops_and_gaps():
    tl = _timeline()
    assert trace.busy_ns(tl) == 70_000_000
    br = trace.breakdown(tl)
    assert br["device_ops"][0] == ["reduce_kernel", pytest.approx(0.06)]
    assert br["device_ops"][1] == ["row_gather_kernel<4>", pytest.approx(0.008)]
    gaps = br["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([0.01, 0.01, 0.01])
    assert ["aten::sum", pytest.approx(0.01)] in gaps


def test_forbidden_modules_are_compared_whole(monkeypatch):
    assert "repro" not in bench.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    assert bench.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("repro.fake"))
    assert bench.loaded_forbidden() == ["repro"]


def test_a_run_loads_no_forbidden_module():
    """A whole run (at a CPU size) in a fresh process, then the check."""
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "from spedbench import run, cell\n"
        "from spedbench.tests.conftest import shrink\n"
        "c = shrink(cell.load('sbm4m.limit251'))\n"
        "r = run.run(c, 3, 0.01, True, 'cpu', time.time())\n"
        "import spedbench.control\n"
        "print('FORBIDDEN', run.loaded_forbidden(), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN [] True" in out.stdout


def test_result_line_keys(tiny_cell):
    r = bench.run(tiny_cell("sbm4m.limit251"), 2**31 + 5, 0.01, False, "cpu",
                  time.time())
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert set(r["metrics"]) == {"cluster_s", "peak_gib", "setup_s"}
    # a window shorter than a job holds that one job
    assert r["attempted"] == 1 and r["metrics"]["setup_s"]["value"] > 0
    json.dumps(r)


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "spedbench.run", "--workload", "sbm4m.limit251",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert '"correct"' not in out.stdout


def test_benchmark_alone_prints_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and spedbench/ has no
    program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "spedbench", tmp_path / "spedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "spedbench.run", "--workload", "sbm4m.limit251",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
def test_a_small_cell_runs_on_the_card(tiny_cell):
    """The harness on the card at a CPU test's size (the kernel path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = bench.run(tiny_cell("sbm4m.limit251"), 17, 0.5, True, "cuda",
                  time.time())
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["spmm_calls_per_step"]["value"] == 31.0
