"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m spedbench.run --workload sbm4m.limit251 --seed 7 \\
        --seconds 51 --trace 0

A run makes the cell's graph on the card from ``--seed``, hands it to the
program (``repro_torch``) as an edge list, warms up one job of one step
at the cell's shapes, then runs whole ``spectral_cluster`` jobs back to
back: the first always, and each next one only where, at the pace of
the last, it ends within ``--seconds`` of the window's start.  After the
window it checks one job, drawn from the seed, against
the plain reference that the config names, and prints one JSON line
last: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics from a ``torch.profiler`` trace of the window's first job
(``--trace 1``; the window runs on untraced, so a traced run takes as
long as an untraced one and its trace stays small).
Earlier lines describe the graph, the card and the checked job; the last
lines on standard error give each number compared beside its limit.

Without a card, or with fewer cards than the cell asks for, it prints
no result and exits with 2.  The program's kernel library is built at
its first use into ``build/repro_torch/`` under the checkout (the
program's own fixed cache) and reused by later runs.
"""
from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"
# top-level module names no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)
JOBS_PER_SEED = 4096  # job j of seed s runs with seed s * 4096 + j
WARM_JOB = JOBS_PER_SEED - 1
SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm",
              "clocks.max.sm", "clocks.mem", "temperature.gpu")


def process_start() -> float:
    """Epoch seconds at which this process started (from ``/proc``), or
    the time this module was imported where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def log(**fields) -> None:
    print(json.dumps(fields, default=str), flush=True)


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> list[dict]:
    """Name, power and clocks of every card, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [dict(zip(SMI_FIELDS, (x.strip() for x in line.split(","))))
            for line in out.strip().splitlines()]


def job_seed(seed: int, job: int) -> int:
    return seed * JOBS_PER_SEED + job


def clustering_config(cell, seed: int, **overrides):
    """The program's ``ClusteringConfig`` of one job of the cell's mix;
    ``overrides`` replace clustering or solver fields (the warm-up)."""
    from repro_torch.core.clustering import ClusteringConfig
    from repro_torch.core.solvers import SolverConfig

    clustering = dict(cell.clustering)
    solver = dict(cell.solver)
    for key, val in overrides.items():
        (solver if key in solver else clustering)[key] = val
    return ClusteringConfig(num_clusters=cell.config["num_clusters"],
                            seed=seed, solver=SolverConfig(**solver),
                            **clustering)


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def run(cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict | None:
    """One run of ``cell`` on ``device``; the result line's object, or
    None when, after the window and the check, a module that no run may
    load is loaded (named on standard error)."""
    import torch
    from torch.profiler import record_function

    from repro_torch import kernels
    from repro_torch.core import laplacian as lap
    from repro_torch.core.clustering import spectral_cluster
    from repro_torch.kernels.edge_spmm.ops import HUB_THRESHOLD
    from spedbench import cell as cells
    from spedbench import roofline, trace
    from spedbench.reference import compare

    pipeline = cells.reference(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # the inputs, made on the card from the seed
    n = int(cell.config["num_nodes"])
    edges = cells.generator(cell)(cell.config, seed, dev)
    g = lap.make_edge_list(edges, n, device=dev)
    deg = torch.bincount(edges.reshape(-1).long(), minlength=n)
    shapes = {"n": n, "k": int(cell.config["k"]), "edges": g.num_edges,
              "half_edges": 2 * g.num_edges,
              "degree": int(cell.clustering["degree"]), "steps": cell.steps,
              "estimation": cell.clustering["estimation"],
              "batch_edges": int(cell.clustering.get("batch_edges", 0))}
    if shapes["estimation"] == "minibatch":
        shapes["touched_rows"] = roofline.expected_touched_rows(
            deg, shapes["batch_edges"])
    log(cell=cell.name, seed=seed, **shapes,
        hub_rows=int((deg > HUB_THRESHOLD).sum()),
        max_degree=int(deg.max()), isolated=int((deg == 0).sum()))
    del deg

    # warm-up: one job of one step and one k-means restart at the shapes
    # of the window's jobs (builds the kernel library on a first run)
    warm = clustering_config(cell, job_seed(seed, WARM_JOB), steps=1,
                             eval_every=1, kmeans_restarts=1)
    spectral_cluster(g, warm)
    sync()
    setup_s = time.time() - started

    # the window: whole jobs back to back, each next one only where it
    # ends by the deadline at the last one's pace; one job, drawn from the
    # seed among those that ran, keeps its answer for the check
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    draw = random.Random(seed)
    kept = prof = None
    jobs = 0
    job_ends = []
    sync()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        cfg = clustering_config(cell, job_seed(seed, jobs))
        tracing = traced and jobs == 0
        if tracing:
            prof = _profiler(cuda)
            prof.start()
            traced_from = kernels.launch_counts()
        with record_function(trace.JOB_SPAN) if tracing else contextlib.nullcontext():
            labels, info = spectral_cluster(g, cfg)
            sync()
        if tracing:
            prof.stop()
            traced_launches = {name: c - traced_from[name]
                               for name, c in kernels.launch_counts().items()}
        if draw.randrange(jobs + 1) == 0:
            kept = (jobs, info["eigvecs"], labels, info["plan"])
        jobs += 1
        del labels, info
        job_ends.append(time.perf_counter())
        pace = job_ends[-1] - (job_ends[-2] if jobs > 1 else t_start)
        if job_ends[-1] + pace > deadline:
            break
    t_end = job_ends[-1]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {name: c - before[name]
                for name, c in kernels.launch_counts().items()}
    smi = nvidia_smi() if cuda else []
    log(window_s=t_end - t_start, jobs=jobs,
        job_s=[b - a for a, b in zip([t_start] + job_ends, job_ends)],
        launches=launches,
        peak_bytes=peak, nvidia_smi=smi)
    metrics: dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if smi:
        device_info.update({"power_limit_w": smi[0].get("power.limit"),
                            "clocks_sm_mhz": smi[0].get("clocks.sm"),
                            "clocks_max_sm_mhz": smi[0].get("clocks.max.sm"),
                            "clocks_mem_mhz": smi[0].get("clocks.mem")})
    result_extra = {}
    if traced:
        tl = trace.from_profiler(prof)
        del prof
        log(trace_events={"host": len(tl.host), "device": len(tl.device)},
            job_spans=len(tl.jobs), traced_window_s=(tl.end - tl.start) / 1e9)
        ctx = LayerContext(timeline=tl, shapes=shapes, launches=traced_launches,
                           steps_run=len(tl.jobs) * cell.steps)
        for m in cell.per_layer:
            val = cells.reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_ns(tl) / 1e9
        device_info["window_s"] = (tl.end - tl.start) / 1e9
        result_extra["breakdown"] = trace.breakdown(tl)
        del tl, ctx
    else:
        e2e = {"cluster_s": (t_end - t_start) / jobs, "peak_gib": peak / GIB,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check, once the program's state is freed: the kept job's answer
    # against the reference's on the same edges and seeds
    job, v, labels, plan = kept
    del g
    if cuda:
        torch.cuda.empty_cache()
    k = int(cell.config["num_clusters"])
    t_ref = time.perf_counter()
    ref = pipeline.solve(edges, n, cell.clustering, cell.solver, k,
                         job_seed(seed, job))
    ref_labels = pipeline.labels(v, cell.clustering, k, job_seed(seed, job))
    values = compare.numbers(v, labels, ref, ref_labels)
    ok, checks = compare.judge(values, cell.limits)
    log(checked_job=job, plan=plan,
        reference_s=time.perf_counter() - t_ref)
    found = loaded_forbidden()
    if found:
        print(f"loaded forbidden modules: {', '.join(found)}", file=sys.stderr)
        return None
    return {"correct": ok, "attempted": jobs, "failed": 0 if ok else 1,
            "metrics": metrics, "device": device_info, **result_extra,
            "checks": {name: {key: _finite(x) for key, x in c.items()}
                       for name, c in checks.items()}}


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads: the traced job's ``timeline``
    (``spedbench.trace.Timeline``), the cell's ``shapes``, the program's
    kernel ``launches`` during the traced job, and ``steps_run``, its
    solver steps."""

    timeline: object
    shapes: dict
    launches: dict
    steps_run: int


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(SRC))
    from spedbench import cell as cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if SRC not in where.parents:
        print(f"repro_torch loaded from {where}, not from {SRC}", file=sys.stderr)
        return 2
    log(card=torch.cuda.get_device_name(0), cards=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
