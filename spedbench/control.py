"""The readings that the limits of ``correct`` are set from, on the card
at the cell's own size: for each seed, the cell's graph, the program's
job 0 of a run on that seed (the timed path, as the window calls it),
the reference, and the control (the reference with every matrix product
on TF32 inputs, one precision below the configuration's float32, put in
the program's place: its own panel from the seed, and its k-means on the
program's panel), each compared with the reference by
``reference.compare.numbers``.  In a cell on the exact edges, also the
program's job 0 with :func:`half_edges` planted in it.

    python3 -m spedbench.control --workload sbm4m.limit251 \\
        --seeds 11,12,13 --out control.jsonl

One JSON line a seed: ``program`` gives the sound readings (the lower
end of each limit), ``control`` the control's (the upper end), and
``half_edges`` the fault's.  The benchmark's own runs do not run them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from spedbench import run as bench


@contextlib.contextmanager
def half_edges():
    """A fault planted in the program: every exact-edges operator built on
    every other edge, each weight doubled (half of the edges left out, the
    mean taken over the rest), the series' scale still from the whole
    graph."""
    from repro_torch.core import laplacian as lap
    from repro_torch.core import operators

    real = operators.edge_series_operator

    def halved(g, series, backend="auto"):
        h = lap.EdgeList(src=g.src[::2].contiguous(),
                         dst=g.dst[::2].contiguous(),
                         weight=2.0 * g.weight[::2], num_nodes=g.num_nodes)
        return real(h, series, backend=backend)

    operators.edge_series_operator = halved
    try:
        yield
    finally:
        operators.edge_series_operator = real


def readings(cell, seed: int, device, control: bool = True) -> dict:
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.core.clustering import spectral_cluster
    from spedbench import cell as cells
    from spedbench.reference import compare

    pipeline = cells.reference(cell)
    n = int(cell.config["num_nodes"])
    k = int(cell.config["num_clusters"])
    edges = cells.generator(cell)(cell.config, seed, device)
    g = lap.make_edge_list(edges, n, device=device)
    js = bench.job_seed(seed, 0)
    cfg = bench.clustering_config(cell, js)
    t0 = time.perf_counter()
    labels, info = spectral_cluster(g, cfg)
    v = info["eigvecs"]
    t1 = time.perf_counter()
    fault = None
    if cell.clustering["estimation"] == "exact_edges":
        # the fault's panel alone is judged, so one k-means restart will do
        with half_edges():
            _, fault_info = spectral_cluster(
                g, bench.clustering_config(cell, js, kmeans_restarts=1))
        fault = fault_info["eigvecs"]
        del fault_info
    del g, info
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ref = pipeline.solve(edges, n, cell.clustering, cell.solver, k, js)
    ref_labels = pipeline.labels(v, cell.clustering, k, js)
    t3 = time.perf_counter()
    out = {"cell": cell.name, "seed": seed,
           "program": compare.numbers(v, labels, ref, ref_labels),
           "program_s": t1 - t0, "reference_s": t3 - t2}
    if fault is not None:
        out["half_edges"] = {"eigvec_err": compare.numbers(
            fault, labels, ref, ref_labels)["eigvec_err"]}
    if control:
        ctl = pipeline.solve(edges, n, cell.clustering, cell.solver, k, js,
                             tf32=True)
        ctl_labels = pipeline.labels(v, cell.clustering, k, js, tf32=True)
        out["control"] = compare.numbers(ctl.v, ctl_labels, ref, ref_labels)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", default=None, help="append the lines here too")
    ap.add_argument("--skip-control", action="store_true",
                    help="leave the TF32 control out (the fault and the "
                         "program's readings only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(bench.SRC))
    from spedbench import cell as cells

    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, "cuda",
                                   control=not args.skip_control))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
