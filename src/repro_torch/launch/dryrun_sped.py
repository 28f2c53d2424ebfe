"""Dry-run of the paper's own workload at production scale: one
distributed SPED solver step (the series-transformed Laplacian operator
and a mu-EigenGame update) on a synthetic web-scale graph, reported for
the 16 x 16 pod and the 2 x 16 x 16 multi-pod mesh.

Graph stand-in: n = 2^22 nodes, E = 2^26 edges.  The edges are sharded
over every axis of the mesh (each rank holds its contiguous slice
``[s E/S, (s+1) E/S)``, ``core.distributed``'s split) and the (n, k)
panel V is replicated.  Each Laplacian matvec is the rank's edge gather
and ``index_add_`` scatter, then an all_reduce of the panel over the
edge group, so a degree-d series costs d or 2d panel all_reduces:

  limit251      - the paper's -(I - L/251)^251, f32 panel: two scatters
                  and two f32 all_reduces a matvec;
  cheb64        - Chebyshev(64) of -e^{-tau x} (the same spectral
                  accuracy in about 4x fewer matvecs): two scatters and
                  two f32 all_reduces a matvec;
  cheb64_fused  - one concatenated scatter and one f32 all_reduce a
                  matvec;
  cheb64_bf16   - the fused matvec on a bf16 panel with one explicit
                  bf16 all_reduce: half the payload again.

The matvecs are plain PyTorch, as the JAX package's are plain XLA
scatter-adds: this path reaches no kernel.

A cell's report (:func:`run_cell`) has the JAX package's keys.  No
compiler reports on the step here, so ``flops`` and ``bytes_accessed``
are None and ``memory`` is reckoned for one rank: the replicated f32
panel plus its E/devices edges of 12 bytes (``argument_bytes``), the
panel (``output_bytes``), and no ``temp_bytes``.  ``collectives`` holds
the port's own all_reduces a step, counted at run time (:func:`stats`)
on a small graph in this process, with their bytes reckoned at the
production shape: they are not counts parsed from a compiled program.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_sped \\
        --variant cheb64 --mesh both --out experiments/dryrun --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.core import series as series_lib
from repro_torch.core import solvers
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh

N_NODES = 1 << 22
N_EDGES = 1 << 26
K = 32
RHO_UB = 64.0  # spectral-radius bound fed to the scaled and cheb variants
VARIANTS = ("limit251", "cheb64", "cheb64_fused", "cheb64_bf16")
# the small graph on which run_cell counts a step's all_reduces
COUNT_NODES, COUNT_EDGES, COUNT_K = 64, 256, 4

# all_reduces issued by the steps since the last reset, and their bytes
_STATS = {"all_reduce": 0, "bytes": 0}


def stats() -> dict:
    """The steps' all_reduce calls since :func:`reset_stats`, and their
    payload bytes (a call on a group of one rank is counted, not run)."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(all_reduce=0, bytes=0)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (None: this rank alone)."""
    _STATS["all_reduce"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def make_series(variant: str) -> series_lib.SpectralSeries:
    if variant == "limit251":
        return series_lib.limit_neg_exp(251, scale=8.0 / RHO_UB)
    if variant.startswith("cheb64"):
        return series_lib.cheb_neg_exp(64, rho=RHO_UB, tau=8.0 / RHO_UB)
    raise ValueError(variant)


def build_step(variant: str, mesh, edge_axes, lr: float = 0.1):
    """``step(v, edges) -> v'``: one mu-EG step on the reversed series of
    ``variant`` applied to the f32 panel ``v`` (n, k), every rank taking
    the global ``edges`` ({"src", "dst": int32 (E,), "weight": f32 (E,)})
    and keeping its slice over ``edge_axes`` of ``mesh`` (None: all of
    them, one rank).  Returns the replicated f32 panel."""
    s = make_series(variant)
    panel_dtype = torch.bfloat16 if variant.endswith("bf16") else torch.float32
    fused = variant.endswith(("fused", "bf16"))
    edge_axes = tuple(edge_axes)
    group = None if mesh is None else parallel.edge_group(mesh, edge_axes)

    def step(v: torch.Tensor, edges: dict) -> torch.Tensor:
        e = edges["src"].shape[0]
        lo, hi = ((0, e) if mesh is None
                  else parallel.shard_bounds(e, mesh, edge_axes))
        src, dst = edges["src"][lo:hi], edges["dst"][lo:hi]
        w = edges["weight"][lo:hi]
        idx = torch.cat([src, dst]) if fused else None

        def matvec(u):
            m = src.shape[0]
            # [w (u_src - u_dst); -w (u_src - u_dst)], formed in place
            upd = u.new_empty((2 * m if fused else m, u.shape[1]))
            wdiff = upd[:m]
            torch.index_select(u, 0, src, out=wdiff)
            wdiff.sub_(u[dst]).mul_(w.to(u.dtype)[:, None])
            if fused:  # one concatenated scatter, one all_reduce
                torch.neg(wdiff, out=upd[m:])
                return _psum(torch.zeros_like(u).index_add_(0, idx, upd), group)
            out = _psum(torch.zeros_like(u).index_add_(0, src, wdiff), group)
            return out + _psum(torch.zeros_like(u).index_add_(0, dst,
                                                              wdiff.neg_()),
                               group)

        av = s.apply_reversed(matvec, v.to(panel_dtype))
        state = solvers.SolverState(
            v=v, step=torch.zeros((), dtype=torch.int32, device=v.device))
        return solvers.mu_eg_step(state, av.float(), lr).v

    return step


def random_edges(n: int, e: int, seed: int, device=None) -> dict:
    """E random edges (self-loops moved off) over n nodes with weights in
    [0.5, 1.5), drawn from a numpy seed: int32 src/dst, f32 weight."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e, dtype=np.int64)
    dst = rng.integers(0, n, e, dtype=np.int64)
    dst = np.where(dst == src, (dst + 1) % n, dst)
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    dev = resolve_device(device)
    return {"src": torch.from_numpy(src.astype(np.int32)).to(dev),
            "dst": torch.from_numpy(dst.astype(np.int32)).to(dev),
            "weight": torch.from_numpy(w).to(dev)}


def count_step(variant: str, device=None) -> dict:
    """The all_reduces (calls, and payload bytes of a (n, k) panel
    element each) one step of ``variant`` issues, counted at run time on
    a small graph in this process."""
    dev = resolve_device(device)
    edges = random_edges(COUNT_NODES, COUNT_EDGES, seed=0, device=dev)
    v = torch.linalg.qr(torch.randn(COUNT_NODES, COUNT_K, device=dev,
                                    generator=torch.Generator(dev).manual_seed(0)
                                    ))[0].contiguous()
    reset_stats()
    build_step(variant, None, ())(v, edges)
    st = stats()
    reset_stats()
    return {"count": st["all_reduce"],
            "element_bytes": st["bytes"] // (st["all_reduce"]
                                             * COUNT_NODES * COUNT_K)}


def argument_bytes(devices: int) -> int:
    """One rank's reckoned arguments on ``devices`` devices: the
    replicated f32 (N_NODES, K) panel and its N_EDGES/devices edges of
    12 bytes (int32 src and dst, f32 weight)."""
    return N_NODES * K * 4 + N_EDGES // devices * 12


def run_cell(variant: str, multi_pod: bool, device=None) -> dict:
    """The cell's record with the JAX package's keys (see the module's
    docstring); ``device`` (None = the card) runs the counting step."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    s = make_series(variant)
    devices = mesh.size
    # analytic terms: degree matvecs of O(E/devices * K) gather/scatter
    # plus K*N panel ops; compute is the edge segment sums
    flops = s.degree * (6.0 * N_EDGES * K) / devices
    hbm = s.degree * (N_EDGES * (3 * 4 + 2 * 4 * K) / devices
                      + 2 * N_NODES * K * 4)
    counted = count_step(variant, device)
    ar_bytes = counted["count"] * N_NODES * K * counted["element_bytes"]
    panel = N_NODES * K * 4
    return {
        "arch": f"sped-graph-{variant}",
        "shape": f"n{N_NODES >> 20}M_e{N_EDGES >> 20}M_k{K}",
        "mesh": "multipod" if multi_pod else "pod",
        "status": "ok", "kind": "sped_step",
        "devices": devices,
        "seconds": round(time.time() - t0, 1),
        "flops": None,
        "bytes_accessed": None,
        "analytic": {"flops_per_dev": flops, "hbm_bytes_per_dev": hbm,
                     "degree": s.degree},
        "memory": {
            "argument_bytes": argument_bytes(devices),
            "output_bytes": panel,
            "temp_bytes": None,
        },
        "collectives": {"bytes": {"all-reduce": ar_bytes},
                        "count": {"all-reduce": counted["count"]},
                        "total_bytes": ar_bytes},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun_sped")
    ap.add_argument("--variant", default="all", choices=list(VARIANTS) + ["all"])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="torch device of the counting step (default: the "
                         "CUDA card; 'cpu' for the plain PyTorch path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"python -m repro_torch.launch.dryrun_sped: {e}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    variants = VARIANTS if args.variant == "all" else [args.variant]
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "multipod"]
    for var in variants:
        for mp in meshes:
            res = run_cell(var, mp, device)
            tag = f"sped__{var}__{'multipod' if mp else 'pod'}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            c = res["collectives"]
            print(f"[sped-dryrun] {tag}: coll={c['total_bytes']:.3g}B "
                  f"(AR count {c['count'].get('all-reduce', 0)}) "
                  f"temp={res['memory']['temp_bytes']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
