"""Build the repro_torch CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It exits non-zero, printing no result, without a card or
outside a checkout.  Phases, one JSON line each:

1. build   - compile csrc/*.cu for sm_90a (all sources in parallel)
2. check   - hold each kernel (K1 edge_spmm, K2 edge_spmm_nb, K3 gram2k,
             K4 panel_mix) against its plain PyTorch twin on the card at
             the main path's shapes, and time kernel, twin and one
             PyTorch library call that computes the same function
3. small   - spectral_cluster on a 160-node clique graph (600 mu-EG steps,
             degree-251 limit_neg_exp): agreement with the planted labels
4. full    - spectral_cluster on a 2^20-node sparse SBM (E ~ 8.9 M, k = 10,
             degree 251, 10 solver steps), then 3 solver steps of the kernel
             path against backend="segment" at n = 8192 (node-blocked)
5. kernels - per kernel: launches on the main path (phases 3 and 4, counts
             reset just before and read just after each), error, times and
             the bound of this run's inputs

The card's name and power limit are printed as nvidia-smi gives them, and
the last line is {"ok": true, "device": {...}}.  Numbers are fp32 with
TF32 off.  This script imports torch and the port, never JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# K1/K2/K4 are held to 1e-5 of the plain twin's largest magnitude: fp32
# atomics (K1, K2) add in a run-dependent order and K4 sums its k terms
# in another order than the plain matmuls.  K3 sums 2^20 products per
# entry in row slices, the plain gram in cuBLAS's order: 1e-5 of max|S|.
REL_TOL = 1e-5
# 3 solver steps of the kernel path vs backend="segment" (n = 8192):
# panels of unit columns, 3 x 251 fused steps and 3 mu-EG steps of fp32
STEPS_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    from repro_torch.core import (ClusteringConfig, SolverConfig, backend,
                                  graphs, limit_neg_exp, operators, solvers,
                                  spectral_cluster)
    from repro_torch.core import kmeans as km
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.kernels.edge_spmm import ref as es_ref
    from repro_torch.kernels.eg_update import ops as eg_ops
    from repro_torch.kernels.eg_update import ref as eg_ref

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def cuda_ms(fn, reps: int) -> float:
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def host_s(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    # ---- 1. build --------------------------------------------------------
    gpu = gpu_line()
    _, build_s = host_s(_build.library)
    emit({"phase": "build", "seconds": build_s, "gpu": gpu,
          "library": _build.build().name})

    # ---- 2. kernel checks at the main path's shapes ----------------------
    kernels = {}

    def compare(name, kernel_fn, plain_fn) -> tuple[float, float]:
        got = kernel_fn()
        want = plain_fn()
        sync()
        err = float((got - want).abs().max())
        tol = REL_TOL * float(want.abs().max())
        if not err <= tol:
            raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
        return err, tol

    def check(name, kernel_fn, plain_fn, library_fn, nbytes, flops, reps,
              replaces, source, matvec_pair=None):
        """Compare and time one kernel; ``matvec_pair`` also holds the
        SpMM kernels' plain matvec form (alpha=1, beta=0) to the twin, where
        the L V term is not dwarfed by beta * V."""
        err, tol = compare(name, kernel_fn, plain_fn)
        if matvec_pair is not None:
            compare(name + " (L V)", *matvec_pair)
        b_ms, b_by = bound(nbytes, flops)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "tolerance": tol,
            "ms": cuda_ms(kernel_fn, reps), "plain_ms": cuda_ms(plain_fn, reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library_fn, reps),
        }
        emit({"phase": "check", **kernels[name]})

    def csr_laplacian(g):
        n = g.num_nodes
        s, d = g.src.long(), g.dst.long()
        rows = torch.cat([s, d, torch.arange(n, device=dev)])
        cols = torch.cat([d, s, torch.arange(n, device=dev)])
        vals = torch.cat([-g.weight, -g.weight, lap.degrees(g)])
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                       (n, n)).coalesce().to_sparse_csr()

    def panel(n, k, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return solvers.init_state(gen, n, k).v

    k = 10
    # K1 at n = 4096 on the alpha = 2.5 power-law graph
    g1 = graphs.power_law_graph(4096, avg_degree=8, alpha=2.5, seed=0,
                                device=dev)
    v1 = panel(4096, k, 1)
    c1 = 8.0 / float(lap.spectral_radius_upper_bound(g1)) / 251
    l1 = csr_laplacian(g1)
    e1 = g1.num_edges
    check("edge_spmm",
          lambda: es_ops.edge_spmm(g1.src, g1.dst, g1.weight, v1, -c1, 1.0),
          lambda: es_ref.edge_spmm_affine(g1.src, g1.dst, g1.weight, v1, -c1, 1.0),
          lambda: torch.sparse.mm(l1, v1),
          nbytes=e1 * 12 + 2 * 4096 * k * 4, flops=e1 * k * 6 + 4096 * k,
          reps=200, replaces="src/repro/kernels/edge_spmm/kernel.py:94",
          source="src/repro_torch/csrc/edge_spmm.cu",
          matvec_pair=(
              lambda: es_ops.edge_spmm(g1.src, g1.dst, g1.weight, v1),
              lambda: es_ref.edge_spmm(g1.src, g1.dst, g1.weight, v1)))
    del l1

    # K2, K3, K4 at n = 2^20, k = 10 on the full-size sparse SBM
    n = 1 << 20
    (g, truth), graph_s = host_s(lambda: graphs.sparse_sbm_graph(
        n, 8, avg_degree_in=16, avg_degree_out=1, seed=0, device=dev))
    nb, blocking_s = host_s(lambda: backend.blocking_for(g))
    rho = float(lap.spectral_radius_upper_bound(g))
    c = 8.0 / rho / 251
    v = panel(n, k, 2)
    real_chunks, num_chunks = int(nb.block_chunks[-1]), nb.num_chunks
    slots = real_chunks * nb.block_e
    lfull = csr_laplacian(g)
    check("edge_spmm_nb",
          lambda: es_ops.edge_spmm_blocked(nb, v, -c, 1.0),
          lambda: es_ref.edge_spmm_blocked(
              nb.u_local, nb.other, nb.weight, nb.block_chunks, nb.deg, v,
              -c, 1.0, block_n=nb.block_n, block_e=nb.block_e),
          lambda: torch.sparse.mm(lfull, v),
          nbytes=slots * 12 + (nb.num_blocks + 1) * 4 + nb.padded_nodes * 4
          + 2 * n * k * 4,
          flops=2 * g.num_edges * k * 2 + 4 * n * k, reps=20,
          replaces="src/repro/kernels/edge_spmm/kernel.py:151",
          source="src/repro_torch/csrc/edge_spmm.cu",
          matvec_pair=(
              lambda: es_ops.edge_spmm_blocked(nb, v),
              lambda: es_ref.edge_spmm_blocked(
                  nb.u_local, nb.other, nb.weight, nb.block_chunks, nb.deg, v,
                  1.0, 0.0, block_n=nb.block_n, block_e=nb.block_e)))
    del lfull
    av = es_ops.edge_spmm_blocked(nb, v, -c, 1.0)
    x = torch.cat([v, av], dim=1)
    check("gram2k",
          lambda: eg_ops.gram2k(v, av), lambda: eg_ref.gram2k(v, av),
          lambda: x.T @ x,
          nbytes=2 * n * k * 4 + 4 * k * k * 4, flops=n * (2 * k) ** 2 * 2,
          reps=50, replaces="src/repro/kernels/eg_update/kernel.py:40",
          source="src/repro_torch/csrc/eg_update.cu")
    m1, m2, cs = eg_ref.coefficient_matrices(eg_ref.gram2k(v, av), k, 0.4)
    m_cat = torch.cat([m1, m2], dim=0) * cs[None, :]
    check("panel_mix",
          lambda: eg_ops.panel_mix(v, av, m1, m2, cs),
          lambda: eg_ref.panel_mix(v, av, m1, m2, cs),
          lambda: x @ m_cat,
          nbytes=3 * n * k * 4 + (2 * k * k + k) * 4,
          flops=n * k * (4 * k + 1), reps=50,
          replaces="src/repro/kernels/eg_update/kernel.py:64",
          source="src/repro_torch/csrc/eg_update.cu")
    del x, av, v, nb

    # ---- 3. small end-to-end (K1 path) -----------------------------------
    gs, truth_s = graphs.clique_graph(160, 4, seed=3, device=dev)
    cfg_s = ClusteringConfig(
        num_clusters=4, transform="limit_neg_exp", degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=600, eval_every=100),
        seed=0)
    reset_launch_counts()
    (labels_s, _), small_s = host_s(lambda: spectral_cluster(gs, cfg_s))
    counts_small = launch_counts()
    agreement = float(km.cluster_agreement(labels_s, truth_s, 4))
    emit({"phase": "small", "n": 160, "seconds": small_s,
          "agreement": agreement, "launches": counts_small})
    if not agreement > 0.95:
        raise AssertionError(f"small clique agreement {agreement} <= 0.95")
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_small[name] <= 0:
            raise AssertionError(f"small run launched no {name}")

    # ---- 4. full size (K2 path) ------------------------------------------
    cfg = ClusteringConfig(num_clusters=8, degree=251,
                           solver=SolverConfig(steps=10, eval_every=10), seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (labels, info), full_s = host_s(lambda: spectral_cluster(g, cfg))
    counts_full = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_full[name] <= 0:
            raise AssertionError(f"full-size run launched no {name}")
    eig = info["eigvecs"]
    if not (labels.shape == (n,) and eig.shape == (n, k)
            and bool(torch.isfinite(eig).all())
            and int(labels.min()) >= 0 and int(labels.max()) < 8):
        raise AssertionError("full-size run gave malformed output")
    col_norm_err = float((torch.linalg.vector_norm(eig, dim=0) - 1).abs().max())
    if not col_norm_err <= 1e-4:
        raise AssertionError(f"eigvec columns off unit norm by {col_norm_err}")
    # the pieces of one solver step, timed on the same graph
    s = limit_neg_exp(251, scale=8.0 / rho)
    op = operators.edge_series_operator(g, s, backend="kernel")
    st = solvers.init_from_panel(eig)
    op_ms = cuda_ms(lambda: op(st.v), 3)
    step_fn = solvers.make_step_fn("mu_eg", "kernel", dev)
    step_ms = cuda_ms(lambda: step_fn(st, op(st.v), 1e-3), 3)
    emb = info["embedding"]
    gen = torch.Generator(device=dev).manual_seed(1)
    kmeans_ms = cuda_ms(lambda: km.kmeans(gen, emb, 8), 1)
    agreement_full = float(km.cluster_agreement(labels, truth, 8))
    # 3 solver steps of the kernel path vs segment, node-blocked n = 8192
    g8, _ = graphs.sparse_sbm_graph(8192, 8, avg_degree_in=16,
                                    avg_degree_out=1, seed=0, device=dev)
    s8 = limit_neg_exp(251, scale=8.0 / float(lap.spectral_radius_upper_bound(g8)))
    init8 = panel(8192, k, 3)
    out8 = {}
    for b in ("segment", "kernel"):
        op8 = operators.edge_series_operator(g8, s8, backend=b)
        cfg8 = SolverConfig(lr=0.4, steps=3, eval_every=3, k=k, backend=b)
        out8[b] = solvers.run_solver(op8, 8192, cfg8, init_v=init8)[0].v
    steps_err = float((out8["segment"] - out8["kernel"]).abs().max())
    emit({"phase": "full", "n": n, "num_edges": g.num_edges, "k": k,
          "degree": 251, "solver_steps": 10, "graph_host_s": graph_s,
          "blocking_host_s": blocking_s, "real_chunks": real_chunks,
          "num_chunks": num_chunks,
          "spectral_cluster_s": full_s,
          "fused_series_step_ms": op_ms / 251, "operator_ms": op_ms,
          "solver_step_ms": step_ms, "kmeans_ms": kmeans_ms,
          "max_memory_allocated": peak_bytes, "agreement": agreement_full,
          "launches": counts_full,
          "n8192_three_step_max_abs_err": steps_err,
          "n8192_tolerance": STEPS_TOL})
    if not steps_err <= STEPS_TOL:
        raise AssertionError(f"3 kernel-path steps differ from segment by "
                             f"{steps_err} > {STEPS_TOL}")

    # ---- 5. kernel list --------------------------------------------------
    for name, row in kernels.items():
        row["launches"] = counts_small[name] + counts_full[name]
        if row["launches"] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    emit({"kernels": list(kernels.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
