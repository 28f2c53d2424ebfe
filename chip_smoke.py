"""Build the repro_torch CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It exits non-zero, printing no result, without a card or
outside a checkout.  Phases, one JSON line each:

1. build   - compile csrc/*.cu for sm_90a (all sources in parallel)
2. check   - hold each kernel (K1 edge_spmm, K2 edge_spmm_nb, K3 gram2k,
             K4 panel_mix, K5 poly_step, K6 dense_matvec_panel) against
             its plain PyTorch twin on the card at the main path's shapes,
             and time kernel, twin and one PyTorch library call that
             computes the same function; for K1 and K2 also 200 calls
             captured in one CUDA graph and replayed (kernel and library
             call), whether two calls are bitwise equal, and (K1) the raw
             per-call entry that builds its row CSR each time; K3 and K4
             with the same graph times and bitwise check
   ragged  - K3 and K4 at n = 1,000,003, k = 7 on panels 4 bytes past a
             16-byte boundary: error and the bitwise check
   hub     - K2 on power_law_graph(2^20, 8, 2.5, seed=0), whose longest
             rows go to the kernel's hub blocks: error, time, bound
3. small   - spectral_cluster on a 160-node clique graph (600 mu-EG steps,
             degree-251 limit_neg_exp): agreement with the planted labels
4. full    - spectral_cluster on a 2^20-node sparse SBM (E ~ 8.9 M, k = 10,
             degree 251, 10 solver steps), then 3 solver steps of the kernel
             path against backend="segment" at n = 8192 (node-blocked)
5. dense   - limit_series_apply (251 K5 steps) on the dense L of a
             16384-node sparse SBM against the plain series, beside the
             unfused baseline (251 K6 products plus the AXPY)
6. auto_small - spectral_cluster(transform="auto") on the clique graph of
             phase 3: the SLQ probe (K1), the plan, the planned solve
7. auto_full - spectral_cluster(transform="auto") on phase 4's 2^20-node
             graph: probe on K1, planned solve on K2-K4, 10 solver steps;
             K1 held to its twin on the (2^20, 4) probe panel, and the SLQ
             probe on K1 to the one on backend="segment" from that panel
8. kernels - per kernel: launches on the main path (phases 3, 4, 5, 6 and
             7, counts reset just before and read just after each), error,
             times and the bound of this run's inputs

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

# K1/K2/K4 are held to 1e-5 of the plain twin's largest magnitude: K1 and
# K2 sum each row in registers in another order than the twins'
# index_add_, and K4 sums its k terms in another order than the plain
# matmuls.  K3 sums 2^20 products per entry in row slices, the plain gram
# in cuBLAS's order: 1e-5 of max|S|.
REL_TOL = 1e-5
# kernel calls captured in one CUDA graph for graph_ms
GRAPH_CALLS = 200
# 3 solver steps of the kernel path vs backend="segment" (n = 8192):
# panels of unit columns, 3 x 251 fused steps and 3 mu-EG steps of fp32
STEPS_TOL = 1e-4
# 251 K5 steps vs the plain series (cuBLAS fp32 matmuls): each step rounds
# at ~1e-7 of the panel's scale, 251 of them stay below 1e-4 of it
DENSE_TOL = 1e-4
# the probe's lambda_max vs the largest weighted degree, a lower bound on
# lambda_max (a diagonal entry of L is a Rayleigh quotient): 24 Lanczos
# steps leave the top edge a few percent unconverged at most
LMAX_SLACK = 0.05
# the 2^20-node SLQ probe run on K1 vs on backend="segment" from the same
# (n, 4) panel: lambda_max and trace relative to the segment run.  The
# trace is n * mean(v^T L v) and moves with one matvec's rounding (~1e-7);
# lambda_max adds a residual correction read off the top Ritz vectors,
# which the dense top of the spectrum leaves less well conditioned, so it
# gets the card test's 1e-3 (a wrong K1 scatter is off by far more)
SLQ_TOL = 1e-3


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

    from repro_torch import spectral
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
    from repro_torch.kernels.laplacian_poly import ops as lp_ops
    from repro_torch.kernels.laplacian_poly import ref as lp_ref

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

    def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
        """ms per call of ``calls`` calls captured in one CUDA graph."""
        fn()
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        sync()
        del graph
        return start.elapsed_time(end) / (reps * calls)

    def library_graph_ms(fn) -> tuple[float | None, str | None]:
        try:
            return graph_ms(fn), None
        except Exception as exc:  # the library call refused capture
            sync()
            return None, f"{type(exc).__name__}: {exc}"[:300]

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
              replaces, source, matvec_pair=None, also=(), graphs=False):
        """Compare and time one kernel; ``matvec_pair`` also holds the
        SpMM kernels' plain matvec form (alpha=1, beta=0) to the twin, where
        the L V term is not dwarfed by beta * V; ``also`` holds the kernel
        to further (label, plain_fn) references.  ``graphs`` adds the
        CUDA-graph times and the run-to-run bitwise check."""
        err, tol = compare(name, kernel_fn, plain_fn)
        if matvec_pair is not None:
            compare(name + " (L V)", *matvec_pair)
        for label, ref_fn in also:
            compare(f"{name} ({label})", kernel_fn, ref_fn)
        b_ms, b_by = bound(nbytes, flops)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "tolerance": tol,
            "ms": cuda_ms(kernel_fn, reps), "plain_ms": cuda_ms(plain_fn, reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library_fn, reps),
        }
        if graphs:
            kernels[name]["graph_ms"] = graph_ms(kernel_fn)
            lib_ms, lib_reason = library_graph_ms(library_fn)
            kernels[name].update(
                library_graph_ms=lib_ms, library_graph_refused=lib_reason,
                bitwise_repeatable=bool(torch.equal(kernel_fn(), kernel_fn())))
            if not kernels[name]["bitwise_repeatable"]:
                raise AssertionError(f"{name}: two calls differ")
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
    # the row CSR the main path builds once per edge list
    rows1 = es_ops.build_edge_rows(g1.src, g1.dst, g1.weight, 4096)
    check("edge_spmm",
          lambda: es_ops.edge_spmm_rows(rows1, v1, -c1, 1.0),
          lambda: es_ref.edge_spmm_rows(rows1.row_ptr, rows1.other,
                                        rows1.weight, v1, -c1, 1.0),
          lambda: torch.sparse.mm(l1, v1),
          nbytes=e1 * 12 + 2 * 4096 * k * 4, flops=e1 * k * 6 + 4096 * k,
          reps=200, replaces="src/repro/kernels/edge_spmm/kernel.py:94",
          source="src/repro_torch/csrc/edge_spmm.cu",
          matvec_pair=(
              lambda: es_ops.edge_spmm_rows(rows1, v1),
              lambda: es_ref.edge_spmm(g1.src, g1.dst, g1.weight, v1)),
          also=[("edge-list twin", lambda: es_ref.edge_spmm_affine(
              g1.src, g1.dst, g1.weight, v1, -c1, 1.0))], graphs=True)
    kernels["edge_spmm"].update(
        raw_call_ms=cuda_ms(lambda: es_ops.edge_spmm(
            g1.src, g1.dst, g1.weight, v1, -c1, 1.0), 200),
        row_csr_build_ms=cuda_ms(lambda: es_ops.build_edge_rows(
            g1.src, g1.dst, g1.weight, 4096), 200),
        longest_row=int((rows1.row_ptr[1:] - rows1.row_ptr[:-1]).max()),
        hub_slots=int(rows1.hub_rows.shape[0]))
    del l1

    # K2, K3, K4 at n = 2^20, k = 10 on the full-size sparse SBM
    n = 1 << 20
    (g, truth), graph_s = host_s(lambda: graphs.sparse_sbm_graph(
        n, 8, avg_degree_in=16, avg_degree_out=1, seed=0, device=dev))
    # the row CSR the main path builds on the card; the JAX-equal chunk
    # layout, built on the host, only for the chunk-layout twin
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, n)
    rows_ms = cuda_ms(lambda: es_ops.build_edge_rows(g.src, g.dst, g.weight,
                                                     n), 3)
    nb, blocking_s = host_s(lambda: backend.blocking_for(g))
    rho = float(lap.spectral_radius_upper_bound(g))
    c = 8.0 / rho / 251
    v = panel(n, k, 2)
    real_chunks, num_chunks = int(nb.block_chunks[-1]), nb.num_chunks
    slots = real_chunks * nb.block_e
    lfull = csr_laplacian(g)

    def k2_bytes(graph):
        # the edge list (src, dst, w), V and out once each: the work of the
        # graph, whatever layout a kernel reads
        return graph.num_edges * 12 + 2 * graph.num_nodes * k * 4

    check("edge_spmm_nb",
          lambda: es_ops.edge_spmm_rows_nb(rows, v, -c, 1.0),
          lambda: es_ref.edge_spmm_rows(rows.row_ptr, rows.other,
                                        rows.weight, v, -c, 1.0),
          lambda: torch.sparse.mm(lfull, v),
          nbytes=k2_bytes(g),
          flops=2 * g.num_edges * k * 2 + 4 * n * k, reps=20,
          replaces="src/repro/kernels/edge_spmm/kernel.py:151",
          source="src/repro_torch/csrc/edge_spmm.cu",
          matvec_pair=(
              lambda: es_ops.edge_spmm_rows_nb(rows, v),
              lambda: es_ref.edge_spmm_blocked(
                  nb.u_local, nb.other, nb.weight, nb.block_chunks, nb.deg, v,
                  1.0, 0.0, block_n=nb.block_n, block_e=nb.block_e)),
          also=[("chunk-layout twin", lambda: es_ref.edge_spmm_blocked(
              nb.u_local, nb.other, nb.weight, nb.block_chunks, nb.deg, v,
              -c, 1.0, block_n=nb.block_n, block_e=nb.block_e))],
          graphs=True)
    # the bound the earlier count gave: the real chunk slots of the chunk
    # layout K2 no longer reads
    kernels["edge_spmm_nb"].update(
        chunk_layout_bound_ms=bound(
            slots * 12 + (nb.num_blocks + 1) * 4 + nb.padded_nodes * 4
            + 2 * n * k * 4, 0)[0],
        row_csr_build_ms=rows_ms)
    del lfull, nb

    # K2 on a power-law graph whose longest rows take the hub blocks
    (gp, _), hub_graph_s = host_s(lambda: (graphs.power_law_graph(
        n, avg_degree=8, alpha=2.5, seed=0, device=dev), None))
    rows_p = es_ops.build_edge_rows(gp.src, gp.dst, gp.weight, n)
    hub_rows_ms = cuda_ms(lambda: es_ops.build_edge_rows(
        gp.src, gp.dst, gp.weight, n), 3)
    vp = panel(n, k, 5)
    cp = 8.0 / float(lap.spectral_radius_upper_bound(gp)) / 251
    hub_err, hub_tol = compare(
        "edge_spmm_nb (hub graph)",
        lambda: es_ops.edge_spmm_rows_nb(rows_p, vp, -cp, 1.0),
        lambda: es_ref.edge_spmm_rows(rows_p.row_ptr, rows_p.other,
                                      rows_p.weight, vp, -cp, 1.0))
    hub_edge_err, _ = compare(
        "edge_spmm_nb (hub graph, edge-list twin)",
        lambda: es_ops.edge_spmm_rows_nb(rows_p, vp, -cp, 1.0),
        lambda: es_ref.edge_spmm_affine(gp.src, gp.dst, gp.weight, vp, -cp,
                                        1.0))
    hub_bound, _ = bound(k2_bytes(gp), 2 * gp.num_edges * k * 2 + 4 * n * k)
    hub = {"n": n, "num_edges": gp.num_edges, "max_abs_err": hub_err,
           "edge_list_twin_max_abs_err": hub_edge_err, "tolerance": hub_tol,
           "ms": cuda_ms(lambda: es_ops.edge_spmm_rows_nb(rows_p, vp, -cp, 1.0),
                         20),
           "bound_ms": hub_bound,
           "longest_row": int((rows_p.row_ptr[1:]
                               - rows_p.row_ptr[:-1]).max()),
           "hub_rows": int((rows_p.hub_rows < n).sum()),
           "hub_threshold": es_ops.HUB_THRESHOLD,
           "bitwise_repeatable": bool(torch.equal(
               es_ops.edge_spmm_rows_nb(rows_p, vp, -cp, 1.0),
               es_ops.edge_spmm_rows_nb(rows_p, vp, -cp, 1.0))),
           "graph_host_s": hub_graph_s, "row_csr_build_ms": hub_rows_ms}
    emit({"phase": "hub", **hub})
    if not hub["bitwise_repeatable"]:
        raise AssertionError("edge_spmm_nb on the hub graph: two calls differ")
    kernels["edge_spmm_nb"]["hub_graph"] = hub
    del gp, rows_p, vp
    av = es_ops.edge_spmm_rows_nb(rows, v, -c, 1.0)
    x = torch.cat([v, av], dim=1)
    check("gram2k",
          lambda: eg_ops.gram2k(v, av), lambda: eg_ref.gram2k(v, av),
          lambda: x.T @ x,
          nbytes=2 * n * k * 4 + 4 * k * k * 4, flops=n * (2 * k) ** 2 * 2,
          reps=50, replaces="src/repro/kernels/eg_update/kernel.py:40",
          source="src/repro_torch/csrc/eg_update.cu", graphs=True)
    m1, m2, cs = eg_ref.coefficient_matrices(eg_ref.gram2k(v, av), k, 0.4)
    m_cat = torch.cat([m1, m2], dim=0) * cs[None, :]
    check("panel_mix",
          lambda: eg_ops.panel_mix(v, av, m1, m2, cs),
          lambda: eg_ref.panel_mix(v, av, m1, m2, cs),
          lambda: x @ m_cat,
          nbytes=3 * n * k * 4 + (2 * k * k + k) * 4,
          flops=n * k * (4 * k + 1), reps=50,
          replaces="src/repro/kernels/eg_update/kernel.py:64",
          source="src/repro_torch/csrc/eg_update.cu", graphs=True)
    del x, av, v, rows

    # K3 and K4 at a ragged shape: n a multiple of no tile, odd k, and
    # panels that start 4 bytes past a 16-byte boundary (row slices)
    nr, kr = 1_000_003, 7
    vr, avr = panel(nr + 1, kr, 6)[1:], panel(nr + 1, kr, 7)[1:]
    m1r, m2r, csr = eg_ref.coefficient_matrices(eg_ref.gram2k(vr, avr), kr,
                                                0.4)
    for name, kernel_fn, plain_fn in (
            ("gram2k", lambda: eg_ops.gram2k(vr, avr),
             lambda: eg_ref.gram2k(vr, avr)),
            ("panel_mix", lambda: eg_ops.panel_mix(vr, avr, m1r, m2r, csr),
             lambda: eg_ref.panel_mix(vr, avr, m1r, m2r, csr))):
        err_r, tol_r = compare(f"{name} (ragged)", kernel_fn, plain_fn)
        kernels[name]["ragged"] = {
            "n": nr, "k": kr, "data_ptr_mod_16": vr.data_ptr() % 16,
            "max_abs_err": err_r, "tolerance": tol_r,
            "bitwise_repeatable": bool(torch.equal(kernel_fn(), kernel_fn()))}
        emit({"phase": "ragged", "name": name, **kernels[name]["ragged"]})
        if not kernels[name]["ragged"]["bitwise_repeatable"]:
            raise AssertionError(f"{name} (ragged): two calls differ")
    del vr, avr

    # K5, K6 at n = 16384, k = 10 on a dense L of 1 GiB (20x the L2)
    nd = 16384
    gd, _ = graphs.sparse_sbm_graph(nd, 8, avg_degree_in=16, avg_degree_out=1,
                                    seed=0, device=dev)
    ld = lap.laplacian_dense(gd)
    rho_d = float(lap.spectral_radius_upper_bound(gd))
    cd = 8.0 / rho_d / 251
    vd = panel(nd, k, 4)
    check("poly_step",
          lambda: lp_ops.poly_step(ld, vd, cd),
          lambda: lp_ref.poly_step(ld, vd, cd),
          lambda: torch.addmm(vd, ld, vd, alpha=-cd),
          nbytes=nd * nd * 4 + 3 * nd * k * 4, flops=2 * nd * nd * k + 2 * nd * k,
          reps=50, replaces="src/repro/kernels/laplacian_poly/kernel.py:44",
          source="src/repro_torch/csrc/laplacian_poly.cu",
          matvec_pair=(lambda: lp_ops.dense_matvec_panel(ld, vd),
                       lambda: lp_ref.dense_matvec_panel(ld, vd)))
    check("dense_matvec_panel",
          lambda: lp_ops.dense_matvec_panel(ld, vd),
          lambda: lp_ref.dense_matvec_panel(ld, vd),
          lambda: ld @ vd,
          nbytes=nd * nd * 4 + 2 * nd * k * 4, flops=2 * nd * nd * k,
          reps=50, replaces="src/repro/kernels/laplacian_poly/kernel.py:80",
          source="src/repro_torch/csrc/laplacian_poly.cu")
    del ld  # rebuilt in phase 5; phase 4's peak memory leaves it out

    # ---- 3. small end-to-end (K1 path) -----------------------------------
    gs, truth_s = graphs.clique_graph(160, 4, seed=3, device=dev)
    cfg_s = ClusteringConfig(
        num_clusters=4, transform="limit_neg_exp", degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=600, eval_every=100),
        seed=0)
    reset_launch_counts()
    (labels_s, info_s), small_s = host_s(lambda: spectral_cluster(gs, cfg_s))
    counts_small = launch_counts()
    agreement = float(km.cluster_agreement(labels_s, truth_s, 4))
    # one operator call (251 K1 steps) replayed as a graph vs run eagerly
    s_small = limit_neg_exp(251, scale=8.0 / float(
        lap.spectral_radius_upper_bound(gs)))
    op_s = operators.edge_series_operator(gs, s_small, backend="kernel")
    fused_s = backend.fused_step_fn(gs, "kernel")
    vs = info_s["eigvecs"]
    emit({"phase": "small", "n": 160, "seconds": small_s,
          "agreement": agreement, "launches": counts_small,
          "us_per_fused_step": small_s / counts_small["edge_spmm"] * 1e6,
          "operator_ms": cuda_ms(lambda: op_s(vs), 20),
          "eager_operator_ms": cuda_ms(
              lambda: s_small.apply_reversed_fused(fused_s, vs), 20)})
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
    fused_full = backend.fused_step_fn(g, "kernel")
    eager_op_ms = cuda_ms(lambda: s.apply_reversed_fused(fused_full, st.v), 3)
    # a fresh operator's first call: the eager side-stream run + capture
    op_fresh = operators.edge_series_operator(g, s, backend="kernel")
    _, op_first_s = host_s(lambda: op_fresh(st.v))
    del op_fresh
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
          "row_csr_build_ms": rows_ms,
          "chunk_layout_host_s": blocking_s, "real_chunks": real_chunks,
          "num_chunks": num_chunks,
          "spectral_cluster_s": full_s,
          "fused_series_step_ms": op_ms / 251, "operator_ms": op_ms,
          "eager_operator_ms": eager_op_ms,
          "operator_first_call_s": op_first_s,
          "solver_step_ms": step_ms, "kmeans_ms": kmeans_ms,
          "max_memory_allocated": peak_bytes, "agreement": agreement_full,
          "launches": counts_full,
          "n8192_three_step_max_abs_err": steps_err,
          "n8192_tolerance": STEPS_TOL})
    if not steps_err <= STEPS_TOL:
        raise AssertionError(f"3 kernel-path steps differ from segment by "
                             f"{steps_err} > {STEPS_TOL}")

    # ---- 5. dense limit series (K5 path, K6 baseline) ---------------------
    ld = lap.laplacian_dense(gd)
    s_d = limit_neg_exp(251, scale=8.0 / rho_d)

    def unfused():
        u = vd
        for _ in range(251):
            u = u - cd * lp_ops.dense_matvec_panel(ld, u)
        return -u

    reset_launch_counts()
    (fused_out, unfused_out), dense_s = host_s(lambda: (
        lp_ops.limit_series_apply(ld, vd, degree=251, scale=8.0 / rho_d),
        unfused()))
    counts_dense = launch_counts()
    want_d = s_d.apply(operators.dense_matvec(ld), vd)
    dense_tol = DENSE_TOL * float(want_d.abs().max())
    dense_err = float((fused_out - want_d).abs().max())
    unfused_err = float((unfused_out - want_d).abs().max())
    fused_ms = cuda_ms(lambda: lp_ops.limit_series_apply(
        ld, vd, degree=251, scale=8.0 / rho_d), 3)
    unfused_ms = cuda_ms(unfused, 3)
    plain_series_ms = cuda_ms(
        lambda: s_d.apply(operators.dense_matvec(ld), vd), 3)
    emit({"phase": "dense", "n": nd, "k": k, "degree": 251,
          "seconds": dense_s, "max_abs_err": dense_err,
          "unfused_max_abs_err": unfused_err, "tolerance": dense_tol,
          "fused_series_ms": fused_ms, "unfused_series_ms": unfused_ms,
          "plain_series_ms": plain_series_ms, "launches": counts_dense})
    if not (dense_err <= dense_tol and unfused_err <= dense_tol):
        raise AssertionError(f"dense series off the plain one by "
                             f"{dense_err} / {unfused_err} > {dense_tol}")
    for name in ("poly_step", "dense_matvec_panel"):
        if counts_dense[name] != 251:
            raise AssertionError(f"dense run launched {name} "
                                 f"{counts_dense[name]} times, not 251")
    del ld, fused_out, unfused_out, want_d

    # ---- 6. auto-tuned path, small (K1 probe + K1 solve) -----------------
    lam_s = torch.linalg.eigvalsh(lap.laplacian_dense(gs).double())
    probe_a, plan_a = spectral.probe_and_plan(
        gs, k=6, generator=torch.Generator(device=dev).manual_seed(3),
        budget=251)
    cfg_as = ClusteringConfig(
        num_clusters=4, transform="auto", degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=600, eval_every=100),
        seed=0)
    reset_launch_counts()
    (labels_as, info_as), auto_small_s = host_s(
        lambda: spectral_cluster(gs, cfg_as))
    counts_auto_small = launch_counts()
    agreement_as = float(km.cluster_agreement(labels_as, truth_s, 4))
    lam_ratio = float(probe_a.lambda_max) / float(lam_s[-1])
    plan_as = info_as["plan"]
    emit({"phase": "auto_small", "n": 160, "seconds": auto_small_s,
          "agreement": agreement_as, "probe_lambda_max":
          float(probe_a.lambda_max), "eigh_lambda_max": float(lam_s[-1]),
          "plan": {"family": plan_as.family, "degree": plan_as.degree,
                   "tau": plan_as.tau, "rho": plan_as.rho},
          "launches": counts_auto_small})
    if not agreement_as > 0.95:
        raise AssertionError(f"auto clique agreement {agreement_as} <= 0.95")
    if not 0.9 <= lam_ratio <= 1.1:
        raise AssertionError(f"probe lambda_max / eigh = {lam_ratio}")
    if (plan_as.family, plan_as.degree, plan_as.tau) != (
            plan_a.family, plan_a.degree, plan_a.tau):
        raise AssertionError(f"auto plan {plan_as} != probe_and_plan's {plan_a}")
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_auto_small[name] <= 0:
            raise AssertionError(f"auto small run launched no {name}")

    # ---- 7. auto-tuned path at full size (K1 probe, K2-K4 solve) ---------
    reset_launch_counts()
    (probe_f, _), probe_s = host_s(lambda: spectral.probe_and_plan(
        g, k=k, generator=torch.Generator(device=dev).manual_seed(3),
        budget=251))
    probe_launches = launch_counts()["edge_spmm"]
    probe_rows_ms = cuda_ms(lambda: es_ops.build_edge_rows(
        g.src, g.dst, g.weight, n), 3)
    _, plan_host_s = host_s(lambda: spectral.plan_dilation(
        probe_f, k=k, budget=251, rho_fallback=rho))
    cfg_af = ClusteringConfig(num_clusters=8, transform="auto", degree=251,
                              solver=SolverConfig(steps=10, eval_every=10),
                              seed=0)
    reset_launch_counts()
    (labels_af, info_af), auto_full_s = host_s(
        lambda: spectral_cluster(g, cfg_af))
    counts_auto_full = launch_counts()
    plan_af = info_af["plan"]
    for name in ("edge_spmm", "edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_auto_full[name] <= 0:
            raise AssertionError(f"auto full-size run launched no {name}")
    if not (labels_af.shape == (n,) and int(labels_af.min()) >= 0
            and int(labels_af.max()) < 8
            and bool(torch.isfinite(info_af["eigvecs"]).all())):
        raise AssertionError("auto full-size run gave malformed output")
    # the probe at the main path's shape: K1 held to its twin on the
    # (2^20, 4) probe panel (the draw slq_probe makes from seed 3), and the
    # whole SLQ from that panel on K1 and on segment
    pv = torch.randn((n, 4), generator=torch.Generator(device=dev).manual_seed(3),
                     dtype=torch.float32, device=dev)
    probe_err, probe_tol = compare(
        "edge_spmm (probe panel)",
        lambda: es_ops.edge_spmm(g.src, g.dst, g.weight, pv),
        lambda: es_ref.edge_spmm(g.src, g.dst, g.weight, pv))
    kernels["edge_spmm"].update(probe_panel_max_abs_err=probe_err,
                                probe_panel_tolerance=probe_tol)
    slq = {b: spectral.slq_probe(
        backend.edge_arrays_matvec_fn(g.src, g.dst, g.weight, b), n,
        n_real=n, v0=pv) for b in ("kernel", "segment")}
    slq_err = {key: abs(float(getattr(slq["kernel"], key))
                        - float(getattr(slq["segment"], key)))
               / float(getattr(slq["segment"], key))
               for key in ("lambda_max", "trace")}
    if not all(e <= SLQ_TOL for e in slq_err.values()):
        raise AssertionError(f"K1 probe vs segment probe: relative errors "
                             f"{slq_err} > {SLQ_TOL}")
    rho_ub_f = info_af["rho_ub"]
    d_max = float(lap.degrees(g).max())
    if not plan_af.rho <= 1.01 * rho_ub_f:
        raise AssertionError(f"plan rho {plan_af.rho} > 1.01 x {rho_ub_f}")
    if not float(probe_f.lambda_max) >= (1 - LMAX_SLACK) * d_max:
        raise AssertionError(f"probe lambda_max {float(probe_f.lambda_max)} "
                             f"below the largest degree {d_max}")
    op_af = operators.edge_series_operator(
        g, spectral.series_from_plan(plan_af), backend="kernel")
    st_af = solvers.init_from_panel(info_af["eigvecs"])
    lr_af = plan_af.suggested_lr(cfg_af.solver.lr)
    op_af_ms = cuda_ms(lambda: op_af(st_af.v), 3)
    step_af_ms = cuda_ms(lambda: step_fn(st_af, op_af(st_af.v), lr_af), 3)
    kmeans_af_ms = cuda_ms(lambda: km.kmeans(
        torch.Generator(device=dev).manual_seed(1), info_af["embedding"], 8), 1)
    emit({"phase": "auto_full", "n": n, "k": k, "budget": 251,
          "probe_s": probe_s, "probe_k1_launches": probe_launches,
          "probe_row_csr_build_ms": probe_rows_ms,
          "plan_host_s": plan_host_s,
          "probe_lambda_max": float(probe_f.lambda_max), "max_degree": d_max,
          "probe_panel_k1_max_abs_err": probe_err,
          "probe_panel_k1_tolerance": probe_tol,
          "slq_k1_vs_segment_rel_err": slq_err, "slq_tolerance": SLQ_TOL,
          "plan": {"family": plan_af.family, "degree": plan_af.degree,
                   "tau": plan_af.tau, "rho": plan_af.rho,
                   "gamma": plan_af.gamma, "lam_k": plan_af.lam_k,
                   "lam_k1": plan_af.lam_k1},
          "rho_ub": rho_ub_f, "spectral_cluster_s": auto_full_s,
          "operator_ms": op_af_ms, "solver_step_ms": step_af_ms,
          "kmeans_ms": kmeans_af_ms,
          "agreement": float(km.cluster_agreement(labels_af, truth, 8)),
          "launches": counts_auto_full})

    # ---- 8. kernel list --------------------------------------------------
    main_path = (counts_small, counts_full, counts_dense, counts_auto_small,
                 counts_auto_full)
    for name, row in kernels.items():
        row["launches"] = sum(c[name] for c in main_path)
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
