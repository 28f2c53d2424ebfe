"""Build the repro_torch CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It exits non-zero, printing no result, without a card or
outside a checkout.  Phases, one JSON line each:

1. build   - compile csrc/*.cu for sm_90a (all sources in parallel)
2. check   - hold each kernel (K1 edge_spmm, K2 edge_spmm_nb, K3 gram2k,
             K4 panel_mix, K5 poly_step, K6 dense_matvec_panel, and
             kmeans_dist at the benchmark's k-means, n = 2^22, m = d = 30,
             bitwise, with the seeding's one-centre running minimum)
             against its plain PyTorch twin on the card at the main path's
             shapes,
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
   check_rectangular - K2's rectangular launch (a panel shard's owned
             rows, self terms a row range of the panel) on shard 1 of 2
             of the 2^20 SBM, held to its twin and to the square launch;
             phase 23 adds both shards of the million-node graph, checked
             in their ranks
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
8. minibatch_small - spectral_cluster(estimation="minibatch") on a
             120-node clique graph (degree 51, 512 edges a factor, 1500
             mu-EG steps): one K1 launch per drawn factor, agreement
9. minibatch_full - the same estimator on phase 4's 2^20-node graph
             (degree 251, 65,536 edges a factor, 10 solver steps): the
             per-factor split in CUDA events (draw and gather, the batch's
             row-CSR build, K1, the AXPY) at B = 65,536 and B = 1,024, the
             solver step, K1 on one drawn batch against its twin
10. walks_small - spectral_cluster(estimation="walks") on phase 3's
             clique graph (degree min(251, 6), 4096 walkers, 600 steps):
             the host incidence build, the solver step, agreement
11. baselines - the Bethe Hessian clustering of a 180-node SBM (dense
             eigh, agreement), lanczos_bottom_k on phase 4's 2^20-node graph
             over K2 (64 steps: seconds, host share, largest residual) and
             one shift_invert_operator application there (50 CG steps on K2)
12. stream_small - bench_stream.py's configuration (10,000-node sparse SBM,
             k = 8, degree 15, strength 8) through the streaming state: the
             cold solve to tolerance on the store's dilated operator (K2,
             K3/K4), a 1 % churn applied as batches of 256, the row-CSR
             rebuild and the warm re-solve: iterations, ratio, residual
13. stream_full - phase 4's graph in its capacity class (2^24 slots), k = 10,
             degree 15: apply_edge_batch at B = 256 and 4,096 (time, peak
             memory of one apply), refresh_degrees, the row-CSR rebuild, the
             dilated operator at two c, first_order_update at B = 256, a cold
             solve and a warm re-solve after a 1 % churn (200 steps each),
             LabelTracker on the 2^20 labels of two k-means runs
14. service_small - bench_stream.py's mixed fleet through the
             StreamingService (4 fast and 4 slow sbm_graph(200, 4) tenants,
             its FLEET_CFG, edge capacity 8192): round_robin and
             residual_decay to convergence, each group tick one program
             replayed from CUDA graphs (K1 on the 8 x 256-row layout,
             K3/K4 per member); ticks, invocations, device work, captures,
             layout fills, wall, agreement; then a kernel tick held to the
             segment tick (the plain twins) on the same inputs
15. service_full - 4 tenants at full width: phase 4's graph under a
             seeded node permutation each, weights x (1 + i/2), capacity
             class 2^24, k = 10, the default degree budget and
             steps_per_tick, round_robin ticks: admission (probe and plan)
             per tenant, 3 ticks at occupancy 4 (K2 on the 4 x 2^20-row
             layout) with an apply_updates of B = 4,096 to tenant 2 between
             ticks 2 and 3; one group factor, a tenant's own factor and the
             member steps timed apart;
             ms per tick, launches per tick, the capture count before and
             after the update, the layout fill, peak memory; every tenant's
             replayed tick held to its own dilated operator and run_chunk,
             K2 on the group layout held to its plain twin; then the split
             a residual-decay tick makes: two sub-batches of occupancy 2
             through one program in turn, each call a layout refill and a
             replay (ms, fills, bitwise repeats)
16. serve_small - benchmarks/bench_serve.py's load through the port's
             Server (re-created here): 6 sbm_graph(120, 4) tenants run to
             convergence, then 96 pushes of 8 intra-block edges per tenant
             (a thread each) beside 2 query threads x 40, both pipelines
             (serialized, double_buffer) to re-convergence with every
             batch applied: walls and their ratio, p50/p99 per request
             type, counters, programs and captures
17. serve_http - bench_serve.http_smoke against python -m repro_torch.serve
             on the card as a subprocess: a 60-node SBM admitted and
             converged, 110 rounds of push, labels and summary, /metrics
             (the child's kernel launches), worst non-admit p99 <= 3 s,
             SIGTERM -> exit 0 and STOPPED; the child killed in a finally
18. serve_full - a started Server over phase 15's 4 tenants (capacity 2^24,
             k = 10, 8 clusters, round_robin): 4 pusher threads stage 8
             batches of B = 4,096 "add" pairs per tenant, one per tick,
             2 query threads read summary and labels from before the first
             tick (capture included), flush, 2 more ticks, stop(): versions
             monotone, labels of one version one byte string, every
             tenant's live edges equal to a numpy reference, one capture
             per program, the engine thread alive until stop(); ms per
             tick, push/labels p50/p99, the flush wall, tick_utilization,
             counters, the labels path split (k-means, copy, tracker),
             the staging merge at B = 4,096, peak memory
19. sharded_small - phase 3's clique solve on 2 ranks of this card
             (torch.distributed over gloo; NCCL refuses two ranks on one
             GPU) through core.distributed.distributed_solve, K1 on each
             rank's shard and one all_reduce per factor, cut to 40 steps:
             agreement equal to phase 3's, panels bitwise equal across ranks
20. sharded_full - phase 7's planned operator (limit_neg_exp, degree 41) on
             phase 4's 2^20-node graph over 4 ranks: one call held to the
             one-process CapturedOperator on the same panel, the per-factor
             split (the shard's K2 in CUDA events, the all_reduce of the
             (2^20, 10) panel by the host clock, the AXPY), 3 steps of
             distributed_solve held to run_solver, each rank's peak memory;
             then the same operator in a one-rank NCCL world
21. sharded_service - phase 14's fleet, round_robin, through a
             StreamingService(mesh=...) on 2 ranks to convergence
             (sharded probes and ticks): invocations and agreement equal to
             phase 14's; then one degree-11 tick of phase 15's tenant 0
             (2^20 nodes, capacity 2^24) on 2 ranks held to its one-process
             tick
22. model_sharded_small - benchmarks/bench_distributed.py's model tick
             shape (sparse_sbm_graph(9216, 4, 3.0, 0.5, seed=0), k = 6,
             degree 7, 5 steps, c = 0.01, lr 0.3) panel-sharded on 2 ranks
             of this card, mu-EG and Oja: each rank's K2 on its owned rows
             per factor, per mu-EG step one fused rows + gram all_reduce;
             held to one process's kernel tick from the same panel; the
             run-time plain and fused all_reduce counts; the per-factor
             split (the owned rows' K2 in CUDA events, the all_reduce by
             the host clock)
23. model_sharded_full - phase 21's 2^20 tenant tick panel-sharded on 2
             ranks, held to the same one-process tick, beside phase 21's
             edge-sharded seconds; then the README's million-node row:
             power_law_graph(10^6, 100, 2.5, seed=0, dedup=False) (E ~ 5e7,
             each rank generating it from its seed) at capacity 2^26 in a
             panel-sharded StreamingService on 2 ranks (k = 10, phase 15's
             degree budget): admission with the probe, the plan, one tick
             (rank 0 holds it to the same tick in one process, from the
             same panel and plan), peak memory per rank, the split on each
             rank's owned rows, and K2's rectangular launch there held to
             its twin in each rank
24. mdp     - paper Figs. 1-3 (bench_mdp.py): three_room_mdp(s=1, h=10)
             (n = 341, E = 622), k = 6, 1500 steps, the transform suite at
             degree 151 over the dense L (each series one CUDA graph) for
             mu-EG and Oja from one seed-0 panel: steps to a full streak
             and to 1 % subspace error, ms per step, wall to 1 %; the limit
             series again on K1 from the same panel; the proto-value
             functions of three_room_mdp(s=2) through spectral_cluster
             (agreement with the rooms, examples/mdp_protovalues.py's sign
             correlation)
25. mdp_full - three_room_mdp(s=59) (n = 1,046,661, E = 2,089,898, rows of
             at most 4 entries, no hub rows): K2 on its row CSR held to
             its twins and timed (ms, graph_ms) against its bound, then
             spectral_cluster(num_clusters=3, transform="auto"), 10 steps:
             host generation s, probe s, the plan, ms per step, peak memory
26. cliques - Fig. 4 (bench_cliques.py): clique_graph(300, 3) and (400, 4),
             the suite at degree 251, mu-EG, 1200 steps
27. series_degree - Fig. 6 (bench_series_degree.py): limit and Taylor
             series at degrees 11/51/151/251 and two beyond-paper series
             on clique_graph(300, 3), k = 3, 900 steps
28. transforms - Table 2 (bench_transforms.py): convergence ratio and
             dilation per transform on the synthetic spectrum, the apply
             at n = 512, k = 8, and both degree-251 limit rows through K5
             held to the series apply
29. linkpred - Fig. 5 (bench_linkpred.py): the link-predicted completion of
             clique_graph(300, 3, seed=1), the suite, 1000 steps
30. walks_paper - Sec. 4.3 (bench_walks.py): 20,000 walks of length 3 on
             clique_graph(200, 4): walks/s, the L^2 estimate's relative
             error (importance vs rejection), mean acceptance
31. lm_serve - the LM substrate's serving path (no kernel of the port
             runs on it): qwen3-4b at full width and depth (36 layers,
             4.06 B parameters stored f32, drawn on the card from a seeded
             generator) through repro_torch.launch.serve.generate: run 1
             TokenPipeline prompts 4 x 512, 32 greedy steps, bf16 cache;
             run 2 1 x 4096 (chunked attention), 8 steps; run 3 the
             int8-cache variant of run 1, 8 steps, its token agreement;
             one train_loss forward on 2 x 1024 beside ln(vocab); prefill
             ms and decode ms per step in CUDA events, tok/s, peak bytes,
             the bounds (decode: the f32 weights read once; prefill:
             2 x non-embedding params x tokens at the bf16 peak).  Holds:
             (a) finite logits and loss; (b) the first 8 decode steps'
             logits against a prefill of prompt + generated tokens at
             rtol = atol = 6e-2 (the gap printed at depths 4, 12, 36,
             asserted at LM_HOLD_DEPTH); (c) smoke_config(qwen3-4b) on the
             card against the CPU from one set of weights, f32 and bf16
32. lm_moe  - the LM substrate's MoE serving path (no kernel of the port
             runs on it): granite-moe-1b-a400m at full width and depth (24
             layers, 32 experts top-8, 1.385 B f32 parameters) and
             deepseek-v2-236b at full width (MLA, 160 routed experts top-6
             + 2 shared) cut to 2 of its 60 layers (9.15 B), both drawn on
             the card from a seeded generator, through
             launch.serve.generate: granite run 1 4 x 512, 32 steps, run 2
             1 x 4096 (chunked attention), 8 steps, a 2 x 1024 train_loss
             forward with its aux term; deepseek 4 x 512, 16 steps, a
             2 x 512 loss; prefill and decode ms in CUDA events, tok/s,
             peak bytes, the dropped pairs per layer of a prefill, the
             profiler's busy time and kernels of a prefill and a decode
             step, the decode bounds (all f32 weights read once; the
             active parameters) and the prefill bound.  Holds: (a) finite
             logits, loss and aux; (b) decode against a prefill of prompt
             + generated tokens at rtol = atol = 6e-2 at a capacity that
             cannot bind, routing flips and routing-clean rows counted,
             printed at several depths (and at the config's own capacity,
             and in f32), asserted for granite at LM_MOE_HOLD_DEPTH; (c)
             both smoke configs on the card against the CPU, f32 and bf16,
             routing agreement beside the errors; (d) one full-width MLA
             layer's absorbed decode over 16 positions against its train
             attention in f32 (rtol 1e-2, atol 5e-3); (e) a second bf16
             prefill of run 1 equal to the first bitwise
33. lm_ssm  - the LM substrate's SSM, hybrid and enc-dec serving paths
             (no kernel of the port runs on them), each at full width and
             depth, drawn on the card from a seeded generator, f32, through
             launch.serve.generate: mamba2-2.7b (64 Mamba2 layers, 2.83 B
             parameters) run 1 4 x 512, 32 steps, run 2 1 x 32,768 (128
             SSD chunks), 8 steps, a 2 x 1024 loss; zamba2-1.2b (32 Mamba2
             layers, one weight-shared attention block after each of 6
             groups) run 1 4 x 512, 32 steps, run 2 1 x 4096, 8 steps, a
             2 x 1024 loss; whisper-small (12 + 12 layers) 4 requests of
             1,500 stub frames, a 4-token prompt, 64 steps, a 2 x 448
             loss; prefill and decode ms in CUDA events, tok/s, peak bytes,
             the state's bytes per sequence, the profiler's busy time,
             kernels and top kernels of a prefill and a decode step, the
             bounds (decode: the f32 weights read once; prefill: 2 x the
             parameters each position multiplies at the bf16 peak, the
             shared block at each use, whisper's frames through the
             encoder).  Holds: (a) finite logits and loss; (b) decode
             against a prefill of prompt + generated tokens at rtol = atol
             = 6e-2, printed at several depths and in f32, asserted at
             each *_HOLD_DEPTH; (c) the three smoke configs on the card
             against the CPU, f32 and bf16; (d) one full-width mamba2
             layer's chunked scan over 600 positions against the
             sequential oracle, and chunk 64 against 256, at 2e-2; (e) a
             repeated prefill bitwise; (f) mamba2's state bytes per
             sequence after 32,776 positions equal those after 544
34. train_sped - `python -m repro_torch.launch.train --mode sped` at its
             defaults through train.train_sped (clique_graph(200, 4),
             limit_neg_exp degree 51, 1,024 edges a factor, K1 once per
             drawn factor, 600 mu-EG steps, a checkpoint every 200), then
             resumed from step 400: steps/s, ms and K1 launches a step,
             subspace error (below 0.5), agreement, the resumed panel
             bitwise the uninterrupted one, one save and restore of the
             (v,) tree (seconds, bytes, bitwise); then K1 at this path's
             shapes (n = 200, k = 5) against its plain twin on each of
             one step's 51 drawn factors, and the kernel operator against
             the segment operator on that draw
35. lm_train - LM training: granite-moe-1b-a400m at full width and depth
             through train.train_lm, 10 steps of 8 x 1024 tokens (remat
             "full", f32 AdamW moments): ms a step against the FLOP +
             optimizer-bytes bound, tokens/s, peak bytes, losses, grad
             norms (the checkpoint round trip and resume: phase 38, at
             6 layers); the profiler's device-busy share
             of one more step; qwen3-4b at full width and depth, remat
             "full", bf16 moments, 4 steps of 4 x 1024 through
             dryrun.build_train_step: ms a step, peak bytes (both models'
             ms a step the median of the steps after the first)
36. lm_mesh - the LM mesh path: granite-moe-1b-a400m at full width and
             depth on a (2, 2) ("data", "model") mesh of 4 gloo ranks on
             this card (models.sharding.set_mesh, model.shard_model: 16
             experts, 2 rows and half of every cache's positions a rank),
             4 x 512 prompts and 32 decode steps, caches of 544 positions
             (positions 0-271 on model rank 0, 272-543 on model rank 1):
             context-parallel decode (three all_reduces a layer), the
             expert-sharded MoE (one all_reduce of the partial combine,
             one of aux's mean), the logits gathered over "data".  Held in
             f32 compute to the one-process port on each 2-row half
             (1e-4 of the largest |logit|, every call; aux 1e-5); bf16
             printed at 1, 2 and 24 layers (24: the prefill and 4 steps)
             with its routing flips, held at 1 layer (rtol = atol = 6e-2).  Per rank: memory_allocated
             of the sharded parameters and of the caches beside one
             process's, ms a prefill and a decode step (CUDA events and
             host clock), all_reduce calls and host ms a step
37. dryrun_report - launch.dryrun.run_cell over all ten archs x four
             shapes x both production meshes (80 cells, skipped cells
             included): GB a rank (params, optimizer, caches, batch) and
             fits; then the reckoning (dryrun.reckon) on a one-rank local
             mesh held to the card's allocation of the same parameters,
             OptState, batch and caches: granite train 8 x 1024 (f32
             moments) and decode 4 x 544, the bytes requested within 512
             bytes a tensor, memory_allocated's growth beside them
38. lm_train_dp - the data-parallel train step with ZeRO-1 moments:
             granite-moe-1b-a400m at full width cut to 6 of 24 layers on
             a (2, 1) ("data", "model") mesh of 2 gloo ranks on this card,
             3 steps of the 8 x 1024 global batch (4 x 1024 a rank, remat
             "full", f32 moments) through dryrun.build_train_step under
             the mesh; held to one process on the card computing each
             half-batch's gradient, averaging the two and applying
             (losses 1e-4, parameters and each rank's moment slices 1e-5
             of each leaf's largest magnitude, the reference run in each
             rank), the ranks' parameters bitwise equal, each
             rank's moment bytes (requested) equal to dryrun.reckon's
             optimizer_bytes of the mesh; then at full depth each rank
             builds the model and its ZeRO-1 state only (no step), the
             moment bytes held to the reckoning under the FSDP specs.
             The checkpoint round trip through launch.train.train_lm in
             the same world at 6 layers: a train_lm of 2 steps with
             --ckpt-dir (moments gathered, rank 0 writes the JAX
             package's layout, 5.06 GB), then a train_lm resuming from
             it to step 3 (the step resumed from, its loss within 1e-4,
             its parameters and moment slices within 1e-5 of each
             leaf's largest magnitude of the run above, the step equal).
             Per rank: ms a step, gloo calls and their host seconds a
             step, peak bytes, losses
39. dryrun_sped - launch.dryrun_sped: the 8 cells' report (run-time
             all_reduce counts, reckoned bytes); the four variants on 2
             gloo ranks at n = 2^14, E = 2^18, k = 32, each held to one
             process's step of the same variant (f32 1e-5, bf16 2e-3 of
             the panel's largest magnitude), its all_reduces a step and
             payload bytes; one cheb64_fused step on one process at the
             production shape (n = 2^22, E = 2^26, k = 32): ms, peak
             bytes, and the bytes the panel and edges request on the card
             held to dryrun_sped.argument_bytes(1), the report's
             reckoning for one device
40. lm_train_tp - tensor parallelism and parameter FSDP of the LM train
             step: qwen3-4b and granite-moe-1b-a400m at full width cut to
             2 layers, each rank drawing its slices of the (2, 2)
             ("data", "model") training layout with fsdp=True on 4 gloo
             ranks of the card, 2 steps of a 4 x 512 batch (remat full,
             f32 compute and moments, Adam's eps 1e-3), held to one
             process's halves run
             in rank 0 once the sharded state is freed (losses 1e-4,
             parameters 1e-5 of each leaf's largest magnitude), the
             slices two data ranks both hold bitwise equal; per rank ms
             a step by CUDA events and the host clock, gloo calls and
             their host seconds, GB; then qwen3-4b at full depth built
             with fsdp=None, its requested parameter and moment bytes
             held to dryrun.reckon's.  lm_train_dp's full-depth granite
             build is sharded too (FSDP over 2 data ranks)
41. lm_serve_tp - tensor-parallel serving, run in lm_mesh's 4-rank world
             once lm_mesh's runs are done: each rank draws its slices of
             the (2, 2) serving layout (param_specs(fsdp=False)); granite
             at full width, lm_mesh's 4 x 512 prompt and 32 steps fed its
             f32 tokens, with f32 weights (24 and 4
             layers) and bf16 weights (1 layer; the 24-layer bf16 build's
             requested parameter and GQA cache bytes held to
             dryrun.reckon's decode cell exactly), each
             held to one process's halves on the rows no MoE routing
             flip reaches (f32: prefill 1e-4, steps 5e-3 of the largest
             |logit|, aux 1e-5 and 1e-3; bf16 6e-2); qwen3-4b at full width
             cut to 2 layers with f32 and bf16 weights held to one
             process's run; mamba2-2.7b at full width (d_model 2560, 80
             heads of 64, state 128) cut to 2 layers, its Mamba2 mixers
             on the rank's 40 heads ([z | x] exchanged into
             head-aligned blocks, the norm's statistic summed over
             "model"), 4 x 512 then 8 steps with f32 and bf16 weights
             held to one process's run (f32: prefill 1e-4, steps 5e-3;
             bf16 6e-2), the bytes a rank requests for its parameters
             and its SSM caches held to dryrun.reckon's decode cell
             exactly; deepseek-v2-236b at full width cut to 1 of 60
             layers, built by one rank at a time, its MLA latent caches
             split over the sequence (260 of 520 positions a rank), the
             absorbed decode's softmax combined over "model", 4 x 512
             then 8 steps with f32 and bf16 weights held to one
             process's halves on the clean rows, its bf16 parameter and
             MLA cache bytes held to dryrun.reckon's exactly, the ranks'
             memory after each build; every run's routing flips and the router's
             margins at them, ms a prefill and a decode step by CUDA
             events and the host clock, gloo calls by kind with their
             host ms, and their host share
42. kernels - per kernel: launches on the main path (phases 3-41 but the
             checks, counts reset just before and read just after each;
             serve_http's from the child's /metrics, counted from its
             start; the sharded phases' from their ranks), error, times
             and the bound of this run's inputs

The card's name and power limit are printed as nvidia-smi gives them, and
the last line is {"ok": true, "device": {...}}.  Numbers are fp32 with
TF32 off (the LM phases compute in bf16, their logits in fp32).
This script imports torch and the port, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, fp32 (non-tensor) and dense
# bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# K1/K2/K4 are held to 1e-5 of the plain twin's largest magnitude: K1 and
# K2 sum each row in registers in another order than the twins'
# index_add_, and K4 sums its k terms in another order than the plain
# matmuls.  K3 sums 2^20 products per entry in row slices, the plain gram
# in cuBLAS's order: 1e-5 of max|S|.
REL_TOL = 1e-5
# kernel calls captured in one CUDA graph for graph_ms
GRAPH_CALLS = 200
# agreement with the planted labels of the stochastic estimators, the bar
# of tests/test_clustering.py's minibatch test; the walks estimator meets
# it on the 160-node clique graph too (tests/test_torch_walks.py)
STOCHASTIC_AGREEMENT = 0.9
# the Bethe Hessian bars of tests/test_baselines.py
BETHE_AGREEMENT = 0.9
BETHE_NEGATIVE_EIGS = 3
# the streaming phases' solver, bench_stream.py's: WarmConfig(tol=5e-3,
# chunk=10, max_steps=5000, lr=0.3), dilation degree 15, strength 8
STREAM_TOL = 5e-3
STREAM_DEGREE = 15
STREAM_STRENGTH = 8.0
# 64 Lanczos steps over K2 vs over the segment matvec from one start
# vector: the eigenvalue bar of tests/test_baselines.py
LANCZOS_TOL = 1e-3
# bench_stream.py's mixed fleet (FLEET_* and FLEET_CFG there): its bars
# are "every tenant converged" and "max residual <= tol"
FLEET_N = 200
FLEET_FAST = 4  # sbm_graph(200, 4, p_in=0.35, p_out=0.01, seed=i)
FLEET_SLOW = 4  # sbm_graph(200, 4, p_in=0.12, p_out=0.04, seed=100 + i)
FLEET_CAPACITY = 8192
# service_full: tenants, the update between ticks 2 and 3
SERVICE_TENANTS = 4
SERVICE_TICKS = 3
SERVICE_UPDATE_B = 4096
# one apply_edge_batch at capacity 2^24 must stay far under the (B, cap)
# match of the JAX package (68.7 GB of bools at B = 4,096)
APPLY_PEAK_BYTES = 3e9
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

# bench_serve.py's load (its TENANTS, N_NODES, ROUNDS, BATCH_EDGES,
# QUERY_THREADS, QUERIES_PER_THREAD and _service_cfg), re-created here
SERVE_SMALL_TENANTS = 6
SERVE_SMALL_N = 120
SERVE_SMALL_ROUNDS = 96
SERVE_SMALL_BATCH = 8
SERVE_QUERY_THREADS = 2
SERVE_SMALL_QUERIES = 40
# bench_serve.http_smoke: the shell's flags, its 60-node SBM, 110 rounds of
# push + labels + summary, and its bar on the worst non-admit p99
SERVE_HTTP_ARGS = ("--num-clusters", "3", "--k", "4", "--degree", "7",
                   "--steps-per-tick", "10")
SERVE_HTTP_ROUNDS = 110
SERVE_HTTP_P99_S = 3.0
# serve_full: per tenant, 8 pushes of B = 4,096 new pairs in mode "add" at
# weights k/64 (k in 1..8): every sum the store and the staging buffer
# form is exact in fp32, so the live edges must equal the numpy
# reference exactly; ticks the engine runs after the flush
SERVE_FULL_PUSHES = 8
SERVE_FULL_B = 4096
SERVE_FULL_TAIL_TICKS = 2
# every wait of the serve phases
SERVE_TIMEOUT_S = 300.0
# the sharded phases: ranks on this one card (gloo), the clique solve cut
# to 40 of phase small's 600 steps, 3 solver steps at 2^20, the
# split's repetitions, the service's ranks, tenant 0's capacity class
SHARDED_RANKS = 4
# the clique solve's 10,040 factors each take an all_reduce, which costs
# ~1 ms on 2 ranks of one card and ~4.5 ms on 4: 2 ranks keep the script
# inside its time limit on a slower host (an H100 machine: 135.5 s on 4
# ranks, 32.4 s on 2)
SHARDED_SMALL_RANKS = 2
SHARDED_SMALL_STEPS = 40
SHARDED_SOLVE_STEPS = 3
SHARDED_SPLIT_REPS = 5
SHARDED_SERVICE_RANKS = 2
SHARDED_TENANT_CAPACITY = 1 << 24
SHARDED_TIMEOUT_S = 400.0
# the panel-sharded phases: 2 ranks on the card over gloo
MODEL_RANKS = 2
# benchmarks/bench_distributed.py's model_tick_warm shape
MODEL_SMALL_N, MODEL_SMALL_K = 9216, 6
MODEL_SMALL_DEGREE, MODEL_SMALL_STEPS = 7, 5
MODEL_SMALL_C, MODEL_SMALL_LR = 0.01, 0.3
MODEL_SPLIT_REPS = 5
# the README's million-node row: power_law_graph(1e6, 100, 2.5, seed=0,
# dedup=False), E ~ 5e7, at the top capacity class
MILLION_N, MILLION_AVG_DEGREE, MILLION_ALPHA = 1_000_000, 100.0, 2.5
MILLION_CAPACITY = 1 << 26
# the paper's figures: benchmarks/common.py's eval cadence; operator +
# solver step pairs timed per row; bench_mdp.py (k, steps, degree), the
# proto-value solve of examples/mdp_protovalues.py (1200 steps) on the
# s = 2 grid, the full-width grid (s = 59: n = 1,046,661, E = 2,089,898);
# bench_cliques.py, bench_series_degree.py, bench_linkpred.py steps;
# bench_transforms.py's spectrum k and apply shape; bench_walks.py's walks
FIG_EVAL_EVERY = 25
FIG_STEP_REPS = 20
MDP_K, MDP_STEPS, MDP_DEGREE = 6, 1500, 151
# the 1 % assert of phase mdp holds over draws, not one: seed 0's row is
# the figure, and at least MDP_SEEDS_REACHED of MDP_SEEDS draws must reach
# 1 % (the steps to it move with the draw and with cuBLAS's rounding)
MDP_SEEDS, MDP_SEEDS_REACHED = 8, 6
PVF_STEPS = 1200
MDP_FULL_S = 59
CLIQUE_GRAPHS = ((300, 3), (400, 4))
CLIQUE_STEPS, SERIES_STEPS, LINKPRED_STEPS = 1200, 900, 1000
TABLE2_K, TABLE2_N, TABLE2_PANEL = 4, 512, 8
WALKS_PAPER_W = 20_000

# the LM substrate's serving path (lm_serve): qwen3-4b at full width and
# depth; run 1 (batch, prompt, decode steps) with a bf16 cache, run 2 past
# the 2048-position switch to chunked attention, the int8-cache variant of
# run 1, one train_loss forward; hold (b) compares the first
# LM_HOLD_STEPS decode steps with a prefill of prompt + generated tokens
# at each of LM_GAP_DEPTHS and asserts at LM_HOLD_DEPTH, the deepest where
# the bar holds; hold (c) the card against the CPU at smoke_config
LM_ARCH, LM_SEED = "qwen3-4b", 0
LM_RUN1 = (4, 512, 32)
LM_RUN2 = (1, 4096, 8)
LM_INT8_STEPS = 8
LM_LOSS = (2, 1024)
LM_HOLD_STEPS = 8
LM_GAP_DEPTHS = (4, 12, 36)
LM_HOLD_DEPTH = 12
# tests/test_arch_smoke.py:130's prefill-vs-decode bar (rtol = atol), and
# tests/test_torch_lm_model.py's f32 bars: prefill and loss 1e-4, decode
# 5e-3 (the bf16 cache's rounding flips)
LM_BF16_TOL = 6e-2
LM_F32_TOL = 1e-4
LM_DECODE_F32_TOL = 5e-3
# hold (c) at smoke size: batch, prompt, decode steps; the loss past its
# chunk of 512
LM_SMOKE = (2, 12, 4)
LM_SMOKE_LOSS = (1, 520)

# the LM substrate's MoE serving path (lm_moe): granite-moe-1b-a400m at
# full width and depth (run 1 with a bf16 cache, run 2 past the
# 2048-position switch to chunked attention, one train_loss forward with
# its aux term), then deepseek-v2-236b at full width cut to LM_MLA_DEPTH
# of its 60 layers (one layer is 4.05 B parameters, 16.2 GB in f32).
# Hold (b) at each depth of *_GAP_DEPTHS at a capacity that cannot bind,
# asserted for granite at LM_MOE_HOLD_DEPTH, the deepest where it holds
# (at 4 layers near-tied routings flip: PERF.md section 5), printed only
# for deepseek (tests/test_arch_smoke.py marks that comparison xfail);
# hold (c) in bf16 holds the decode steps
# at the first LM_MOE_BF16_DEPTH smoke layers, as
# tests/test_torch_lm_moe_model.py does; hold (d) one full-width MLA
# layer's absorbed decode over LM_MLA_ABSORB positions against its train
# attention in f32 at tests/test_arch_smoke.py:134's bar
LM_MOE_ARCH = "granite-moe-1b-a400m"
LM_MOE_RUN1 = (4, 512, 32)
LM_MOE_RUN2 = (1, 4096, 8)
LM_MOE_LOSS = (2, 1024)
LM_MOE_GAP_DEPTHS = (1, 2, 4, 12, 24)
LM_MOE_HOLD_DEPTH = 2
LM_MOE_BF16_DEPTH = 2
LM_MLA_ARCH = "deepseek-v2-236b"
LM_MLA_DEPTH = 2
LM_MLA_RUN1 = (4, 512, 16)
LM_MLA_LOSS = (2, 512)
LM_MLA_GAP_DEPTHS = (1, 2)
LM_MLA_ABSORB = (1, 16)
LM_MLA_RTOL, LM_MLA_ATOL = 1e-2, 5e-3

# the LM substrate's SSM, hybrid and enc-dec serving paths (lm_ssm), each
# at full width and depth: mamba2-2.7b run 1 (batch, prompt, decode steps),
# run 2 at the registry's prefill_32k length (128 chunks of 256), one
# train_loss forward; zamba2-1.2b the same with run 2 past the
# 2048-position switch of the shared block to chunked attention; whisper
# 4 requests of its 1,500 stub frames with a 4-token decoder prompt, 64
# steps (its decoder context is 448), a loss over 448 positions.  Hold (b)
# at each of *_GAP_DEPTHS (zamba2's 6 is one group: 5 SSM layers and the
# shared block), asserted at *_HOLD_DEPTH, the deepest printed depth where
# it holds (bf16 rounding grows with depth as in the reference: PERF.md
# section 5, ROADMAP C); hold (c) holds zamba2's smoke
# decode steps at LM_HYBRID_BF16_DEPTH (one group of the smoke layout), as
# tests/test_torch_lm_ssm_model.py does; hold (d) one full-width mamba2
# layer's chunked scan over LM_SSD_ORACLE (3 chunks, the last ragged)
# against the sequential oracle, and chunk 64 against 256, at
# tests/test_models_unit.py's 2e-2; hold (f) the SSM state after run 2's
# context against run 1's, per sequence
LM_SSM_ARCH = "mamba2-2.7b"
LM_SSM_RUN1 = (4, 512, 32)
LM_SSM_RUN2 = (1, 32768, 8)
LM_SSM_LOSS = (2, 1024)
LM_SSM_GAP_DEPTHS = (4, 8, 16, 64)
LM_SSM_HOLD_DEPTH = 4
LM_SSD_ORACLE = (1, 600)
LM_SSD_TOL = 2e-2
LM_HYBRID_ARCH = "zamba2-1.2b"
LM_HYBRID_RUN1 = (4, 512, 32)
LM_HYBRID_RUN2 = (1, 4096, 8)
LM_HYBRID_LOSS = (2, 1024)
LM_HYBRID_GAP_DEPTHS = (3, 5, 6, 38)
LM_HYBRID_HOLD_DEPTH = 3
LM_HYBRID_BF16_DEPTH = 3
LM_ENCDEC_ARCH = "whisper-small"
LM_ENCDEC_RUN1 = (4, 4, 64)
LM_ENCDEC_LOSS = (2, 448)
LM_ENCDEC_GAP_DEPTHS = (12,)
LM_ENCDEC_HOLD_DEPTH = 12

# the training path (train_sped, lm_train).  train_sped runs
# `python -m repro_torch.launch.train --mode sped`'s defaults (200 nodes, 4
# clusters, degree 51, 600 steps, 1024 edges a factor, a checkpoint every
# 200 steps), then resumes from step SPED_RESUME_AT.  lm_train trains
# granite-moe-1b-a400m at full width and depth through train_lm for
# LM_TRAIN_STEPS steps of LM_TRAIN_SHAPE (batch, sequence), then qwen3-4b
# at full width and depth with remat "full" and bf16 moments for
# LM_TRAIN_BIG_STEPS steps of LM_TRAIN_BIG_SHAPE.  The bound of a step
# is the FLOP bound (8 x active non-embedding parameters x tokens under
# full remat, 6 without, plus 6 x d_model x vocab x tokens) at the bf16
# peak plus the optimizer's bytes (read p, g, m, v; write p, m, v: 28
# bytes a parameter with f32 moments, 20 with bf16) at the HBM rate.  The
# LM checkpoint round trip and resume run in lm_train_dp, at 6 layers
# (5.06 GB where 24 layers write 16.6 GB).
# train_sped also holds K1 at its shapes (n = 200, k = clusters + 1 = 5,
# the narrowest load width) to the plain twin on each of one step's drawn
# factors, and the kernel operator to the segment operator on that draw,
# and its subspace error below SPED_ERROR_BAR (the bar of
# tests/test_torch_train_sped.py).  Both models' ms a step is the median
# of the steps after the first.
SPED_RESUME_AT = 400
SPED_ERROR_BAR = 0.5
LM_TRAIN_ARCH = "granite-moe-1b-a400m"
LM_TRAIN_SHAPE = (8, 1024)
LM_TRAIN_STEPS = 10
LM_TRAIN_BIG_ARCH = "qwen3-4b"
LM_TRAIN_BIG_SHAPE = (4, 1024)
LM_TRAIN_BIG_STEPS = 4

# the LM mesh (lm_mesh): granite-moe-1b-a400m at full width and depth on
# LM_MESH_SHAPE ("data", "model") = 4 gloo ranks sharing the card (each
# holds 16 of the 32 experts, 2 of the 4 rows and half of every KV cache's
# positions), fed lm_moe's traffic: LM_MESH_RUN (batch, prompt, decode
# steps), caches of prompt + steps positions.  In f32 compute each rank's
# logits (the prefill's and every step's) are held to the one-process
# port's on each data half (the dispatch groups of the mesh) at
# LM_MESH_TOL of their largest magnitude, and each layer's aux (the mean
# over the halves) at LM_MESH_AUX_TOL; bf16 compute is printed beside it
# with the routing flips, and held at LM_BF16_TOL (rtol = atol) at the
# depth where it holds.  dryrun_report: the cell report of every arch x
# shape x production mesh (80 cells), then the meta reckoning held to the
# card's own allocation on a one-rank local mesh at two cells that fit
# one card: granite train at lm_train's LM_TRAIN_SHAPE with f32 moments,
# and decode at LM_MESH_RUN's batch and context: the bytes the tensors
# request from the caching allocator within DRYRUN_ALLOC_SLACK bytes a
# tensor (the int32 step and the caches' lengths, which the port keeps as
# Python ints), memory_allocated's growth printed beside them (the
# allocator hands out whole blocks: rounded to 512 bytes, and a large
# block's remainder under 1 MB is not split off)
LM_MESH_ARCH = "granite-moe-1b-a400m"
LM_MESH_SHAPE = (2, 2)
LM_MESH_RUN = (4, 512, 32)
LM_MESH_TOL = 1e-4
LM_MESH_AUX_TOL = 1e-5
# (name, compute dtype, depth, decode steps): bf16 is printed at each
# depth with its routing flips (at full depth for the prefill and
# LM_MESH_BF16_STEPS steps: its routings have parted there) and held to
# LM_BF16_TOL (rtol = atol) at LM_MESH_BF16_DEPTH, the deepest where it
# holds: at 2 layers the two computation orders' bf16 rounding flips 44
# of the prefill's 4,096 routings (bar use 13.1; 0.45 at 1 layer;
# PERF.md section 5)
LM_MESH_BF16_DEPTH = 1
LM_MESH_BF16_STEPS = 4
LM_MESH_RUNS = (("f32", "float32", None, LM_MESH_RUN[2]),
                ("bf16", "bfloat16", None, LM_MESH_BF16_STEPS),
                ("bf16_depth1", "bfloat16", 1, LM_MESH_RUN[2]),
                ("bf16_depth2", "bfloat16", 2, LM_MESH_RUN[2]))
LM_MESH_TIMEOUT_S = 600.0
DRYRUN_ALLOC_SLACK = 512
# lm_serve_tp: the serving layout (each rank holds its slice of every
# weight under param_specs(fsdp=False): model.Model(train_mesh=,
# fsdp=False, dtype=)), run in lm_mesh's 4-rank world once its runs are
# done: granite at full width, LM_MESH_RUN fed lm_mesh's f32 tokens, at
# the depths of LM_SERVE_TP_RUNS (name, weight dtype, depth; compute in
# the weights' dtype), each held to one process's halves of the same
# weights (lm_mesh's f32 model, or it cast to bf16 at rest).  The model
# ranks' partial sums round in another order than one process's products,
# which flips near-tied MoE routings (f32 too, unlike lm_mesh's form,
# whose products are whole), and a flipped routing moves its token's
# logits and, through the K/V it writes, its row's later ones.  So each
# run is held on its CLEAN rows, the (call, row) logits that no flip can
# reach (_tp_taint): f32 weights at LM_MESH_TOL of the largest |logit|
# (prefill) and LM_DECODE_F32_TOL (decode steps: the bf16 cache rounds K/V
# that differ in their last bits), their aux on the (call, layer) cells no
# flip reaches at LM_MESH_AUX_TOL (prefill) and LM_SERVE_TP_DECODE_AUX_TOL
# (decode: the steps' router inputs read that cache; one flip moves a
# step's aux by about 0.2), bf16 weights at LM_BF16_TOL (rtol = atol).
# Every run is held and must have a clean prefill row and a clean decode
# row; the primary flips (those no earlier flip reaches) are printed with
# the reference router's top-k margin there, beside the median margin.
# granite's full-depth bf16 run is not made (a flip reached every row
# there: PERF.md section 5); its full-depth bf16 build is, and the bytes
# a rank requests for its parameters and for its GQA caches are held to
# dryrun.reckon's decode cell, exactly.  Then
# LM_SERVE_TP_QWEN_ARCH at full width cut to LM_SERVE_TP_QWEN_DEPTH layers
# (qk-norm, the vocabulary split in the embedding and the logits; no
# routing), LM_SERVE_TP_QWEN_RUN (batch, prompt, decode steps) with f32
# and with bf16 weights, held to one process's run at the same bars
LM_SERVE_TP_RUNS = (("f32", "float32", None), ("f32_depth4", "float32", 4),
                    ("bf16_depth1", "bfloat16", 1))
LM_SERVE_TP_DECODE_AUX_TOL = 1e-3
LM_SERVE_TP_MARGINS_SHOWN = 16
LM_SERVE_TP_QWEN_ARCH = "qwen3-4b"
LM_SERVE_TP_QWEN_DEPTH = 2
LM_SERVE_TP_QWEN_RUN = (4, 512, 8)
# then LM_SERVE_TP_SSM_ARCH at full width cut to LM_SERVE_TP_SSM_DEPTH
# layers, its Mamba2 mixers on the rank's heads, LM_SERVE_TP_SSM_RUN with
# f32 and bf16 weights, held to one process's run at the same bars (no
# routing: every row held); with bf16 weights the bytes a rank requests
# for its parameters and for its SSM caches are held to dryrun.reckon's
# decode cell, exactly
LM_SERVE_TP_SSM_ARCH = "mamba2-2.7b"
LM_SERVE_TP_SSM_DEPTH = 2
LM_SERVE_TP_SSM_RUN = (4, 512, 8)
# then LM_SERVE_TP_MLA_ARCH (the registry's MLA arch) at full width cut to
# LM_SERVE_TP_MLA_DEPTH of its 60 layers, its MLA latent caches split over
# the sequence (max_seq / 2 positions a rank) and the absorbed decode's
# softmax combined over "model", LM_SERVE_TP_MLA_RUN with f32 and bf16
# weights, held to one process's data halves (its dispatch groups) on the
# clean rows as granite's runs are (at 1 layer a flip reaches only its
# own token's logits: the layer's latents are written before its MoE);
# with bf16 weights the bytes a rank requests for its parameters and for
# its MLA caches are held to dryrun.reckon's decode cell, exactly.  A
# rank draws each whole block in f32 (16.2 GB at full width) before it
# slices it, so the ranks build this arch one at a time
# (LM_SERVE_TP_SERIAL_BUILD)
LM_SERVE_TP_MLA_ARCH = "deepseek-v2-236b"
LM_SERVE_TP_MLA_DEPTH = 1
LM_SERVE_TP_MLA_RUN = (4, 512, 8)
# the one-process-held runs after granite's: (key, arch, depth, run); a
# routed arch's reference runs each data half alone
LM_SERVE_TP_ONE = (
    ("qwen", LM_SERVE_TP_QWEN_ARCH, LM_SERVE_TP_QWEN_DEPTH,
     LM_SERVE_TP_QWEN_RUN),
    ("mamba2", LM_SERVE_TP_SSM_ARCH, LM_SERVE_TP_SSM_DEPTH,
     LM_SERVE_TP_SSM_RUN),
    ("deepseek", LM_SERVE_TP_MLA_ARCH, LM_SERVE_TP_MLA_DEPTH,
     LM_SERVE_TP_MLA_RUN))
# the runs whose bf16 parameter and cache bytes are held to reckon's
LM_SERVE_TP_BYTES_HELD = ("mamba2", "deepseek")
LM_SERVE_TP_SERIAL_BUILD = ("deepseek",)

# the data-parallel train step (lm_train_dp): granite at full width cut to
# LM_TRAIN_DP_DEPTH layers (the gradients and the re-assembled parameters
# cross the host through gloo, about 1.7 GB each way a step at 6 layers
# against 5.5 GB at 24) on LM_TRAIN_DP_RANKS gloo ranks of the card, the
# global batch LM_TRAIN_SHAPE, LM_TRAIN_DP_STEPS steps at lm_train's
# optimizer settings.  Its losses are held to one process's at
# LM_TRAIN_DP_TOL, its parameters and gathered moments at REL_TOL of
# each leaf's largest magnitude; train_lm, run in the same world for
# LM_TRAIN_DP_SAVE_AT steps with a checkpoint (5.06 GB: the LM
# checkpoint round trip, cut from lm_train's 16.6 GB at 24 layers), then
# resumed from it to the end, is held to the run at REL_TOL; at full
# depth the ranks only build.
# dryrun_sped: the four variants at DRYRUN_SPED_SMALL (n, E, k) on
# DRYRUN_SPED_RANKS ranks, held to one process's step at REL_TOL (f32)
# and DRYRUN_SPED_BF16_TOL (bf16) of the panel's largest magnitude; the
# graph keeps the production 16 edges a node, whose spectrum stays near
# the series' [0, RHO_UB] (at 64 edges a node the Chebyshev series,
# evaluated far outside its interval, overflows to NaN)
LM_TRAIN_DP_DEPTH = 6
LM_TRAIN_DP_RANKS = 2
LM_TRAIN_DP_STEPS = 3
LM_TRAIN_DP_SAVE_AT = 2
LM_TRAIN_DP_TOL = 1e-4
LM_TRAIN_DP_TIMEOUT_S = 600.0
# lm_train_tp: LM_TRAIN_TP_ARCHS at full width cut to LM_TRAIN_TP_DEPTH
# layers on 4 gloo ranks of the card in the (2, 2) ("data", "model")
# training layout with fsdp=True, LM_TRAIN_TP_STEPS steps of the global
# batch LM_TRAIN_TP_SHAPE (remat full, f32 compute and moments,
# train_lm's optimizer at eps LM_TRAIN_TP_EPS), held to one process's
# halves (losses at
# LM_TRAIN_TP_TOL, parameters at REL_TOL of each leaf's largest
# magnitude); then LM_TRAIN_TP_FULL_ARCH at full depth built only, its
# requested bytes held to dryrun.reckon at LM_TRAIN_TP_FULL_SHAPE
# (mamba2-2.7b is left out for the script's time, PERF.md section 4: its
# head-sliced training is held on the CPU, tests/test_torch_train_tp.py)
LM_TRAIN_TP_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m")
LM_TRAIN_TP_DEPTH = 2
LM_TRAIN_TP_MESH = (2, 2)
LM_TRAIN_TP_SHAPE = (4, 512)
LM_TRAIN_TP_STEPS = 2
LM_TRAIN_TP_TOL = 1e-4
# Adam's eps for the trained runs: train_lm's optimizer but for eps 1e-3.
# The model ranks' partial sums reorder f32 additions, so a gradient
# differs from one process's in its last bits, and at the default eps
# 1e-8 Adam's slope 1/eps at g = 0 turns that into a step of up to the
# learning rate (measured: parameters 8.5e-5 (qwen3-4b) and 1.7e-4
# (granite) of a leaf's largest magnitude apart after 2 steps, losses
# 9.5e-7), as tests/test_torch_train_dp.py argues for its eps
LM_TRAIN_TP_EPS = 1e-3
LM_TRAIN_TP_FULL_ARCH = "qwen3-4b"
LM_TRAIN_TP_FULL_SHAPE = (4, 1024)
LM_TRAIN_TP_TIMEOUT_S = 600.0
DRYRUN_SPED_SMALL = (1 << 14, 1 << 18, 32)
DRYRUN_SPED_RANKS = 2
DRYRUN_SPED_BF16_TOL = 2e-3


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - _T0}
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


def cuda_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` calls, in CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn):
    """(fn(), seconds on the host clock between two synchronizes)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    """ms per call of ``calls`` calls captured in one CUDA graph."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def _latency(snap: dict) -> dict:
    """count, p50, p99 and max (seconds) per request type of a
    ``Server.stats()`` snapshot."""
    return {op: {key: h[key] for key in ("count", "p50_s", "p99_s", "max_s")}
            for op, h in snap["latency"].items()}


def _join_all(threads, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise AssertionError(f"threads still running after {timeout} s: {alive}")


def _engine_alive(srv, phase: str) -> None:
    """The server's engine thread is alive, and flush() drains."""
    if not srv.running:
        raise AssertionError(f"{phase}: the engine thread is not running")
    if not srv.flush(timeout=SERVE_TIMEOUT_S):
        raise AssertionError(f"{phase}: flush() timed out")
    if not srv.running:
        raise AssertionError(f"{phase}: the engine thread died in flush()")


def _wait_for_ticks(srv, ticks: int, phase: str) -> None:
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while srv.metrics.counter("ticks") < ticks:
        if not srv.running:
            raise AssertionError(f"{phase}: the engine thread died")
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: no tick {ticks} in time")
        time.sleep(0.005)


def serve_small_phase(dev) -> dict:
    """bench_serve.py's load through both pipelines: 6 sbm_graph(120, 4)
    tenants admitted and run to convergence untimed, then 96 pushes of up
    to 8 intra-block edges at weight 0.01 per tenant, a thread each,
    beside 2 query threads of 40 summary + labels requests, until every
    batch is applied and the fleet is back at tolerance: the wall."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core import graphs
    from repro_torch.serve import Server, ServerConfig
    from repro_torch.stream.service import ServiceConfig

    cfg = ServiceConfig(k=6, num_clusters=4, degree=9, steps_per_tick=10,
                        lr=0.3, tol=5e-3, dilation_strength=6.0, seed=0)
    n = SERVE_SMALL_N
    sids = [f"t{i}" for i in range(SERVE_SMALL_TENANTS)]
    tenants, batches = {}, {}
    for i, sid in enumerate(sids):
        g, _ = graphs.sbm_graph(n, 4, p_in=0.3, p_out=0.02, seed=100 + i,
                                device="cpu")
        tenants[sid] = (torch.stack([g.src, g.dst], 1).numpy(), g.weight.numpy())
        rng = np.random.default_rng(1000 + i)
        batches[sid] = []
        for _ in range(SERVE_SMALL_ROUNDS):
            blk = rng.integers(4) * (n // 4)
            e = np.stack([rng.integers(blk, blk + n // 4, SERVE_SMALL_BATCH),
                          rng.integers(blk, blk + n // 4, SERVE_SMALL_BATCH)],
                         axis=1)
            e = e[e[:, 0] != e[:, 1]]
            batches[sid].append((e, np.full(len(e), 0.01, np.float32)))
    runs = {}
    for pipeline in ("serialized", "double_buffer"):
        phase = f"serve_small {pipeline}"
        srv = Server(ServerConfig(service=cfg, pipeline=pipeline,
                                  idle_sleep_s=0.001), device=dev)
        srv.start()
        for sid in sids:
            edges, w = tenants[sid]
            srv.admit(sid, edges, n, weights=w, num_clusters=4,
                      edge_capacity=2048)
        if not srv.wait_converged(timeout=SERVE_TIMEOUT_S):
            raise AssertionError(f"{phase}: the warm-up did not converge")
        errors = []

        def pusher(sid):
            try:
                for e, w in batches[sid]:
                    srv.push(sid, e, w, mode="add")
            except Exception as exc:
                errors.append(exc)

        def querier(t):
            try:
                rng = np.random.default_rng(2000 + t)
                for _ in range(SERVE_SMALL_QUERIES):
                    sid = sids[rng.integers(len(sids))]
                    srv.summary(sid)
                    srv.labels(sid)
            except Exception as exc:
                errors.append(exc)

        threads = ([threading.Thread(target=pusher, args=(sid,), daemon=True)
                    for sid in sids]
                   + [threading.Thread(target=querier, args=(t,), daemon=True)
                      for t in range(SERVE_QUERY_THREADS)])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        _join_all(threads, SERVE_TIMEOUT_S)
        _engine_alive(srv, phase)
        if not srv.wait_converged(timeout=SERVE_TIMEOUT_S):
            raise AssertionError(f"{phase}: the fleet did not re-converge")
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        _engine_alive(srv, phase)
        srv.stop()
        snap = srv.stats()
        counters = snap["counters"]
        pushed = SERVE_SMALL_TENANTS * SERVE_SMALL_ROUNDS
        if not (counters.get("applied_batches") == pushed
                and counters.get("dropped_batches", 0) == 0
                and snap["engine"]["all_converged"]):
            raise AssertionError(f"{phase}: {counters}, {snap['engine']}")
        runs[pipeline] = {
            "wall_s": wall, "latency": _latency(snap), "counters": counters,
            "tick_utilization": snap["gauges"]["tick_utilization"],
            "programs": srv.service.compile_count,
            "captures": sum(p.captures for p in srv.service._compiled.values()),
            "tick_invocations": srv.service.tick_invocations}
    return {"phase": "serve_small", "tenants": SERVE_SMALL_TENANTS, "n": n,
            "pushes_per_tenant": SERVE_SMALL_ROUNDS, **runs,
            "serialized_over_double_buffer_wall": (
                runs["serialized"]["wall_s"] / runs["double_buffer"]["wall_s"])}


def serve_http_phase(shell_args) -> dict:
    """bench_serve.http_smoke against ``python -m repro_torch.serve`` as a
    subprocess: admit a 60-node SBM, wait for convergence, 110 rounds of
    push, labels and summary, read /metrics (the child's kernel launches
    too), then SIGTERM: exit 0 and STOPPED.  The child is killed in a
    finally."""
    import os
    import select
    import signal
    import urllib.request

    import numpy as np
    import torch
    from repro_torch.core import graphs

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", *shell_args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], SERVE_TIMEOUT_S)
        banner = proc.stdout.readline().strip() if ready else ""
        if not banner.startswith("SERVING "):
            proc.kill()
            _, err = proc.communicate(timeout=60)
            raise AssertionError(f"serve_http: banner {banner!r}; {err[-3000:]}")
        boot_s = time.perf_counter() - t0
        base = "http://127.0.0.1:" + dict(
            kv.split("=") for kv in banner.split()[1:])["port"]

        def req(path, method="GET", body=None):
            data = json.dumps(body).encode() if body is not None else None
            r = urllib.request.Request(
                base + path, data=data, method=method,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=60) as resp:
                return json.loads(resp.read())

        g, _ = graphs.sbm_graph(60, 3, p_in=0.4, p_out=0.02, seed=0,
                                device="cpu")
        req("/v1/sessions/smoke", "POST",
            {"edges": torch.stack([g.src, g.dst], 1).tolist(),
             "num_nodes": 60, "num_clusters": 3,
             "weights": g.weight.tolist()})
        deadline = time.monotonic() + 120.0
        while not req("/v1/sessions/smoke").get("converged"):
            if time.monotonic() > deadline:
                raise AssertionError("serve_http: the session never converged")
            time.sleep(0.1)
        req("/v1/sessions/smoke/labels")
        rng = np.random.default_rng(0)
        t_load = time.perf_counter()
        for _ in range(SERVE_HTTP_ROUNDS):
            i, j = rng.integers(0, 60, 2)
            if i != j:
                req("/v1/sessions/smoke/edges", "POST",
                    {"edges": [[int(i), int(j)]], "weights": [0.05],
                     "mode": "add"})
            req("/v1/sessions/smoke/labels")
            req("/v1/sessions/smoke")
        load_s = time.perf_counter() - t_load
        metrics = req("/metrics")
        health = req("/healthz")
        worst = max(h["p99_s"] for op, h in metrics["latency"].items()
                    if h["count"] and op != "admit")
        if worst > SERVE_HTTP_P99_S:
            raise AssertionError(f"serve_http: worst p99 {worst} s > "
                                 f"{SERVE_HTTP_P99_S} s")
        if not health["running"]:
            raise AssertionError("serve_http: the engine thread died")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        if proc.returncode != 0 or out.strip().splitlines()[-1] != "STOPPED":
            raise AssertionError(f"serve_http: exit {proc.returncode}, "
                                 f"{out[-500:]!r}, {err[-3000:]}")
        return {"phase": "serve_http", "args": list(shell_args),
                "boot_to_banner_s": boot_s, "rounds": SERVE_HTTP_ROUNDS,
                "load_s": load_s, "worst_non_admit_p99_s": worst,
                "latency": _latency(metrics), "counters": metrics["counters"],
                "engine": metrics["engine"], "exit_code": proc.returncode}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)


def _live_edges_match(base, pushes, after, n: int) -> bool:
    """The session's live edges ``after`` equal ``base`` with every pushed
    (pairs, weights) batch added in order, per canonical key (duplicate
    slots summed), exactly."""
    import numpy as np

    def per_key(src, dst, w):
        keys = (np.minimum(src, dst).astype(np.int64) * n
                + np.maximum(src, dst))
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq, np.bincount(inv, weights=w.astype(np.float64))

    pairs = np.concatenate([e for e, _ in pushes])
    want = per_key(np.concatenate([base[0], pairs[:, 0]]),
                   np.concatenate([base[1], pairs[:, 1]]),
                   np.concatenate([base[2], *[w for _, w in pushes]]))
    got = per_key(*after)
    return all(np.array_equal(a, b) for a, b in zip(want, got))


def serve_full_phase(tenant_graph, cfg_svc, n: int, dev) -> dict:
    """The headline serving cell: a started Server (double_buffer) over
    SERVICE_TENANTS tenants of ``tenant_graph(i)`` (n nodes, in their
    capacity class), 4 pusher threads staging SERVE_FULL_PUSHES batches of
    SERVE_FULL_B new pairs per tenant (one per tick), 2 query threads
    reading summary and labels in a loop from before the first tick,
    then flush, SERVE_FULL_TAIL_TICKS more ticks and stop()."""
    import hashlib
    import threading

    import numpy as np
    import torch
    from repro_torch.core import kmeans as km
    from repro_torch.core import operators
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Server, ServerConfig
    from repro_torch.serve import server as serve_server
    from repro_torch.stream import tracking

    phase = "serve_full"
    sids = [f"t{i}" for i in range(SERVICE_TENANTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    srv = Server(ServerConfig(service=cfg_svc, idle_sleep_s=0.001), device=dev)
    admit_s, base = [], {}
    for i, sid in enumerate(sids):
        g_t = tenant_graph(i)
        t0 = time.perf_counter()
        srv.admit(sid, torch.stack([g_t.src, g_t.dst], 1), n,
                  weights=g_t.weight)
        admit_s.append(time.perf_counter() - t0)
        base[sid] = srv.service.live_edges(sid)
        del g_t
    rng = np.random.default_rng(7)
    pushes = {sid: [] for sid in sids}
    for sid in sids:
        for _ in range(SERVE_FULL_PUSHES):
            a = rng.integers(0, n, SERVE_FULL_B)
            b = (a + rng.integers(1, n, SERVE_FULL_B)) % n
            w = rng.integers(1, 9, SERVE_FULL_B).astype(np.float32) / 64
            pushes[sid].append((np.stack([a, b], 1), w))
    buf = serve_server._PendingBuffer()
    t0 = time.perf_counter()
    buf.merge(*pushes[sids[0]][0], "add")
    merge_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    list(buf.flush_batches())
    flush_batches_s = time.perf_counter() - t0
    del buf

    captures_at, ticks_at, queries, errors = [], [], [], []
    real_capture = operators.capture_graph
    inner_tick = srv.service.tick

    def capture_graph(fn):
        t0 = time.perf_counter()
        try:
            return real_capture(fn)
        finally:
            captures_at.append((t0, time.perf_counter()))

    def tick():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = inner_tick()
        end.record()
        end.synchronize()
        ticks_at.append((t0, time.perf_counter(), start, end))
        return out

    stop_queries = threading.Event()

    def querier(t):
        try:
            j = t
            while not stop_queries.is_set():
                sid = sids[j % len(sids)]
                j += 1
                t0 = time.perf_counter()
                version = srv.summary(sid)["version"]
                queries.append((t, sid, "summary", version, t0,
                                time.perf_counter(), None))
                t0 = time.perf_counter()
                out = srv.labels(sid)
                queries.append((t, sid, "labels", out["version"], t0,
                                time.perf_counter(), hashlib.blake2b(
                                    out["labels"].tobytes(),
                                    digest_size=16).hexdigest()))
                time.sleep(0.002)
        except Exception as exc:
            errors.append(exc)

    def pusher(sid):
        try:
            for b, (e, w) in enumerate(pushes[sid]):
                _wait_for_ticks(srv, b + 1, phase)
                srv.push(sid, e, w, mode="add")
        except Exception as exc:
            errors.append(exc)

    q_threads = [threading.Thread(target=querier, args=(t,), daemon=True)
                 for t in range(SERVE_QUERY_THREADS)]
    p_threads = [threading.Thread(target=pusher, args=(sid,), daemon=True)
                 for sid in sids]
    operators.capture_graph = capture_graph
    srv.service.tick = tick
    reset_launch_counts()
    try:
        for t in q_threads:
            t.start()
        t_start = time.perf_counter()
        srv.start()
        for t in p_threads:
            t.start()
        _join_all(p_threads, SERVE_TIMEOUT_S)
        if errors:
            raise errors[0]
        if not srv.running:
            raise AssertionError(f"{phase}: the engine thread died")
        t0 = time.perf_counter()
        flushed = srv.flush(timeout=SERVE_TIMEOUT_S)
        flush_s = time.perf_counter() - t0
        if not (flushed and srv.running):
            raise AssertionError(f"{phase}: flush {flushed}, running "
                                 f"{srv.running}")
        _wait_for_ticks(srv, srv.metrics.counter("ticks")
                        + SERVE_FULL_TAIL_TICKS, phase)
        stop_queries.set()
        _join_all(q_threads, SERVE_TIMEOUT_S)
        if errors:
            raise errors[0]
        _engine_alive(srv, phase)
        t0 = time.perf_counter()
        srv.stop(timeout=SERVE_TIMEOUT_S)
        stop_s = time.perf_counter() - t0
        serving_s = time.perf_counter() - t_start
        counts = launch_counts()
    finally:
        stop_queries.set()
        operators.capture_graph = real_capture
        del srv.service.tick
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    if srv.running:
        raise AssertionError(f"{phase}: the engine thread outlived stop()")
    snap = srv.stats()
    counters = snap["counters"]
    pushed = SERVICE_TENANTS * SERVE_FULL_PUSHES
    if not (counters.get("staged_batches") == counters.get("applied_batches")
            == pushed and counters.get("dropped_batches", 0) == 0):
        raise AssertionError(f"{phase}: counters {counters}")
    # served versions never go backwards, per query thread and tenant;
    # labels served at one version are one byte string
    seen, digests = {}, {}
    for t, sid, op, version, _, _, digest in queries:
        if version < seen.get((t, sid, op), 0):
            raise AssertionError(f"{phase}: {op} of {sid} went back to "
                                 f"version {version}")
        seen[(t, sid, op)] = version
        if digest is not None and digests.setdefault((sid, version),
                                                     digest) != digest:
            raise AssertionError(f"{phase}: two labellings of {sid} at "
                                 f"version {version}")
    for sid in sids:
        if not _live_edges_match(base[sid], pushes[sid],
                                 srv.service.live_edges(sid), n):
            raise AssertionError(f"{phase}: {sid}'s live edges differ from "
                                 "the reference: an update was lost")

    def overlaps(op):
        return sum(1 for q in queries if q[2] == op and any(
            q[4] < c1 and c0 < q[5] for c0, c1 in captures_at))

    labels_s = [q[5] - q[4] for q in queries if q[2] == "labels"]
    # the labels path at n = 2^20 on an idle card, split: k-means on a
    # committed panel (CUDA events), the copy of its labels to the host,
    # the store's tracker on the host; then one uncommitted-version
    # labels request end to end after a manual step
    served = srv.labels(sids[0])["labels"]
    rv = srv.results._sessions[sids[0]].latest
    emb = rv.panel[:, 1: 1 + cfg_svc.num_clusters]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = km.kmeans(torch.Generator(device=dev).manual_seed(0), emb,
                    cfg_svc.num_clusters, restarts=cfg_svc.kmeans_restarts)
    end.record()
    end.synchronize()
    kmeans_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    raw = res.labels.cpu().numpy()
    copy_s = time.perf_counter() - t0
    tracker = tracking.LabelTracker(cfg_svc.num_clusters)
    tracker.update(torch.from_numpy(served))
    t0 = time.perf_counter()
    tracker.update(torch.as_tensor(raw)).numpy().astype(np.int32)
    tracker_s = time.perf_counter() - t0
    srv.step()
    t0 = time.perf_counter()
    fresh = srv.labels(sids[0])
    labels_fresh_s = time.perf_counter() - t0
    if not (fresh["labels"].shape == (n,) and fresh["labels"].min() >= 0
            and fresh["labels"].max() < cfg_svc.num_clusters):
        raise AssertionError(f"{phase}: malformed labels")
    programs = srv.service.compile_count
    captures = sum(p.captures for p in srv.service._compiled.values())
    return {
        "phase": phase, "tenants": SERVICE_TENANTS, "n": n,
        "capacity_class": srv.service.capacity_class(sids[0]), "k": cfg_svc.k, "num_clusters": cfg_svc.num_clusters,
        "pushes_per_tenant": SERVE_FULL_PUSHES, "push_b": SERVE_FULL_B,
        "admit_s": admit_s,
        "tick_ms": [s_.elapsed_time(e_) for _, _, s_, e_ in ticks_at],
        "tick_host_s": [t1 - t0 for t0, t1, _, _ in ticks_at],
        "capture_s": [c1 - c0 for c0, c1 in captures_at],
        "queries": {"summary": sum(q[2] == "summary" for q in queries),
                    "labels": len(labels_s)},
        "queries_overlapping_a_capture": {
            "summary": overlaps("summary"), "labels": overlaps("labels")},
        "labels_over_50ms": sum(s_ > 0.05 for s_ in labels_s),
        "latency": _latency(snap),
        "staging_merge_s_b4096": merge_s,
        "staging_flush_batches_s_b4096": flush_batches_s,
        "flush_s": flush_s, "stop_s": stop_s,
        "tick_utilization": snap["gauges"]["tick_utilization"],
        "serving_s": serving_s,
        "tick_share_of_serving": sum(t1 - t0 for t0, t1, _, _ in ticks_at)
        / serving_s,
        "counters": counters, "programs": programs, "captures": captures,
        "labels_split": {"kmeans_ms": kmeans_ms, "copy_to_host_s": copy_s,
                         "tracker_host_s": tracker_s,
                         "labels_new_version_s": labels_fresh_s},
        "memory_allocated_at_start": start_bytes,
        "max_memory_allocated": peak, "memory_reserved": reserved,
        "launches": counts}


# ---- rank bodies of the sharded phases ------------------------------------
# Each runs in one rank of a world that parallel.run_ranks spawns (ranks
# import this file as their main module).  A body resets the kernel counts
# just before its main-path part and returns them just after, so timing
# and comparison launches stay out of the kernels line.

def _edge_list(src, dst, w, n: int, dev):
    import torch

    from repro_torch.core import laplacian as lap

    return lap.EdgeList(*(torch.from_numpy(a).to(dev) for a in (src, dst, w)),
                        int(n))


def sharded_small_rank(dev, cfg, steps: int) -> dict:
    """Phase small's clique solve (clustering.spectral_cluster's series,
    solver and k-means) through distributed_solve, K1 per shard."""
    import torch

    from repro_torch import kernels, parallel
    from repro_torch.core import build_series, distributed, graphs, metrics
    from repro_torch.core import kmeans as km
    from repro_torch.core import laplacian as lap

    mesh = parallel.default_edge_mesh(device=dev)
    g, truth = graphs.clique_graph(160, 4, seed=3, device=dev)
    k = cfg.num_clusters + cfg.extra_eigvecs + 1
    s = build_series(cfg, float(lap.spectral_radius_upper_bound(g)))
    scfg = dataclasses.replace(cfg.solver, k=k, seed=cfg.seed, steps=steps,
                               eval_every=steps)
    _, v_star = metrics.ground_truth_bottom_k(lap.laplacian_dense(g), k)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, trace = distributed.distributed_solve(mesh, g, s, scfg,
                                                 v_star=v_star)
    emb = state.v[:, 1:1 + cfg.num_clusters]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    labels = km.kmeans(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                       emb, cfg.num_clusters,
                       restarts=cfg.kmeans_restarts).labels
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "launches": kernels.launch_counts(),
            "agreement": float(km.cluster_agreement(labels, truth, 4)),
            "panel": state.v, "subspace_error": trace.subspace_error}


def _operator_call(dev, src, dst, w, n: int, plan, v0) -> dict:
    """One call of the edge-sharded series operator of ``plan`` (K2 per
    shard) on ``v0``: its output, seconds and launches, and the mesh,
    graph, panel and operator for further use in the rank."""
    import torch

    from repro_torch import kernels, parallel, spectral
    from repro_torch.core import distributed

    mesh = parallel.default_edge_mesh(device=dev)
    g = _edge_list(src, dst, w, n, dev)
    op = distributed.distributed_series_operator(
        mesh, g, spectral.series_from_plan(plan), backend="kernel")
    v = torch.from_numpy(v0).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = op(v)
    torch.cuda.synchronize()
    return {"out": out, "first_call_s": time.perf_counter() - t0,
            "launches": kernels.launch_counts(), "op": op, "g": g, "v": v,
            "mesh": mesh}


def sharded_operator_rank(dev, src, dst, w, n: int, plan, v0) -> dict:
    """:func:`_operator_call`'s output, seconds and launches."""
    out = _operator_call(dev, src, dst, w, n, plan, v0)
    return {key: out[key] for key in ("out", "first_call_s", "launches")}


def sharded_full_rank(dev, src, dst, w, n: int, plan, v0, lr: float,
                      steps: int, reps: int) -> dict:
    """Phase sharded_full in one rank: the operator call, the per-factor
    split (the shard's K2 in CUDA events, the all_reduce of the panel by
    the host clock, the AXPY), a second call, then ``steps`` solver
    steps of distributed_solve and the rank's peak memory."""
    import torch

    from repro_torch import kernels, parallel, spectral
    from repro_torch.core import SolverConfig, distributed, program

    first = _operator_call(dev, src, dst, w, n, plan, v0)
    mesh, g, v, op = first.pop("mesh"), first.pop("g"), first.pop("v"), \
        first.pop("op")
    main = first.pop("launches")
    sync = torch.cuda.synchronize
    group = parallel.edge_group(mesh)
    gp = distributed.pad_edges_for_mesh(g, parallel.num_edge_shards(mesh))
    local = distributed._local_fused(mesh, ("data",), gp.src, gp.dst,
                                     gp.weight, n, "kernel")
    c = plan.scale / plan.degree  # a factor's alpha is -c, its beta 1

    def events_ms(fn) -> float:
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

    shard_k2_ms = events_ms(lambda: local(v, 1.0, 0.0))
    lu = local(v, 1.0, 0.0)
    all_reduce_ms = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        program._psum(lu, group)
        sync()
        all_reduce_ms.append((time.perf_counter() - t0) * 1e3)
    axpy_ms = events_ms(lambda: -c * lu + 1.0 * v)
    sync()
    t0 = time.perf_counter()
    op(v)
    sync()
    call_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # the split's launches are not the path's
    t0 = time.perf_counter()
    state, _ = distributed.distributed_solve(
        mesh, g, spectral.series_from_plan(plan),
        SolverConfig(lr=lr, steps=steps, eval_every=steps, k=v.shape[1],
                     backend="kernel"), init_v=v)
    sync()
    solve_s = time.perf_counter() - t0
    solve_launches = kernels.launch_counts()
    return {**first, "call_s": call_s, "shard_k2_ms": shard_k2_ms,
            "all_reduce_ms": all_reduce_ms, "axpy_ms": axpy_ms,
            "solve_s": solve_s, "solve_panel": state.v,
            "launches": {name: main[name] + solve_launches[name]
                         for name in main},
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "shard_slots": int(gp.num_edges // parallel.num_edge_shards(mesh))}


def sharded_fleet_rank(dev, fleet_np, cfg, capacity: int) -> dict:
    """Phase service_small's round_robin fleet through an edge-sharded
    StreamingService (probes and ticks sharded), run to convergence."""
    import torch

    from repro_torch import kernels, parallel
    from repro_torch.stream.service import StreamingService

    mesh = parallel.default_edge_mesh(device=dev)
    svc = StreamingService(dataclasses.replace(cfg, mesh=mesh), device=dev)
    kernels.reset_launch_counts()
    for sid, src, dst, w, n in fleet_np:
        svc.add_graph(sid, _edge_list(src, dst, w, n, dev),
                      edge_capacity=capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = svc.run_until_converged(max_ticks=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    return {"ticks": ticks, "wall_s": wall, "launches": launches,
            "tick_invocations": svc.tick_invocations,
            "device_work_steps": svc.device_work,
            "programs": svc.compile_count,
            "captures": sum(p.captures for p in svc._compiled.values()),
            "converged": svc.all_converged,
            "max_residual": max(svc.session_info(sid)["residual"]
                                for sid in svc.session_ids()),
            "labels": {sid: svc.labels(sid) for sid in svc.session_ids()}}


def sharded_tick_rank(dev, src, dst, w, n: int, capacity: int, v0, c: float,
                      lr: float, degree: int, steps: int) -> dict:
    """One edge-sharded kernel tick of one tenant's store (its shard of
    the capacity-padded buffer), one all_reduce per dilation factor."""
    import torch

    from repro_torch import kernels, parallel
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gstore

    mesh = parallel.default_edge_mesh(device=dev)
    store = gstore.from_edge_list(_edge_list(src, dst, w, n, dev),
                                  capacity=capacity)
    rows = gstore.shard_edge_rows(store, mesh)
    prog = program.build_tick_program(program.StepSchedule(
        degree=degree, steps=steps, backend="kernel"), dev, mesh=mesh)
    v = torch.from_numpy(v0).to(dev)[None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vs, res = prog([rows], [c], v, [lr], 1)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "panel": vs[0],
            "residual": float(res[0]), "launches": kernels.launch_counts(),
            "captures": prog.captures,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def _model_mesh(dev):
    """The ("data", "model") mesh of shape (1, world size): panels
    sharded over "model"."""
    import torch.distributed as dist

    from repro_torch import parallel

    return parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                              dev)


def _model_factor_split(dev, rows, v, c: float, mesh, reps: int) -> dict:
    """One panel-sharded factor's parts in this rank: K2 on the owned
    rows (the rectangular launch, CUDA events) and the all_reduce of the
    embedded (n_pad, k) panel (host clock)."""
    import torch

    from repro_torch import parallel
    from repro_torch.core import program
    from repro_torch.kernels.edge_spmm import ops as es_ops

    r = rows.row_ptr.shape[0] - 1
    n_pad = parallel.num_model_shards(mesh) * r
    start = parallel.model_shard_index(mesh) * r
    vp = torch.zeros((n_pad, v.shape[1]), dtype=torch.float32, device=dev)
    vp[:v.shape[0]] = v
    es_ops.model_local_rows(rows, vp, -c, 1.0, start)
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        es_ops.model_local_rows(rows, vp, -c, 1.0, start)
    end.record()
    torch.cuda.synchronize()
    group = parallel.edge_group(mesh, ("model",))
    all_reduce_ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program._psum(torch.zeros_like(vp), group)
        torch.cuda.synchronize()
        all_reduce_ms.append((time.perf_counter() - t0) * 1e3)
    counts = rows.row_ptr[1:] - rows.row_ptr[:-1]
    return {"owned_k2_ms": begin.elapsed_time(end) / reps,
            "all_reduce_ms": all_reduce_ms, "panel_bytes": n_pad * v.shape[1] * 4,
            "rows_per_shard": r, "live_half_edges": int(rows.row_ptr[-1]),
            "longest_row": int(counts.max()),
            "hub_rows": int((rows.hub_rows < r).sum())}


def model_tick_rank(dev, src, dst, w, n: int, capacity: int, v0, c: float,
                    lr: float, degree: int, steps: int, methods,
                    reps: int) -> dict:
    """Panel-sharded kernel ticks of one store in this rank, one per
    solver method (K2 on the rank's owned rows per factor, per mu-EG step
    one fused rows + gram all_reduce), then the per-factor split."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gstore

    mesh = _model_mesh(dev)
    store = gstore.from_edge_list(_edge_list(src, dst, w, n, dev),
                                  capacity=capacity)
    v = torch.from_numpy(v0).to(dev)[None]
    out, launches = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = gstore.model_shard_rows(store, mesh)
    torch.cuda.synchronize()
    rows_build_s = time.perf_counter() - t0
    for method in methods:
        prog = program.build_tick_program(program.StepSchedule(
            method=method, degree=degree, steps=steps, backend="kernel"), dev,
            mesh=mesh, model_axes=("model",))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with program.count_psums() as stats:
            vs, res = prog([rows], [c], v, [lr], 1)
        torch.cuda.synchronize()
        out[method] = {"seconds": time.perf_counter() - t0, "panel": vs[0],
                       "residual": float(res[0]),
                       "psums": (stats.plain, stats.fused),
                       "captures": prog.captures}
        for name, x in kernels.launch_counts().items():
            launches[name] = launches.get(name, 0) + x
    peak = torch.cuda.max_memory_allocated(dev)
    split = _model_factor_split(dev, rows, v[0], c, mesh, reps)
    return {**out, **split, "launches": launches, "rows_build_s": rows_build_s,
            "max_memory_allocated": peak}


def model_million_rank(dev, n: int, avg_degree: float, alpha: float,
                       seed: int, capacity: int, cfg, reps: int) -> dict:
    """The README's million-node row in this rank: the power-law graph
    generated here from its seed, admitted into a panel-sharded
    StreamingService (the probe on the owned-rows matvec, the plan) and
    ticked once; then the probe again on its own, the factor split on
    the rank's (hub-heavy) owned rows and K2's rectangular launch there
    held to its twin.  Rank 0 also runs the same tick in one process (a
    TickProgram with no group over the store's whole row CSR) from the
    same panel and plan, and holds the sharded tick to it."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import graphs, program
    from repro_torch.kernels.edge_spmm import ref as es_ref
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.spectral import probes
    from repro_torch.stream import graph_store as gstore
    from repro_torch.stream.service import StreamingService

    mesh = _model_mesh(dev)
    t0 = time.perf_counter()
    g = graphs.power_law_graph(n, avg_degree, alpha, seed=seed, dedup=False,
                               device=dev)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    num_edges = g.num_edges
    svc = StreamingService(dataclasses.replace(
        cfg, mesh=mesh, model_axes=("model",)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    svc.add_graph("web", g, edge_capacity=capacity)
    torch.cuda.synchronize()
    admission_s = time.perf_counter() - t0
    sess = svc._sessions["web"]
    degree = svc._session_degree(sess)
    v_before = sess.v.clone()
    t0 = time.perf_counter()
    with program.count_psums() as stats:
        res = svc.tick()["web"]
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    del g
    rows = gstore.model_shard_rows(sess.store, mesh)
    t0 = time.perf_counter()
    probe = probes.probe_model_sharded(
        mesh, rows, n, num_nodes=sess.store.num_nodes,
        num_probes=cfg.probe_vectors, num_steps=cfg.probe_steps,
        generator=torch.Generator(device=dev).manual_seed(cfg.seed + 7))
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    c = program.dilation_scale(sess.plan, degree)
    split = _model_factor_split(dev, rows, v_before, c, mesh, reps)
    r = rows.row_ptr.shape[0] - 1
    start = dist.get_rank() * r
    got = es_ops.model_local_rows(rows, v_before, -c, 1.0, start)
    want = es_ref.edge_spmm_rows(rows.row_ptr, rows.other, rows.weight,
                                 v_before, -c, 1.0,
                                 v_self=v_before[start:start + r])
    rect = {"max_abs_err": float((got - want).abs().max()),
            "tolerance": REL_TOL * float(want.abs().max()),
            "bitwise_repeatable": bool(torch.equal(
                got, es_ops.model_local_rows(rows, v_before, -c, 1.0, start)))}
    del got, want
    one_process = None
    if dist.get_rank() == 0:
        prog = program.build_tick_program(program.StepSchedule(
            degree=degree, steps=cfg.steps_per_tick, backend="kernel"), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_v, want_res = prog([gstore.edge_rows(sess.store)], [c],
                                v_before[None], [sess.lr], 1)
        torch.cuda.synchronize()
        one_process = {"seconds": time.perf_counter() - t0,
                       "max_abs_err": float((sess.v - want_v[0]).abs().max()),
                       "tolerance": REL_TOL * float(want_v[0].abs().max()),
                       "residual": float(want_res[0])}
    return {"graph_host_s": graph_s, "num_edges": num_edges,
            "admission_s": admission_s, "probe_s": probe_s,
            "probe_lambda_max": float(probe.lambda_max),
            "plan": {"family": sess.plan.family, "degree": degree,
                     "rho": sess.rho, "rho_ub": sess.rho_ub, "tau": sess.tau,
                     "lr": sess.lr, "c": c},
            "tick": {"seconds": tick_s, "panel": sess.v, "residual": res,
                     "psums": (stats.plain, stats.fused),
                     "captures": sum(p.captures
                                     for p in svc._compiled.values())},
            "one_process": one_process, "rectangular": rect,
            "node_capacity": sess.store.num_nodes,
            "edge_capacity": sess.store.capacity,
            "launches": launches, "max_memory_allocated": peak, **split}


def model_full_rank(dev, tenant_args, million_args) -> dict:
    """Phase model_sharded_full in one world: the 2^20 tenant tick
    (:func:`model_tick_rank`), then the million-node row
    (:func:`model_million_rank`)."""
    import torch

    tenant = model_tick_rank(dev, *tenant_args)
    torch.cuda.empty_cache()
    return {"tenant": tenant, "million": model_million_rank(dev, *million_args)}


# ---- the paper's figures (phases 24-30) ------------------------------------
# benchmarks/common.py's protocol and the benches' settings, copied: this
# script imports nothing of benchmarks/ (it imports JAX)


def paper_transform_suite(rho_ub: float, degree: int = 251) -> dict:
    """benchmarks/common.py's paper_transform_suite: identity | limit
    series | the limit series scaled to radius 8 | chebyshev-log
    (beyond the paper)."""
    from repro_torch.core import (cheb_log, identity_series, limit_neg_exp,
                                  with_lambda_star)

    return {
        "identity": with_lambda_star(identity_series(), rho_ub * 1.01),
        "limit_neg_exp": limit_neg_exp(degree),
        "limit_neg_exp_scaled": limit_neg_exp(degree, scale=8.0 / rho_ub),
        "cheb_log(beyond)": cheb_log(64, rho=rho_ub),
    }


def dense_series_operator(l_mat, series):
    """V -> (lambda* I - S(L)) V over a dense L, the benches' operator; on
    the card its launches replay from one CUDA graph per panel shape."""
    from repro_torch.core import operators

    fn = operators.series_operator(series, operators.dense_matvec(l_mat))
    return operators.CapturedOperator(fn) if l_mat.is_cuda else fn


def convergence_run(g, transform, method: str, lr: float, steps: int, k: int,
                    v_star=None, eval_every: int = FIG_EVAL_EVERY, *,
                    init_v=None, device=None, operator=None) -> dict:
    """benchmarks/common.py's convergence_run on the port: run the solver
    on the dense L's series (or on ``operator``) from seed 0 or from
    ``init_v``, and report steps to a full streak and to 1 % subspace
    error.  ``device=None`` is the card.  The result also holds the
    trace, the final state and the operator."""
    from repro_torch.core import laplacian as lap
    from repro_torch.core import metrics, solvers
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    l_mat = lap.laplacian_dense(g).to(dev)
    if v_star is None:
        _, v_star = metrics.ground_truth_bottom_k(l_mat, k)
    op = operator if operator is not None else dense_series_operator(
        l_mat, transform)
    cfg = solvers.SolverConfig(method=method, lr=lr, steps=steps,
                               eval_every=eval_every, k=k, seed=0)
    t0 = time.perf_counter()
    state, trace = solvers.run_solver(op, g.num_nodes, cfg, v_star=v_star,
                                      init_v=init_v, device=dev)
    final_err = float(trace.subspace_error[-1])
    wall = time.perf_counter() - t0
    return {
        "steps_to_streak": solvers.steps_to_streak(trace, k),
        "steps_to_1pct": solvers.steps_to_tolerance(trace, 0.01),
        "final_err": final_err,
        "final_streak": int(trace.streak[-1]),
        "wall_s": wall,
        "trace": trace, "state": state, "operator": op,
    }


def table2_suite(rho: float) -> dict:
    """bench_transforms.py's transforms (paper Table 2 and beyond)."""
    from repro_torch.core import (cheb_log, cheb_neg_exp, identity_series,
                                  limit_neg_exp, taylor_log, taylor_neg_exp,
                                  with_lambda_star)

    return {
        "identity": with_lambda_star(identity_series(), rho * 1.01),
        "taylor_log_d51": taylor_log(51, eps=0.05),
        "taylor_neg_exp_d51": taylor_neg_exp(51),
        "limit_neg_exp_d251": limit_neg_exp(251),
        "limit_neg_exp_d251_s8": limit_neg_exp(251, scale=8.0 / rho),
        "cheb_log_d64": cheb_log(64, rho=rho),
        "cheb_neg_exp_d32": cheb_neg_exp(32, rho=rho, tau=8.0 / rho),
    }


def table2_ratios(device) -> dict:
    """Per transform of :func:`table2_suite`, bench_transforms.py's
    convergence ratio on its synthetic spectrum (4 bottom eigenvalues far
    below a bulk on [20, 60]) and the dilation factor over the identity's
    ratio: {name: (ratio, dilation)}, NaN where the series diverges."""
    import math

    import torch

    lam = torch.cat([
        torch.tensor([0.0, 0.05, 0.08, 0.12], device=device),
        torch.linspace(20.0, 60.0, 60, device=device)])

    def conv_ratio(f_vals) -> float:
        # spectral range over the least gap among the bottom k + 1 values
        f_vals = torch.sort(f_vals).values
        gaps = torch.diff(f_vals[: TABLE2_K + 1])
        rng = f_vals[-1] - f_vals[0]
        return float(rng / torch.clamp(torch.min(gaps), min=1e-30))

    base = conv_ratio(lam)
    out = {}
    for name, s in table2_suite(float(lam[-1])).items():
        ratio = conv_ratio(s.scalar(lam))
        dil = (base / ratio if math.isfinite(ratio) and ratio > 0
               else float("nan"))
        out[name] = (ratio, dil)
    return out


def _fig_row(name: str, method: str, r: dict, ms: float) -> dict:
    """One figure row: the protocol's summary, ms per solver step and the
    wall time to 1 % error (steps x ms per step)."""
    return {"transform": name, "method": method,
            "steps_to_streak": r["steps_to_streak"],
            "steps_to_1pct": r["steps_to_1pct"], "final_err": r["final_err"],
            "final_streak": r["final_streak"], "run_s": r["wall_s"],
            "ms_per_step": ms,
            "wall_to_1pct_s": (r["steps_to_1pct"] * ms / 1e3
                               if r["steps_to_1pct"] >= 0 else None)}


def _step_ms(r: dict, method: str, lr: float) -> float:
    """ms of one operator call plus one solver step on the run's final
    panel, in CUDA events."""
    from repro_torch.core import program, solvers

    st, op = r["state"], r["operator"]
    step_fn = solvers.make_step_fn(method, "auto", st.v.device)
    return cuda_ms(lambda: program.apply_solver_step(
        step_fn, st, op(st.v), lr), FIG_STEP_REPS)


def _figure_start(g, k: int, dev, seed: int = 0):
    """(v_star, the initial panel drawn with ``seed``) of a figure's graph:
    every run of the figure starts from the seed-0 panel."""
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.core import metrics, solvers

    _, v_star = metrics.ground_truth_bottom_k(lap.laplacian_dense(g), k)
    init = solvers.init_state(torch.Generator(device=dev).manual_seed(seed),
                              g.num_nodes, k).v
    return v_star, init


def _held(name: str, got, want) -> tuple[float, float]:
    """(max |got - want|, its tolerance REL_TOL * max |want|); raises past
    the tolerance."""
    err = float((got - want).abs().max())
    tol = REL_TOL * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err, tol


def _held_eg(label: str, v, av, lr: float) -> dict:
    """K3 and K4 against their twins on a run's panel V and AV = op(V), at
    the shapes the run gave them: {kernel: max_abs_err}."""
    from repro_torch.kernels.eg_update import ops as eg_ops
    from repro_torch.kernels.eg_update import ref as eg_ref

    errs = {"gram2k": _held(f"{label}: gram2k", eg_ops.gram2k(v, av),
                            eg_ref.gram2k(v, av))[0]}
    m1, m2, cs = eg_ref.coefficient_matrices(eg_ref.gram2k(v, av),
                                             v.shape[1], lr)
    errs["panel_mix"] = _held(f"{label}: panel_mix",
                              eg_ops.panel_mix(v, av, m1, m2, cs),
                              eg_ref.panel_mix(v, av, m1, m2, cs))[0]
    return errs


def _held_edge_path(label: str, g, series, op, c: float, v,
                    rows=None) -> dict:
    """``op``, the kernel path's operator of ``series`` (K1 up to 4096
    nodes, K2 past them), against the segment operator, and one factor's
    launch (alpha = -c, beta = 1) against its row twin, on a run's panel
    V: {check: max_abs_err}."""
    from repro_torch.core import backend, operators
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.kernels.edge_spmm import ref as es_ref

    if rows is None:
        rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, g.num_nodes)
    one_hot = g.num_nodes <= backend.ONE_HOT_NODE_LIMIT
    name = "edge_spmm" if one_hot else "edge_spmm_nb"
    spmm = es_ops.edge_spmm_rows if one_hot else es_ops.edge_spmm_rows_nb
    return {
        "operator": _held(f"{label}: series operator vs segment", op(v),
                          operators.edge_series_operator(
                              g, series, backend="segment")(v))[0],
        name: _held(f"{label}: {name}", spmm(rows, v, -c, 1.0),
                    es_ref.edge_spmm_rows(rows.row_ptr, rows.other,
                                          rows.weight, v, -c, 1.0))[0]}


def _suite_runs(phase: str, g, suite: dict, methods, steps: int, k: int,
                dev) -> tuple[list, dict]:
    """Every (transform, method) of a figure from the seed-0 panel: rows,
    and the launches of the runs alone.  After each mu-EG run that stayed
    finite, K3 and K4 are held to their twins on its final panel."""
    import torch

    from repro_torch import parallel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.eg_update import ref as eg_ref

    v_star, init = _figure_start(g, k, dev)
    rows, runs = [], []
    for name, tf in suite.items():
        for method in methods:
            lr = 2e-2 if name == "identity" else 0.4
            reset_launch_counts()
            r = convergence_run(g, tf, method, lr, steps, k, v_star,
                                init_v=init, device=dev)
            runs.append(launch_counts())
            rows.append(_fig_row(name, method, r, _step_ms(r, method, lr)))
            if method == "mu_eg":
                v = r["state"].v
                av = r["operator"](v)
                # a diverged series (Taylor past d11) leaves no finite Gram
                if bool(torch.isfinite(eg_ref.gram2k(v, av)).all()):
                    rows[-1]["max_abs_err"] = _held_eg(f"{phase} {name}", v,
                                                       av, lr)
            emit({"phase": phase, "row": rows[-1]})
    return rows, parallel.sum_launches(runs)


def _row(rows, transform: str, method: str = "mu_eg") -> dict:
    return next(r for r in rows
                if r["transform"] == transform and r["method"] == method)


def mdp_phase(dev) -> dict:
    """Figs. 1-3 (bench_mdp.py): the s = 1 three-room MDP, the transform
    suite at degree 151 for mu-EG and Oja, the limit series' mu-EG run
    again from the panels of seeds 1 .. MDP_SEEDS - 1, limit_neg_exp(151)
    on K1 from the seed-0 panel, then the proto-value functions of s = 2
    through spectral_cluster.  K1, K3 and K4 are held to their twins on
    the K1 run's and the proto-value solve's final panels.  Returns the
    phase's launches."""
    import numpy as np

    from repro_torch import parallel
    from repro_torch.core import (ClusteringConfig, SolverConfig, clustering,
                                  graphs, limit_neg_exp, operators,
                                  spectral_cluster)
    from repro_torch.core import kmeans as km
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import launch_counts, reset_launch_counts

    g, _ = graphs.three_room_mdp(s=1, h=10, device=dev)
    rho = float(lap.spectral_radius_upper_bound(g))
    suite = paper_transform_suite(rho, degree=MDP_DEGREE)
    rows, counts_suite = _suite_runs("mdp", g, suite, ("mu_eg", "oja"),
                                     MDP_STEPS, MDP_K, dev)
    dense = _row(rows, "limit_neg_exp")
    # the limit series' mu-EG run from other draws' panels
    op_dense = dense_series_operator(lap.laplacian_dense(g),
                                     suite["limit_neg_exp"])
    sweep, counts_sweep = [dense["steps_to_1pct"]], []
    for seed in range(1, MDP_SEEDS):
        v_star, init_s = _figure_start(g, MDP_K, dev, seed=seed)
        reset_launch_counts()
        r_s = convergence_run(g, None, "mu_eg", 0.4, MDP_STEPS, MDP_K, v_star,
                              init_v=init_s, device=dev, operator=op_dense)
        counts_sweep.append(launch_counts())
        sweep.append(r_s["steps_to_1pct"])
    # the same limit series on the edge path (K1, captured), seed-0 panel
    v_star, init = _figure_start(g, MDP_K, dev)
    op_k1 = operators.edge_series_operator(g, limit_neg_exp(MDP_DEGREE),
                                           backend="kernel")
    reset_launch_counts()
    r_k1 = convergence_run(g, None, "mu_eg", 0.4, MDP_STEPS, MDP_K, v_star,
                           init_v=init, device=dev, operator=op_k1)
    counts_k1 = launch_counts()
    k1_row = _fig_row("limit_neg_exp (K1)", "mu_eg", r_k1,
                      _step_ms(r_k1, "mu_eg", 0.4))
    v = r_k1["state"].v
    k1_row["max_abs_err"] = {
        **_held_edge_path("mdp K1 run", g, limit_neg_exp(MDP_DEGREE), op_k1,
                          1.0 / MDP_DEGREE, v),
        **_held_eg("mdp K1 run", v, op_k1(v), 0.4)}
    # proto-value functions: examples/mdp_protovalues.py's solve and sign
    # check, on the s = 2 grid through the pipeline
    gp, rooms = graphs.three_room_mdp(s=2, h=10, device=dev)
    cfg = ClusteringConfig(
        num_clusters=3, degree=251,
        solver=SolverConfig(method="mu_eg", lr=0.4, steps=PVF_STEPS,
                            eval_every=50), seed=0)
    reset_launch_counts()
    (labels, info), pvf_s = host_s(lambda: spectral_cluster(gp, cfg))
    counts_pvf = launch_counts()
    eig = info["eigvecs"]
    fiedler = eig[:, 1].cpu().numpy()
    outer = np.where(rooms == 1, 0.0, np.sign(rooms - 1))
    corr = abs(float(np.corrcoef(np.sign(fiedler), outer)[0, 1]))
    s_pvf = clustering.build_series(cfg, info["rho_ub"])
    op_pvf = operators.edge_series_operator(gp, s_pvf, backend="kernel")
    pvf = {"n": gp.num_nodes, "num_edges": gp.num_edges, "k": eig.shape[1],
           "degree": 251, "solver_steps": PVF_STEPS, "seconds": pvf_s,
           "final_err": float(info["trace"].subspace_error[-1]),
           "agreement": float(km.cluster_agreement(labels, rooms, 3)),
           "sign_corr": corr,
           "max_abs_err": {
               **_held_edge_path("mdp proto-value solve", gp, s_pvf, op_pvf,
                                 cfg.dilation_strength / info["rho_ub"] / 251,
                                 eig),
               **_held_eg("mdp proto-value solve", eig, op_pvf(eig),
                          cfg.solver.lr)}}
    counts = parallel.sum_launches([counts_suite, *counts_sweep, counts_k1,
                                    counts_pvf])
    reached = sum(st >= 0 for st in sweep)
    emit({"phase": "mdp", "n": g.num_nodes, "num_edges": g.num_edges,
          "k": MDP_K, "degree": MDP_DEGREE, "steps": MDP_STEPS, "rho_ub": rho,
          "seeds_steps_to_1pct": sweep, "seeds_reached_1pct": reached,
          "k1_row": k1_row, "protovalue": pvf, "launches": counts})
    if reached < MDP_SEEDS_REACHED:
        raise AssertionError(
            f"mdp: mu-EG with limit_neg_exp(151) reached 1 % error from "
            f"{reached} of {MDP_SEEDS} panels (want {MDP_SEEDS_REACHED}): "
            f"{sweep}")
    for method in ("mu_eg", "oja"):
        if _row(rows, "identity", method)["steps_to_1pct"] >= 0:
            raise AssertionError(f"mdp: identity reached 1 % error ({method})")
    # the edge path follows the dense run from the same panel: both reach
    # 1 % within one eval interval of each other, or neither does
    k1_1pct, dense_1pct = k1_row["steps_to_1pct"], dense["steps_to_1pct"]
    if not ((k1_1pct < 0 and dense_1pct < 0) or (
            k1_1pct >= 0 and dense_1pct >= 0
            and abs(k1_1pct - dense_1pct) <= FIG_EVAL_EVERY)):
        raise AssertionError(f"mdp: K1 run to 1 % at {k1_1pct}, dense at "
                             f"{dense_1pct}")
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts[name] <= 0:
            raise AssertionError(f"mdp launched no {name}")
    return counts


def mdp_full_phase(dev) -> tuple[dict, dict]:
    """The grid world at full width: three_room_mdp(s = 59), n = 1,046,661,
    rows of at most 4 entries.  K2 on its row CSR against its twin, timed
    against its bound; spectral_cluster(transform="auto") for 10 steps,
    then the planned operator (K2), K3 and K4 held to their twins on the
    solve's k = 5 panel.  Returns (launches, K2's grid row for the kernels
    line)."""
    import torch

    from repro_torch import spectral
    from repro_torch.core import (ClusteringConfig, SolverConfig, graphs,
                                  operators, solvers, spectral_cluster)
    from repro_torch.core import kmeans as km
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.kernels.edge_spmm import ref as es_ref

    (g, rooms), gen_s = host_s(lambda: graphs.three_room_mdp(
        s=MDP_FULL_S, h=10, device=dev))
    n, e, k = g.num_nodes, g.num_edges, 10
    rows = es_ops.build_edge_rows(g.src, g.dst, g.weight, n)
    rows_ms = cuda_ms(lambda: es_ops.build_edge_rows(g.src, g.dst, g.weight,
                                                     n), 3)
    longest = int((rows.row_ptr[1:] - rows.row_ptr[:-1]).max())
    hub_rows = int((rows.hub_rows < n).sum())
    rho = float(lap.spectral_radius_upper_bound(g))
    c = 8.0 / rho / 251
    v = solvers.init_state(torch.Generator(device=dev).manual_seed(8), n, k).v

    def k2():
        return es_ops.edge_spmm_rows_nb(rows, v, -c, 1.0)

    got = k2()
    errs = {}
    for label, plain in (
            ("row twin", lambda: es_ref.edge_spmm_rows(
                rows.row_ptr, rows.other, rows.weight, v, -c, 1.0)),
            ("edge-list twin", lambda: es_ref.edge_spmm_affine(
                g.src, g.dst, g.weight, v, -c, 1.0))):
        want = plain()
        errs[label] = (float((got - want).abs().max()),
                       REL_TOL * float(want.abs().max()))
        if not errs[label][0] <= errs[label][1]:
            raise AssertionError(f"edge_spmm_nb (grid, {label}): max_abs_err "
                                 f"{errs[label]}")
    del got, want
    b_ms, b_by = bound(e * 12 + 2 * n * k * 4, 2 * e * k * 2 + 4 * n * k)
    grid = {"n": n, "num_edges": e, "k": k,
            "max_abs_err": errs["row twin"][0],
            "edge_list_twin_max_abs_err": errs["edge-list twin"][0],
            "tolerance": errs["row twin"][1], "ms": cuda_ms(k2, 20),
            "graph_ms": graph_ms(k2),
            "bound_ms": b_ms, "bound_by": b_by, "longest_row": longest,
            "hub_rows": hub_rows, "hub_threshold": es_ops.HUB_THRESHOLD,
            "bitwise_repeatable": bool(torch.equal(k2(), k2())),
            "row_csr_build_ms": rows_ms}
    emit({"phase": "mdp_full_k2", **grid})
    if not grid["bitwise_repeatable"]:
        raise AssertionError("edge_spmm_nb on the grid: two calls differ")
    if hub_rows != 0:
        raise AssertionError(f"the grid has {hub_rows} hub rows, want 0")
    del v
    cfg = ClusteringConfig(num_clusters=3, transform="auto", degree=251,
                           solver=SolverConfig(steps=10, eval_every=10),
                           seed=0)
    k_solve = 5  # num_clusters + extra_eigvecs + the trivial vector
    _, probe_s = host_s(lambda: spectral.probe_and_plan(
        g, k=k_solve, generator=torch.Generator(device=dev).manual_seed(3),
        budget=251))
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()  # earlier phases' tensors
    reset_launch_counts()
    (labels, info), solve_s = host_s(lambda: spectral_cluster(g, cfg))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = info["plan"]
    eig = info["eigvecs"]
    if not (labels.shape == (n,) and eig.shape == (n, k_solve)
            and bool(torch.isfinite(eig).all())
            and int(labels.min()) >= 0 and int(labels.max()) < 3):
        raise AssertionError("mdp_full gave malformed output")
    series = spectral.series_from_plan(plan)
    op = operators.edge_series_operator(g, series, backend="kernel")
    st = solvers.init_from_panel(eig)
    lr = plan.suggested_lr(cfg.solver.lr)
    step_fn = solvers.make_step_fn("mu_eg", "kernel", dev)
    step_ms = cuda_ms(lambda: step_fn(st, op(st.v), lr), 3)
    held = {**_held_edge_path("mdp_full solve", g, series, op,
                              plan.scale / plan.degree, eig, rows=rows),
            **_held_eg("mdp_full solve", eig, op(eig), lr)}
    del rows
    emit({"phase": "mdp_full", "s": MDP_FULL_S, "n": n, "num_edges": e,
          "k": k_solve, "budget": 251, "solver_steps": 10,
          "graph_host_s": gen_s, "probe_s": probe_s,
          "plan": {"family": plan.family, "degree": plan.degree,
                   "tau": plan.tau, "rho": plan.rho, "gamma": plan.gamma,
                   "lam_k": plan.lam_k, "lam_k1": plan.lam_k1},
          "rho_ub": rho, "spectral_cluster_s": solve_s,
          "solver_step_ms": step_ms, "hub_rows": hub_rows,
          "max_memory_allocated": peak,
          "memory_allocated_at_start": start_bytes,
          "agreement": float(km.cluster_agreement(labels, rooms, 3)),
          "max_abs_err": held, "k2": grid, "launches": counts})
    for name in ("edge_spmm", "edge_spmm_nb", "gram2k", "panel_mix"):
        if counts[name] <= 0:
            raise AssertionError(f"mdp_full launched no {name}")
    return counts, grid


def cliques_phase(dev) -> dict:
    """Fig. 4 (bench_cliques.py): clique_graph(300, 3) and (400, 4), the
    suite at degree 251, mu-EG, 1200 steps."""
    from repro_torch import parallel
    from repro_torch.core import graphs
    from repro_torch.core import laplacian as lap

    out, runs = {}, []
    for n_c, k_c in CLIQUE_GRAPHS:
        g, _ = graphs.clique_graph(n_c, k_c, seed=0, device=dev)
        rho = float(lap.spectral_radius_upper_bound(g))
        rows, counts = _suite_runs(f"cliques_n{n_c}_k{k_c}", g,
                                   paper_transform_suite(rho), ("mu_eg",),
                                   CLIQUE_STEPS, k_c, dev)
        out[f"n{n_c}_k{k_c}"] = {"rho_ub": rho, "num_edges": g.num_edges}
        runs.append(counts)
        if _row(rows, "limit_neg_exp")["steps_to_streak"] < 0:
            raise AssertionError(f"cliques n{n_c}_k{k_c}: limit_neg_exp "
                                 "reached no full streak")
        if _row(rows, "identity")["steps_to_streak"] >= 0:
            raise AssertionError(f"cliques n{n_c}_k{k_c}: identity reached a "
                                 "full streak")
    counts = parallel.sum_launches(runs)
    emit({"phase": "cliques", "steps": CLIQUE_STEPS, "degree": 251,
          "graphs": out, "launches": counts})
    return counts


def series_degree_phase(dev) -> dict:
    """Fig. 6 (bench_series_degree.py): ten series on clique_graph(300, 3),
    k = 3, mu-EG, 900 steps."""
    from repro_torch.core import (cheb_neg_exp, graphs, limit_neg_exp,
                                  taylor_neg_exp)
    from repro_torch.core import laplacian as lap

    g, _ = graphs.clique_graph(300, 3, seed=0, device=dev)
    rho = float(lap.spectral_radius_upper_bound(g))
    suite = {}
    for d in (11, 51, 151, 251):
        suite[f"limit_neg_exp_d{d}"] = limit_neg_exp(d)
        suite[f"taylor_neg_exp_d{d}"] = taylor_neg_exp(d)
    suite["limit_d51_scaled(beyond)"] = limit_neg_exp(51, scale=8.0 / rho)
    suite["cheb_d16(beyond)"] = cheb_neg_exp(16, rho=rho, tau=8.0 / rho)
    # every series takes mu-EG's lr 0.4, as in the bench (no identity row)
    rows, counts = _suite_runs("series_degree", g, suite, ("mu_eg",),
                               SERIES_STEPS, 3, dev)
    emit({"phase": "series_degree", "steps": SERIES_STEPS, "rho_ub": rho,
          "launches": counts})
    for d in (151, 251):
        if _row(rows, f"limit_neg_exp_d{d}")["steps_to_streak"] < 0:
            raise AssertionError(f"series_degree: limit d{d} reached no "
                                 "full streak")
    for d in (11, 51):
        if _row(rows, f"limit_neg_exp_d{d}")["steps_to_streak"] >= 0:
            raise AssertionError(f"series_degree: limit d{d} reached a "
                                 "full streak")
    return counts


def transforms_phase(dev) -> dict:
    """Table 2 (bench_transforms.py): ratio and dilation per transform on
    the synthetic spectrum; the apply at n = 512, k = 8 per transform, and
    for both degree-251 limit rows the apply through K5
    (limit_series_apply) held to the series apply."""
    import torch

    from repro_torch.core import operators
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.laplacian_poly import ops as lp_ops

    ratios = table2_ratios(dev)
    rho = 60.0  # the synthetic spectrum's top
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((TABLE2_N, TABLE2_N), generator=gen, device=dev) \
        / TABLE2_N ** 0.5
    l_mat = a @ a.T * (rho / 4)
    v = torch.randn((TABLE2_N, TABLE2_PANEL), generator=gen, device=dev)
    suite = table2_suite(rho)
    scales = {"limit_neg_exp_d251": 1.0, "limit_neg_exp_d251_s8": 8.0 / rho}
    reset_launch_counts()
    k5_out = {name: lp_ops.limit_series_apply(l_mat, v, degree=251,
                                              scale=sc)
              for name, sc in scales.items()}
    counts = launch_counts()
    for name, s in suite.items():
        op = dense_series_operator(l_mat, s)
        ratio, dil = ratios[name]
        row = {"transform": name, "ratio": ratio, "dilation_x": dil,
               "apply_ms": cuda_ms(lambda: op(v), 10)}
        if name in scales:
            want = s.apply(operators.dense_matvec(l_mat), v)
            err = float((k5_out[name] - want).abs().max())
            tol = DENSE_TOL * float(want.abs().max())
            if not err <= tol:
                raise AssertionError(f"transforms {name}: K5 apply off the "
                                     f"series by {err} > {tol}")
            row.update(k5_apply_ms=cuda_ms(lambda: lp_ops.limit_series_apply(
                l_mat, v, degree=251, scale=scales[name]), 10),
                k5_max_abs_err=err, k5_tolerance=tol)
        emit({"phase": "transforms", "row": row})
    emit({"phase": "transforms", "n": TABLE2_N, "k": TABLE2_PANEL,
          "spectrum_k": TABLE2_K, "launches": counts})
    if counts["poly_step"] != 2 * 251:
        raise AssertionError(f"transforms launched poly_step "
                             f"{counts['poly_step']} times, not {2 * 251}")
    return counts


def linkpred_phase(dev) -> dict:
    """Fig. 5 (bench_linkpred.py): clique_graph(300, 3, seed=1) with 20 %
    of its edges dropped and predicted back by common neighbours
    (weighted), the suite, mu-EG, 1000 steps."""
    from repro_torch.core import graphs, linkpred
    from repro_torch.core import laplacian as lap

    g, _ = graphs.clique_graph(300, 3, seed=1, device=dev)
    gw = linkpred.complete_graph(g, drop_prob=0.2, seed=2)
    rho = float(lap.spectral_radius_upper_bound(gw))
    rows, counts = _suite_runs("linkpred", gw, paper_transform_suite(rho),
                               ("mu_eg",), LINKPRED_STEPS, 3, dev)
    emit({"phase": "linkpred", "steps": LINKPRED_STEPS, "rho_ub": rho,
          "num_edges": gw.num_edges, "launches": counts})
    if _row(rows, "limit_neg_exp")["steps_to_streak"] < 0:
        raise AssertionError("linkpred: limit_neg_exp reached no full streak")
    return counts


def walks_paper_phase(dev) -> dict:
    """Sec. 4.3 (bench_walks.py): 20,000 walks of length 3 on
    clique_graph(200, 4): walks/s, the L^2 estimate's relative error by
    importance weighting and by the paper's rejection coin, and the
    coin's mean acceptance."""
    import math

    import torch

    from repro_torch.core import graphs, walks
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import launch_counts, reset_launch_counts

    g, _ = graphs.clique_graph(200, 4, seed=0, device=dev)
    inc, inc_s = host_s(lambda: lap.build_edge_incidence(g))
    l_mat = lap.laplacian_dense(g)
    want = l_mat @ l_mat
    gen = torch.Generator(device=dev).manual_seed(0)
    sample_ms = cuda_ms(lambda: walks.sample_walks(gen, inc, WALKS_PAPER_W, 3),
                        5)
    reset_launch_counts()
    wb = walks.sample_walks(torch.Generator(device=dev).manual_seed(1), inc,
                            WALKS_PAPER_W, 3)
    rel, est_ms = {}, {}
    ones = torch.ones((g.num_nodes, 8), device=dev)
    for mode in ("importance", "rejection"):
        coin = torch.Generator(device=dev).manual_seed(2)
        est = walks.estimate_power_dense(wb, g, inc, 2, g.num_nodes,
                                         mode=mode, generator=coin)
        rel[mode] = float(torch.linalg.norm(est - want)
                          / torch.linalg.norm(want))
        est_ms[mode] = cuda_ms(lambda m=mode: walks.estimate_power_matvec(
            wb, g, inc, 2, ones, mode=m, generator=coin), 10)
    counts = launch_counts()
    log_pmin = -2 * math.log(inc.deg_star_inc) - math.log(g.num_edges)
    p_acc = torch.exp(torch.clamp(log_pmin - wb.logp[:, 1], max=0.0))
    emit({"phase": "walks_paper", "n": g.num_nodes, "num_edges": g.num_edges,
          "walks": WALKS_PAPER_W, "length": 3, "incidence_host_s": inc_s,
          "sample_ms": sample_ms,
          "walks_per_s": WALKS_PAPER_W / sample_ms * 1e3,
          "rel_err": rel, "estimate_ms": est_ms,
          "mean_acceptance": float(p_acc.mean()), "launches": counts})
    if not rel["importance"] < rel["rejection"]:
        raise AssertionError(f"walks_paper: importance {rel['importance']} "
                             f"does not beat rejection {rel['rejection']}")
    return counts


def _lm_view(model, depth=None, cfg=None):
    """A Model sharing ``model``'s parameters, cut to its first ``depth``
    layers and/or with another config (the cache dtype, the MoE
    capacity), which its blocks then read too.  A hybrid's view keeps its
    blocks and runs the groups that ``depth`` layers hold."""
    import copy

    import torch

    view = copy.copy(model)
    view._modules = dict(model._modules)
    if "layers" not in model._modules:  # the hybrid: its schedule reads cfg
        view.cfg = dataclasses.replace(cfg or model.cfg, num_layers=(
            depth or model.cfg.num_layers))
        return view
    layers = list(model.layers if depth is None else model.layers[:depth])
    if cfg is not None:
        blocks = []
        for block in layers:
            blocks.append(copy.copy(block))
            blocks[-1]._modules = dict(block._modules)
            blocks[-1].cfg = cfg
        layers = blocks
    cfg = cfg or model.cfg
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    view._modules["layers"] = torch.nn.ModuleList(layers)
    view.cfg = cfg
    return view


def _bar_use(got, want, tol: float) -> float:
    """max |got - want| / (tol + tol |want|): <= 1 is within the bar."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _argmax_decided(got, want, tol: float) -> tuple[int, int]:
    """(rows whose argmax differs although JAX-style bar decides it, rows
    whose top two logits are further apart than twice the bar)."""
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * (tol + tol * top2[:, 0].abs())
    differ = got.argmax(-1) != want.argmax(-1)
    return int((differ & decided).sum()), int(decided.sum())


def _device_busy(fn) -> dict:
    """fn's device kernels under torch.profiler: their summed time (ms)
    and count (None where the profiler saw no device time), and the
    five that took longest in all, each with its ms and calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_ms": busy_us / 1e3 if busy_us else None,
            "kernels": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}


def _lm_decode_gap(model, batch, out, steps: int) -> dict:
    """Hold (b)'s reading: the first ``steps`` decode steps' logits of
    the generation ``out`` against the last-position logits of a prefill
    over prompt + generated tokens."""
    import torch

    use, err, flips, decided = 0.0, 0.0, 0, 0
    for i in range(1, steps + 1):
        ref, _ = model.prefill({**batch, "tokens": torch.cat(
            [batch["tokens"], out.tokens[:, :i].int()], dim=1)})
        use = max(use, _bar_use(out.logits[i], ref, LM_BF16_TOL))
        err = max(err, float((out.logits[i] - ref).abs().max()))
        f, d = _argmax_decided(out.logits[i], ref, LM_BF16_TOL)
        flips, decided = flips + f, decided + d
    return {"depth": model.cfg.num_layers, "bar_use": use,
            "max_abs_err": err, "argmax_flips_decided": flips,
            "rows_decided": decided, "rows": steps * batch["tokens"].shape[0]}


def _lm_routing(model) -> list:
    """Each MoE layer's last routing, a (tokens, top_k) set per token
    (sorted expert ids) on the CPU; [] for a dense model."""
    return [blk.moe_stats.expert_ids.sort(dim=-1).values.cpu()
            for blk in model._modules.get("layers", ())
            if blk.moe_stats is not None]


def _routing_agreement(a: list, b: list) -> float | None:
    """The share of (call, layer, token) routings equal in a and b."""
    same = [bool(x) for ra, rb in zip(a, b) for la, lb in zip(ra, rb)
            for x in (la == lb).all(-1)]
    return sum(same) / len(same) if same else None


def _lm_smoke_run(cfg, tree, where, prompt, loss_b, steps: int, depth=None,
                  fed=None) -> dict:
    """One smoke-size run on ``where`` from the numpy tree: the prefill's
    and ``steps`` decode steps' logits (fed ``fed``'s tokens, else its
    own argmax), the routing of every call, the loss (its first
    ``depth`` layers where given)."""
    import torch

    from repro_torch import convert

    m = convert.lm_params_from_numpy(cfg, tree, device=where)
    if depth is not None:
        m = _lm_view(m, depth)
    s = prompt["tokens"].shape[1]
    logits, st = m.prefill({k: v.to(where) for k, v in prompt.items()},
                           max_seq=s + steps)
    seq, routes = [logits.cpu()], [_lm_routing(m)]
    for t in range(steps):
        tok = fed[t] if fed is not None else seq[-1].argmax(-1, keepdim=True)
        logits, st = m.decode_step(st, tok.to(where))
        seq.append(logits.cpu())
        routes.append(_lm_routing(m))
    with torch.no_grad():
        loss = float(m.train_loss({k: v.to(where)
                                   for k, v in loss_b.items()})[0])
    return {"logits": seq, "routes": routes, "loss": loss,
            "fed": [x.argmax(-1, keepdim=True) for x in seq[:-1]]}


def _lm_card_vs_cpu(dev, arch: str, decode_depth=None) -> dict:
    """Hold (c): smoke_config(arch) from one set of numpy weights on the
    card and on the CPU, in f32 (COMPUTE_DTYPE patched) and bf16:
    prefill, LM_SMOKE's decode steps fed the CPU's argmax, the loss, and
    for MoE the routing agreement (enc-dec: over the same stub frames).  With ``decode_depth``, bf16's decode
    steps are held at that many layers (the whole depth's printed)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.models import layers
    from repro_torch.models.frontends import synthetic_frontend

    cfg = smoke_config(get_arch(arch))
    tree = convert.lm_params_to_numpy(Model(
        cfg, "cpu", torch.Generator().manual_seed(LM_SEED + 1)))
    b, s, steps = LM_SMOKE
    prompt = TokenPipeline(cfg.vocab_size, b, s, LM_SEED).batch_at(3, "cpu")
    loss_b = TokenPipeline(cfg.vocab_size, *LM_SMOKE_LOSS,
                           LM_SEED).batch_at(4, "cpu")
    # the stub frames of an enc-dec config, drawn on the CPU
    frames = torch.Generator().manual_seed(LM_SEED + 2)
    prompt.update(synthetic_frontend(frames, cfg, b))
    loss_b.update(synthetic_frontend(frames, cfg, LM_SMOKE_LOSS[0]))
    out, failed = {"arch": cfg.name}, []
    for mode, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        saved, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, dtype
        try:
            cpu = _lm_smoke_run(cfg, tree, "cpu", prompt, loss_b, steps)
            card = _lm_smoke_run(cfg, tree, dev, prompt, loss_b, steps,
                                 fed=cpu["fed"])
            cut = None
            if mode == "bf16" and decode_depth is not None:
                cut_cpu = _lm_smoke_run(cfg, tree, "cpu", prompt, loss_b,
                                        steps, depth=decode_depth)
                cut = (cut_cpu, _lm_smoke_run(
                    cfg, tree, dev, prompt, loss_b, steps,
                    depth=decode_depth, fed=cut_cpu["fed"]))
        finally:
            layers.COMPUTE_DTYPE = saved
        row = {"prefill_err": float((card["logits"][0] - cpu["logits"][0])
                                    .abs().max()),
               "decode_err": max(float((a - c).abs().max()) for a, c in
                                 zip(card["logits"][1:], cpu["logits"][1:])),
               "loss_err": abs(card["loss"] - cpu["loss"]),
               "routing_agreement": _routing_agreement(card["routes"],
                                                       cpu["routes"])}
        if mode == "f32":
            ok = (row["prefill_err"] <= LM_F32_TOL
                  and row["decode_err"] <= LM_DECODE_F32_TOL
                  and row["loss_err"] <= LM_F32_TOL)
        else:
            def uses(got, want):
                return [_bar_use(a, c, LM_BF16_TOL) for a, c in
                        zip(got["logits"], want["logits"])]

            def flips(got, want):
                return sum(_argmax_decided(a, c, LM_BF16_TOL)[0]
                           for a, c in zip(got["logits"], want["logits"]))

            full = uses(card, cpu)
            row["bar_use"] = max(full)
            row["loss_bar_use"] = row["loss_err"] / (
                LM_BF16_TOL + LM_BF16_TOL * abs(cpu["loss"]))
            row["argmax_flips_decided"] = flips(card, cpu)
            held = [full[0]]
            if cut is None:
                held += full[1:]
            else:
                cut_uses = uses(cut[1], cut[0])
                held += cut_uses[1:]
                row["decode_depth"] = decode_depth
                row["decode_bar_use_at_depth"] = max(cut_uses[1:])
                row["argmax_flips_decided_at_depth"] = flips(cut[1], cut[0])
                row["routing_agreement_at_depth"] = _routing_agreement(
                    cut[1]["routes"], cut[0]["routes"])
            row["held_bar_use"] = max(held)
            decided_flips = (row["argmax_flips_decided"] if cut is None
                             else _argmax_decided(card["logits"][0],
                                                  cpu["logits"][0],
                                                  LM_BF16_TOL)[0]
                             + row["argmax_flips_decided_at_depth"])
            ok = (row["held_bar_use"] <= 1.0 and row["loss_bar_use"] <= 1.0
                  and decided_flips == 0)
        out[mode] = row
        if not ok:
            failed.append(f"hold (c) {cfg.name} {mode}: card vs CPU {row}")
    out["failed"] = failed
    return out


def lm_serve_phase(dev, gpu: str) -> dict:
    """The LM substrate's serving path at qwen3-4b full width and depth
    (36 layers, d_model 2560, 32/8 heads of 80, d_ff 9728, vocab 151936),
    f32 weights drawn on the card from a seeded generator, through
    launch.serve.generate: run 1 (TokenPipeline prompts, bf16 cache),
    run 2 (chunked attention), the int8-cache variant of run 1, one
    train_loss forward; holds (a) finite, (b) decode against prefill,
    (c) card against CPU at smoke size.  Returns the launch counts of the
    port's kernels over the phase (none runs on this path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model

    cfg = get_arch(LM_ARCH)
    reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    model, init_s = host_s(lambda: Model(
        cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = 2 * cfg.vocab_size * cfg.d_model
    weight_bytes = 4 * n_params

    def prompt(b, s, step):
        return {"tokens": TokenPipeline(cfg.vocab_size, b, s, LM_SEED)
                .batch_at(step, dev)["tokens"]}

    def prefill_bound_ms(tokens):
        return 2 * (n_params - n_embed) * tokens / PEAK_BF16_FLOPS * 1e3

    b1, s1, g1 = LM_RUN1
    batch1 = prompt(b1, s1, 0)
    generate(model, batch1, 2)  # warm-up: cuBLAS handles, allocator
    run1 = generate(model, batch1, g1)

    # hold (b): decode vs prefill at each depth; the full depth from run 1
    gaps = []
    for depth in LM_GAP_DEPTHS:
        if depth == cfg.num_layers:
            gaps.append(_lm_decode_gap(model, batch1, run1, LM_HOLD_STEPS))
            continue
        view = _lm_view(model, depth)
        gaps.append(_lm_decode_gap(view, batch1, generate(
            view, batch1, LM_HOLD_STEPS), LM_HOLD_STEPS))
        del view
    emit({"phase": "lm_serve_gap", "bar": LM_BF16_TOL, "gaps": gaps,
          "asserted_depth": LM_HOLD_DEPTH})

    # device busy time of one prefill and one decode step (the profiler's
    # own host cost leaves the kernels' times as they are)
    _, st = model.prefill(batch1, max_seq=s1 + 2)
    tok = torch.zeros((b1, 1), dtype=torch.int64, device=dev)
    model.decode_step(st, tok)
    busy = {"prefill": _device_busy(lambda: model.prefill(batch1)),
            "decode_step": _device_busy(lambda: model.decode_step(st, tok))}
    del st

    b2, s2, g2 = LM_RUN2
    batch2 = prompt(b2, s2, 1)
    run2 = generate(model, batch2, g2)
    int8_model = _lm_view(model, cfg=dataclasses.replace(
        cfg, kv_cache_dtype="int8"))
    run3 = generate(int8_model, batch1, LM_INT8_STEPS)
    agree = float((run3.tokens == run1.tokens[:, :LM_INT8_STEPS]).float()
                  .mean())
    loss_batch = TokenPipeline(cfg.vocab_size, *LM_LOSS,
                               LM_SEED).batch_at(2, dev)
    with torch.no_grad():
        loss, loss_s = host_s(lambda: float(model.train_loss(loss_batch)[0]))
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()

    # hold (a): generate raises on a non-finite logit; the loss here
    if not math.isfinite(loss):
        raise AssertionError(f"lm_serve: loss {loss}")
    hold_b = next(g for g in gaps if g["depth"] == LM_HOLD_DEPTH)
    if not hold_b["bar_use"] <= 1.0:
        raise AssertionError(f"lm_serve hold (b) at depth {LM_HOLD_DEPTH}: "
                             f"{hold_b}")

    def run_row(run, b, s, g):
        return {"batch": b, "prompt": s, "steps": g,
                "prefill_ms": run.prefill_ms,
                "prefill_bound_ms": prefill_bound_ms(b * s),
                "decode_ms_per_step": run.decode_ms / g,
                "tok_per_s": g * b / run.decode_ms * 1e3}

    row = {"phase": "lm_serve", "arch": LM_ARCH, "layers": cfg.num_layers,
           "params": n_params, "param_count_cfg": cfg.param_count(),
           "weight_bytes": weight_bytes, "init_s": init_s,
           "decode_bound_ms": weight_bytes / PEAK_BYTES_PER_S * 1e3,
           "run1": run_row(run1, b1, s1, g1),
           "run2_chunked": run_row(run2, b2, s2, g2),
           "run3_int8": {**run_row(run3, b1, s1, LM_INT8_STEPS),
                         "token_agreement_with_bf16": agree},
           "loss": loss, "ln_vocab": math.log(cfg.vocab_size),
           "loss_s": loss_s, "peak_bytes": peak,
           "peak_bytes_before_phase": base_bytes,
           "hold_b": {"depth": LM_HOLD_DEPTH, **hold_b}}
    for name, ms in (("prefill", row["run1"]["prefill_ms"]),
                     ("decode_step", row["run1"]["decode_ms_per_step"])):
        dev_ms = busy[name]["device_ms"]
        busy[name]["idle_share"] = None if dev_ms is None else 1 - dev_ms / ms
    row["run1"]["profiled"] = busy
    del run1, run2, run3, model, int8_model
    gc.collect()
    torch.cuda.empty_cache()
    row["hold_c"] = _lm_card_vs_cpu(dev, LM_ARCH)
    emit({**row, "gpu": gpu, "launches": counts})
    if row["hold_c"]["failed"]:
        raise AssertionError(f"lm_serve: {row['hold_c']['failed']}")
    return counts


def _lm_moe_decode_gap(model, batch, steps: int) -> dict:
    """Hold (b) for a MoE model: ``steps`` greedy decode steps after a
    prefill of ``batch``, each step's logits against the last-position
    logits of a prefill over prompt + the tokens fed so far.  Each MoE
    layer's routing of every position in that reference is compared with
    the routing that built the decode's state (the first prefill's for
    the prompt, the steps' own after it): a row is clean while all of
    them agree, and the bar is read over all rows and over the clean
    ones (a flip routes a token to other experts, another function)."""
    import torch

    toks = batch["tokens"]
    b, s = toks.shape
    logits, st = model.prefill(batch, max_seq=s + steps)
    seen = [r.reshape(b, s, -1) for r in _lm_routing(model)]
    clean = torch.ones(b, dtype=torch.bool)
    use, use_clean, err, flips, decided = 0.0, 0.0, 0.0, 0, 0
    route_flips, routed, dropped = 0, 0, 0
    fed = [logits.argmax(-1, keepdim=True)]
    for i in range(steps):
        step, _ = model.decode_step(st, fed[-1])
        seen = [torch.cat([h, d[:, None]], dim=1)
                for h, d in zip(seen, _lm_routing(model))]
        ref, _ = model.prefill({"tokens": torch.cat([toks] + [
            f.to(toks.dtype) for f in fed], dim=1)})
        dropped += sum(int(blk.moe_stats.dropped) for blk in model.layers)
        for h, p in zip(seen, _lm_routing(model)):
            same = (h == p.reshape(b, s + i + 1, -1)).all(-1)
            route_flips += int((~same).sum())
            routed += same.numel()
            clean &= same.all(-1)
        use = max(use, _bar_use(step, ref, LM_BF16_TOL))
        if clean.any():
            rows = clean.to(step.device)
            use_clean = max(use_clean, _bar_use(step[rows], ref[rows],
                                                LM_BF16_TOL))
        err = max(err, float((step - ref).abs().max()))
        f, d = _argmax_decided(step, ref, LM_BF16_TOL)
        flips, decided = flips + f, decided + d
        fed.append(step.argmax(-1, keepdim=True))
    return {"depth": len(model.layers), "bar_use": use,
            "bar_use_clean_rows": use_clean,
            "clean_rows": int(clean.sum()), "max_abs_err": err,
            "argmax_flips_decided": flips, "rows_decided": decided,
            "rows": steps * b, "routing_flips": route_flips,
            "routings": routed, "capacity_factor": model.cfg.capacity_factor,
            "dropped_pairs_in_references": dropped}


def _lm_moe_serve(dev, cfg, run1, run2, loss_shape, gap_depths) -> dict:
    """One MoE configuration through launch.serve.generate on the card
    (f32 weights drawn from LM_SEED): run 1 (bf16 cache) with the dropped
    pairs per layer of its prefill and a second prefill compared bitwise
    (hold (e)), hold (b) at each of ``gap_depths``, the profiler's busy
    time of one prefill and one decode step, run 2 where given, one
    train_loss forward; the bounds; the model for the caller to free."""
    import math

    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.models import layers
    from repro_torch.models.moe import capacity

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    model, init_s = host_s(lambda: Model(
        cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    n_active = cfg.active_param_count()
    n_embed = 2 * cfg.vocab_size * cfg.d_model

    def prompt(b, s, step):
        return {"tokens": TokenPipeline(cfg.vocab_size, b, s, LM_SEED)
                .batch_at(step, dev)["tokens"]}

    def run_row(run, b, s, g):
        return {"batch": b, "prompt": s, "steps": g,
                "prefill_ms": run.prefill_ms,
                "prefill_bound_ms": 2 * (n_active - n_embed) * b * s
                / PEAK_BF16_FLOPS * 1e3,
                "decode_ms_per_step": run.decode_ms / g,
                "tok_per_s": g * b / run.decode_ms * 1e3}

    b1, s1, g1 = run1
    batch1 = prompt(b1, s1, 0)
    generate(model, batch1, 2)  # warm-up: cuBLAS handles, allocator
    out1 = generate(model, batch1, g1)
    again, st = model.prefill(batch1, max_seq=s1 + g1)
    dropped = [int(blk.moe_stats.dropped) for blk in model.layers]
    bitwise = bool(torch.equal(again, out1.logits[0]))
    del st

    # hold (b) at a capacity that cannot bind (every token may route to
    # one expert), where prefill and decode compute the same function;
    # at the config's own capacity the references' prefills drop pairs
    # (the last positions first), which decode never does
    dropless = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    gaps = [_lm_moe_decode_gap(_lm_view(model, depth, dropless), batch1,
                               LM_HOLD_STEPS) for depth in gap_depths]
    gap_own = _lm_moe_decode_gap(model, batch1, LM_HOLD_STEPS)
    # the same at the whole depth in f32 (COMPUTE_DTYPE patched; the
    # cache stays bf16): what bf16's rounding adds
    saved, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, torch.float32
    try:
        gap_f32 = _lm_moe_decode_gap(_lm_view(model, cfg=dropless), batch1,
                                     LM_HOLD_STEPS)
    finally:
        layers.COMPUTE_DTYPE = saved

    _, st = model.prefill(batch1, max_seq=s1 + 2)
    tok = torch.zeros((b1, 1), dtype=torch.int64, device=dev)
    model.decode_step(st, tok)
    busy = {"prefill": _device_busy(lambda: model.prefill(batch1)),
            "decode_step": _device_busy(lambda: model.decode_step(st, tok))}
    del st

    row = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "param_count_cfg": cfg.param_count(), "active_params": n_active,
           "weight_bytes": 4 * n_params, "init_s": init_s,
           "decode_bound_ms": 4 * n_params / PEAK_BYTES_PER_S * 1e3,
           "decode_bound_active_ms": 4 * n_active / PEAK_BYTES_PER_S * 1e3,
           "capacity_prefill": capacity(b1 * s1, cfg),
           "capacity_decode": capacity(b1, cfg),
           "dropped_pairs_prefill": dropped,
           "pairs_prefill": b1 * s1 * cfg.moe_top_k,
           "run1": run_row(out1, b1, s1, g1),
           "hold_e_prefill_bitwise": bitwise, "gaps": gaps,
           "gap_own_capacity": gap_own, "gap_f32": gap_f32}
    for name, ms in (("prefill", row["run1"]["prefill_ms"]),
                     ("decode_step", row["run1"]["decode_ms_per_step"])):
        dev_ms = busy[name]["device_ms"]
        busy[name]["idle_share"] = None if dev_ms is None else 1 - dev_ms / ms
    row["run1"]["profiled"] = busy
    if run2 is not None:
        b2, s2, g2 = run2
        row["run2_chunked"] = run_row(generate(model, prompt(b2, s2, 1), g2),
                                      b2, s2, g2)
    loss_batch = TokenPipeline(cfg.vocab_size, *loss_shape,
                               LM_SEED).batch_at(2, dev)
    with torch.no_grad():
        (loss, parts), loss_s = host_s(lambda: model.train_loss(loss_batch))
    row.update(loss=float(loss), xent=float(parts["xent"]),
               aux=float(parts["aux"]), ln_vocab=math.log(cfg.vocab_size),
               loss_shape=list(loss_shape), loss_s=loss_s,
               peak_bytes=torch.cuda.max_memory_allocated(),
               peak_bytes_before=base_bytes)
    return row, model


def _lm_mla_absorption(cfg, attn_params, dev) -> dict:
    """Hold (d): one full-width MLA layer's absorbed decode over
    LM_MLA_ABSORB positions against its train attention, in f32 (the
    latent cache bf16, as always)."""
    import torch

    from repro_torch.models import attention

    b, s = LM_MLA_ABSORB
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.1
    with torch.no_grad():
        train, _ = attention.mla_train(attn_params, cfg, x)
        cache = attention.init_mla_cache(cfg, b, s, dev)
        steps = []
        for t in range(s):
            o, cache = attention.mla_decode(attn_params, cfg, x[:, t:t + 1],
                                            cache)
            steps.append(o)
        dec = torch.cat(steps, dim=1)
    err = (dec - train).abs()
    use = float((err / (LM_MLA_ATOL + LM_MLA_RTOL * train.abs())).max())
    return {"positions": s, "max_abs_err": float(err.max()),
            "max_abs_train": float(train.abs().max()), "bar_use": use,
            "rtol": LM_MLA_RTOL, "atol": LM_MLA_ATOL}


def lm_moe_phase(dev, gpu: str) -> dict:
    """The LM substrate's MoE serving path: granite-moe-1b-a400m at full
    width and depth (24 layers, d_model 1024, 16/8 heads, 32 experts
    top-8 of width 512, vocab 49,155), then deepseek-v2-236b at full width
    (d_model 5120, 128 heads of 128 + rope 64, kv_lora 512, 160 routed
    experts top-6 of width 1536 + 2 shared, vocab 102,400) cut to
    LM_MLA_DEPTH layers; both drawn on the card from a seeded generator,
    f32, through launch.serve.generate.  Holds (a) finite, (b) decode
    against prefill (asserted for granite at LM_MOE_HOLD_DEPTH), (c) card
    against CPU at both smoke configs, (d) MLA absorption at full width,
    (e) a repeated prefill bitwise.  Returns the launch counts of the
    port's kernels over the phase (none runs on this path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    failed = []
    granite, model = _lm_moe_serve(
        dev, get_arch(LM_MOE_ARCH), LM_MOE_RUN1, LM_MOE_RUN2, LM_MOE_LOSS,
        LM_MOE_GAP_DEPTHS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mla_cfg = dataclasses.replace(get_arch(LM_MLA_ARCH),
                                  num_layers=LM_MLA_DEPTH)
    deepseek, model = _lm_moe_serve(dev, mla_cfg, LM_MLA_RUN1, None,
                                    LM_MLA_LOSS, LM_MLA_GAP_DEPTHS)
    deepseek["cut"] = f"depth {LM_MLA_DEPTH} of 60 layers"
    deepseek["hold_d_absorption"] = _lm_mla_absorption(
        mla_cfg, model.layers[0].attn, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()

    for row in (granite, deepseek):
        if not (math.isfinite(row["loss"]) and math.isfinite(row["aux"])):
            failed.append(f"hold (a) {row['arch']}: loss {row['loss']}, "
                          f"aux {row['aux']}")
        if not row["hold_e_prefill_bitwise"]:
            failed.append(f"hold (e) {row['arch']}: a second prefill "
                          f"differs from the first")
        for gap in row["gaps"]:
            if gap["dropped_pairs_in_references"]:
                failed.append(f"hold (b) {row['arch']}: the dropless "
                              f"references dropped pairs: {gap}")
    hold_b = next(g for g in granite["gaps"]
                  if g["depth"] == LM_MOE_HOLD_DEPTH)
    granite["hold_b"] = {"asserted_depth": LM_MOE_HOLD_DEPTH, **hold_b}
    if not hold_b["bar_use"] <= 1.0:
        failed.append(f"hold (b) {LM_MOE_ARCH} at depth "
                      f"{LM_MOE_HOLD_DEPTH}: {hold_b}")
    if not deepseek["hold_d_absorption"]["bar_use"] <= 1.0:
        failed.append(f"hold (d): {deepseek['hold_d_absorption']}")
    hold_c = [_lm_card_vs_cpu(dev, arch, LM_MOE_BF16_DEPTH)
              for arch in (LM_MOE_ARCH, LM_MLA_ARCH)]
    for c in hold_c:
        failed += c["failed"]
    emit({"phase": "lm_moe", "granite": granite, "deepseek": deepseek,
          "hold_c": hold_c, "bar": LM_BF16_TOL, "gpu": gpu,
          "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_moe: {failed}")
    return counts


def _lm_prefill_flops(model, b: int, s: int) -> float:
    """2 x the parameters each position of b requests multiplies: s
    prompt tokens through the non-embedding parameters, the hybrid's
    shared block at each of its uses; whisper's encoder_seq frames
    through the encoder and the cross K/V projections, the prompt
    through the rest of the decoder.  Attention scores are not counted."""
    cfg = model.cfg

    def count(mod):
        return sum(p.numel() for p in mod.parameters())

    if cfg.family == "encdec":
        cross_kv = sum(blk.cross["wk"].numel() + blk.cross["wv"].numel()
                       for blk in model.layers)
        per_frame = count(model.enc_layers) + count(model.enc_norm) + cross_kv
        per_token = count(model.layers) + count(model.final_norm) - cross_kv
        return 2 * b * (per_frame * cfg.encoder_seq + per_token * s)
    per_token = count(model) - count(model.embed) - (
        0 if cfg.tie_embeddings else count(model.unembed))
    if cfg.family == "hybrid":
        per_token += (cfg.num_layers // cfg.attn_every - 1) * count(
            model.shared_attn)
    return 2 * b * s * per_token


def _lm_cache_bytes(state) -> int:
    """Bytes of every tensor of a serving state."""
    import torch

    total = 0
    for group in state:
        for entry in group or ():
            tensors = (entry if isinstance(entry, tuple)
                       else vars(entry).values())
            total += sum(t.numel() * t.element_size() for t in tensors
                         if isinstance(t, torch.Tensor))
    return total


def _lm_ssm_serve(dev, cfg, run1, run2, loss_shape, gap_depths) -> dict:
    """One SSM, hybrid or enc-dec configuration through
    launch.serve.generate on the card (f32 weights drawn from LM_SEED;
    whisper's stub frames from LM_SEED + 3): run 1 with a second prefill
    compared bitwise (hold (e)), hold (b) at each of ``gap_depths`` and
    at the whole depth in f32, the
    profiler's busy time of one prefill and one decode step, run 2 where
    given, one train_loss forward; the bounds and the serving state's
    bytes per sequence; the model for the caller to free."""
    import math

    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.models import layers
    from repro_torch.models.frontends import synthetic_frontend

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    model, init_s = host_s(lambda: Model(
        cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    frames = torch.Generator(device=dev).manual_seed(LM_SEED + 3)

    def inputs(b, s, step):
        batch = TokenPipeline(cfg.vocab_size, b, s, LM_SEED).batch_at(step,
                                                                      dev)
        batch.update(synthetic_frontend(frames, cfg, b))
        return batch

    def run_row(run, b, s, g):
        return {"batch": b, "prompt": s, "steps": g,
                "prefill_ms": run.prefill_ms,
                "prefill_bound_ms": _lm_prefill_flops(model, b, s)
                / PEAK_BF16_FLOPS * 1e3,
                "decode_ms_per_step": run.decode_ms / g,
                "tok_per_s": g * b / run.decode_ms * 1e3,
                "context": s + g,
                "state_bytes_per_seq": _lm_cache_bytes(run.state) / b}

    b1, s1, g1 = run1
    batch1 = inputs(b1, s1, 0)
    del batch1["labels"]
    generate(model, batch1, 2)  # warm-up: cuBLAS handles, allocator
    out1 = generate(model, batch1, g1)
    again, _ = model.prefill(batch1, max_seq=s1 + g1)
    bitwise = bool(torch.equal(again, out1.logits[0]))
    del again

    gaps = []
    for depth in gap_depths:
        if depth == cfg.num_layers:
            gaps.append(_lm_decode_gap(model, batch1, out1, LM_HOLD_STEPS))
            continue
        view = _lm_view(model, depth)
        gaps.append(_lm_decode_gap(view, batch1, generate(
            view, batch1, LM_HOLD_STEPS), LM_HOLD_STEPS))
        del view

    # the same at the whole depth in f32 (COMPUTE_DTYPE patched; the
    # conv windows and KV caches stay bf16): what bf16's rounding adds
    saved, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, torch.float32
    try:
        gap_f32 = _lm_decode_gap(model, batch1, generate(
            model, batch1, LM_HOLD_STEPS), LM_HOLD_STEPS)
    finally:
        layers.COMPUTE_DTYPE = saved

    _, st = model.prefill(batch1, max_seq=s1 + 2)
    tok = torch.zeros((b1, 1), dtype=torch.int64, device=dev)
    model.decode_step(st, tok)
    busy = {"prefill": _device_busy(lambda: model.prefill(batch1)),
            "decode_step": _device_busy(lambda: model.decode_step(st, tok))}
    del st

    row = {"arch": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
           "params": n_params, "param_count_cfg": cfg.param_count(),
           "weight_bytes": 4 * n_params, "init_s": init_s,
           "decode_bound_ms": 4 * n_params / PEAK_BYTES_PER_S * 1e3,
           "run1": run_row(out1, b1, s1, g1),
           "hold_e_prefill_bitwise": bitwise, "gaps": gaps,
           "gap_f32": gap_f32}
    for name, ms in (("prefill", row["run1"]["prefill_ms"]),
                     ("decode_step", row["run1"]["decode_ms_per_step"])):
        dev_ms = busy[name]["device_ms"]
        busy[name]["idle_share"] = None if dev_ms is None else 1 - dev_ms / ms
    row["run1"]["profiled"] = busy
    del out1
    if run2 is not None:
        b2, s2, g2 = run2
        batch2 = inputs(b2, s2, 1)
        del batch2["labels"]
        out2 = generate(model, batch2, g2)
        row["run2"] = run_row(out2, b2, s2, g2)
        if cfg.family == "ssm":  # no KV cache to outgrow: one more step
            tok = out2.tokens[:, -1:]
            row["run2"]["profiled"] = {"decode_step": _device_busy(
                lambda: model.decode_step(out2.state, tok))}
        del batch2, out2
    loss_batch = inputs(*loss_shape, 2)
    with torch.no_grad():
        loss, loss_s = host_s(lambda: float(model.train_loss(loss_batch)[0]))
    row.update(loss=loss, ln_vocab=math.log(cfg.vocab_size),
               loss_shape=list(loss_shape), loss_s=loss_s,
               peak_bytes=torch.cuda.max_memory_allocated(),
               peak_bytes_before=base_bytes)
    return row, model


def _lm_ssd_full_width(cfg, ssm_params, dev) -> dict:
    """Hold (d): one full-width mamba2 layer's chunked scan (ssm_train)
    over LM_SSD_ORACLE positions against the sequential oracle (its
    decode step, position by position), and at chunk 64 against the
    config's 256, in f32 (the decode's conv windows bf16, as always)."""
    import torch

    from repro_torch.models import ssm

    b, s = LM_SSD_ORACLE
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 4)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.3
    with torch.no_grad():
        train, train_s = host_s(lambda: ssm.ssm_train(ssm_params, cfg, x))
        oracle, oracle_s = host_s(
            lambda: ssm.ssm_reference_scan(ssm_params, cfg, x))
        chunk64 = ssm.ssm_train(ssm_params, dataclasses.replace(
            cfg, ssm_chunk=64), x)

    def use(got, want):
        return float(((got - want).abs()
                      / (LM_SSD_TOL + LM_SSD_TOL * want.abs())).max())

    return {"positions": s, "chunks": -(-s // cfg.ssm_chunk),
            "oracle_bar_use": use(train, oracle),
            "oracle_max_abs_err": float((train - oracle).abs().max()),
            "chunk64_bar_use": use(chunk64, train),
            "chunk64_max_abs_err": float((chunk64 - train).abs().max()),
            "max_abs_out": float(train.abs().max()), "tol": LM_SSD_TOL,
            "train_s": train_s, "oracle_s": oracle_s}


def lm_ssm_phase(dev, gpu: str) -> dict:
    """The LM substrate's SSM, hybrid and enc-dec serving paths at full
    width and depth, each drawn on the card from a seeded generator, f32,
    through launch.serve.generate: mamba2-2.7b (64 Mamba2 layers, d_model
    2560, 80 heads of 64, state 128), zamba2-1.2b (32 Mamba2 layers in 6
    groups of 5 and 2 trailing, one weight-shared attention block after
    each group), whisper-small (12 encoder layers over 1,500 stub frames,
    12 decoder layers with cross attention).  Holds (a) finite logits and
    loss, (b) decode against prefill (asserted at each *_HOLD_DEPTH), (c)
    card against CPU at the three smoke configs, (d) the SSD at full
    width, (e) a repeated prefill bitwise, (f) mamba2's state bytes per
    sequence equal at run 1's and run 2's contexts.  Returns the launch
    counts of the port's kernels over the phase (none runs on this
    path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_launch_counts()
    failed = []
    mamba, model = _lm_ssm_serve(dev, get_arch(LM_SSM_ARCH), LM_SSM_RUN1,
                                 LM_SSM_RUN2, LM_SSM_LOSS, LM_SSM_GAP_DEPTHS)
    mamba["hold_d_ssd"] = _lm_ssd_full_width(model.cfg, model.layers[0].ssm,
                                             dev)
    del model
    free()
    zamba, model = _lm_ssm_serve(dev, get_arch(LM_HYBRID_ARCH),
                                 LM_HYBRID_RUN1, LM_HYBRID_RUN2,
                                 LM_HYBRID_LOSS, LM_HYBRID_GAP_DEPTHS)
    del model
    free()
    whisper, model = _lm_ssm_serve(dev, get_arch(LM_ENCDEC_ARCH),
                                   LM_ENCDEC_RUN1, None, LM_ENCDEC_LOSS,
                                   LM_ENCDEC_GAP_DEPTHS)
    del model
    free()
    counts = launch_counts()

    for row, depth in ((mamba, LM_SSM_HOLD_DEPTH),
                       (zamba, LM_HYBRID_HOLD_DEPTH),
                       (whisper, LM_ENCDEC_HOLD_DEPTH)):
        if not math.isfinite(row["loss"]):
            failed.append(f"hold (a) {row['arch']}: loss {row['loss']}")
        hold_b = next(g for g in row["gaps"] if g["depth"] == depth)
        row["hold_b"] = {"asserted_depth": depth, **hold_b}
        if not hold_b["bar_use"] <= 1.0:
            failed.append(f"hold (b) {row['arch']} at depth {depth}: "
                          f"{hold_b}")
        if not row["hold_e_prefill_bitwise"]:
            failed.append(f"hold (e) {row['arch']}: a second prefill "
                          f"differs from the first")
    ssd = mamba["hold_d_ssd"]
    if not (ssd["oracle_bar_use"] <= 1.0 and ssd["chunk64_bar_use"] <= 1.0):
        failed.append(f"hold (d): {ssd}")
    o1 = {"contexts": [mamba["run1"]["context"], mamba["run2"]["context"]],
          "state_bytes_per_seq": [mamba["run1"]["state_bytes_per_seq"],
                                  mamba["run2"]["state_bytes_per_seq"]],
          "decode_ms_per_step": [mamba["run1"]["decode_ms_per_step"],
                                 mamba["run2"]["decode_ms_per_step"]]}
    mamba["hold_f_o1_state"] = o1
    if o1["state_bytes_per_seq"][0] != o1["state_bytes_per_seq"][1]:
        failed.append(f"hold (f) {LM_SSM_ARCH}: {o1}")
    hold_c = [_lm_card_vs_cpu(dev, arch, depth) for arch, depth in (
        (LM_SSM_ARCH, None), (LM_HYBRID_ARCH, LM_HYBRID_BF16_DEPTH),
        (LM_ENCDEC_ARCH, None))]
    for c in hold_c:
        failed += c["failed"]
    emit({"phase": "lm_ssm", "mamba2": mamba, "zamba2": zamba,
          "whisper": whisper, "hold_c": hold_c, "bar": LM_BF16_TOL,
          "gpu": gpu, "phase_s": time.perf_counter() - t0,
          "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_ssm: {failed}")
    return counts


def train_sped_phase(dev, gpu: str) -> dict:
    """The paper's training loop through launch.train.train_sped at its
    defaults, checkpointed every 200 steps (K1 once per drawn factor),
    then resumed from step SPED_RESUME_AT: the resumed panel bitwise the
    uninterrupted one.  One more save and restore of the (v,) tree timed
    apart.  Returns the launch counts of both runs."""
    import shutil

    import torch

    from repro_torch.data.pipeline import mixed_seed
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.kernels.edge_spmm import ref as es_ref
    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    ck_dir = ROOT / "build" / "train_sped_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    args = train.parse_args(["--mode", "sped", "--ckpt-dir", str(ck_dir)])
    reset_launch_counts()
    full = train.train_sped(args, dev)
    full_counts = launch_counts()
    for d in ck_dir.iterdir():  # the newest checkpoint becomes step 400's
        if int(d.name.split("_")[1]) > SPED_RESUME_AT:
            shutil.rmtree(d)
    resumed = train.train_sped(args, dev)
    counts = launch_counts()
    path, save_s = host_s(lambda: ckpt.save(str(ck_dir), args.steps + 1,
                                            (full.v,)))
    (tree, _, _), restore_s = host_s(lambda: ckpt.restore_with_fallback(
        str(ck_dir), (torch.zeros_like(full.v),)))
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    shutil.rmtree(ck_dir)
    # K1 at this path's shapes: one step's draw (step args.steps's seed),
    # each factor's launch on the final panel against the plain twin, and
    # the kernel operator against the segment operator on the same draw
    g, _, op = train.sped_problem(args, dev)
    _, _, op_plain = train.sped_problem(args, dev, backend="segment")
    gen = torch.Generator(device=dev).manual_seed(
        mixed_seed(args.seed + 7, args.steps))
    sel = torch.randint(0, g.num_edges, (args.degree + 1, args.batch_edges),
                        generator=gen, device=dev)
    src, dst = g.src[sel].long(), g.dst[sel].long()
    w = g.weight[sel] * (g.num_edges / args.batch_edges)
    k1_err = max(_held(f"train_sped: edge_spmm (factor {i})",
                       es_ops.edge_spmm(src[i], dst[i], w[i], full.v),
                       es_ref.edge_spmm(src[i], dst[i], w[i], full.v))[0]
                 for i in range(args.degree))
    op_err = _held("train_sped: minibatch operator vs segment",
                   op(gen, full.v, sel), op_plain(gen, full.v, sel))[0]
    row = {"phase": "train_sped", "nodes": args.nodes,
           "clusters": args.clusters, "degree": args.degree,
           "steps": args.steps, "batch_edges": args.batch_edges,
           "seconds": full.seconds, "steps_per_s": args.steps / full.seconds,
           "ms_per_step": full.seconds / args.steps * 1e3,
           "k1_launches_per_step": full_counts["edge_spmm"] / args.steps,
           "subspace_error": full.error, "error_bar": SPED_ERROR_BAR,
           "agreement": full.accuracy,
           "k": full.v.shape[1], "k1_factor_max_abs_err": k1_err,
           "operator_max_abs_err": op_err, "resumed_from": SPED_RESUME_AT, "resumed_steps": resumed.steps,
           "resumed_seconds": resumed.seconds,
           "resume_bitwise": bool(torch.equal(resumed.v, full.v)),
           "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                          "bytes": nbytes,
                          "restored_bitwise": bool(torch.equal(tree[0],
                                                               full.v))},
           "gpu": gpu, "launches": counts}
    emit(row)
    if not (counts["edge_spmm"] > 0 and row["resume_bitwise"]
            and row["checkpoint"]["restored_bitwise"]
            and resumed.steps == args.steps - SPED_RESUME_AT
            and full.accuracy >= STOCHASTIC_AGREEMENT
            and full.error < SPED_ERROR_BAR):
        raise AssertionError(f"train_sped: {row}")
    return counts


def _train_bound_ms(model, tokens: int, moment_bytes: int) -> dict:
    """The least time of one training step: the FLOP bound at the bf16
    peak (8 x active non-embedding parameters x tokens under full remat,
    6 otherwise; 6 x d_model x vocab x tokens for the unembedding), plus
    the optimizer's bytes at the HBM rate (p and g f32 read, p written;
    m and v read and written at ``moment_bytes`` each)."""
    cfg = model.cfg
    embed = model.embed["table"].numel() + (
        0 if cfg.tie_embeddings else model.unembed["table"].numel())
    params = sum(p.numel() for p in model.parameters())
    active = params - embed
    for mod in model.modules():
        if "moe" in mod._modules:  # the routed experts a token skips
            stacks = sum(mod.moe[k].numel() for k in ("w_gate", "w_up", "w_down"))
            active -= stacks * (cfg.num_experts - cfg.moe_top_k) // cfg.num_experts
    factor = 8 if cfg.remat_policy == "full" else 6
    flops = factor * active * tokens + 6 * cfg.d_model * cfg.vocab_size * tokens
    opt_bytes = params * (3 * 4 + 4 * moment_bytes)
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = opt_bytes / PEAK_BYTES_PER_S * 1e3
    return {"params": params, "active_non_embedding": active,
            "flops": flops, "optimizer_bytes": opt_bytes,
            "flop_ms": flop_ms, "optimizer_ms": byte_ms,
            "bound_ms": flop_ms + byte_ms}


def _warm_median(ms: list) -> float:
    """The median of a run's step times after its first (warm-up) step."""
    warm = sorted(ms[1:])
    return warm[len(warm) // 2]


def _leaf_rel(got: dict, want: dict) -> float:
    """The largest difference of ``got``'s tensors from ``want``'s, leaf
    by leaf, as a share of the leaf's largest magnitude in ``want``."""
    out = 0.0
    for k, w in want.items():
        w = w.detach().float()
        top = float(w.abs().max())
        err = float((got[k].detach().float() - w).abs().max())
        out = max(out, err / top if top > 0 else err)
    return out


def lm_train_phase(dev, gpu: str) -> dict:
    """LM training on the card: granite-moe-1b-a400m at full width and
    depth through launch.train.train_lm (LM_TRAIN_STEPS steps of
    LM_TRAIN_SHAPE, remat "full", f32 moments): ms a step against its
    bound, tokens/s, peak bytes, losses, grad norms; the device-busy
    share and the host-clock split of one more step; then qwen3-4b at full width and depth, remat "full", bf16
    moments, LM_TRAIN_BIG_STEPS steps through dryrun.build_train_step: ms
    a step and peak bytes.  Returns the launch counts of the port's
    kernels over the phase (none runs on this path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun, train
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt_lib

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    b, s = LM_TRAIN_SHAPE
    base = ["--mode", "lm", "--arch", LM_TRAIN_ARCH, "--batch", str(b),
            "--seq", str(s), "--log-every", str(LM_TRAIN_STEPS)]
    reset_launch_counts()
    free()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(base + ["--steps", str(LM_TRAIN_STEPS)])
    whole, wall_s = host_s(lambda: train.train_lm(args, dev))
    peak = torch.cuda.max_memory_allocated()
    step_ms = [t * 1e3 for t in whole.step_s]
    steady = _warm_median(step_ms)
    bound = _train_bound_ms(whole.model, b * s, 4)
    opt_cfg = opt_lib.OptConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)
    granite = {"arch": LM_TRAIN_ARCH, "layers": whole.model.cfg.num_layers,
               "batch": b, "seq": s, "steps": LM_TRAIN_STEPS,
               "remat_policy": whole.model.cfg.remat_policy,
               "moment_dtype": opt_cfg.moment_dtype, **bound,
               "step_ms": step_ms, "ms_per_step": steady,
               "ms_statistic": "median of steps 2-",
               "bound_share": bound["bound_ms"] / steady,
               "tokens_per_s": b * s / steady * 1e3, "wall_s": wall_s,
               "peak_bytes": peak, "losses": whole.losses,
               "ln_vocab": math.log(whole.model.cfg.vocab_size),
               "grad_norms": whole.grad_norms}

    # the device-busy share of one more step, then the step's parts on
    # the host clock: forward alone, forward and backward (the recompute
    # included), the optimizer
    step = dryrun.build_train_step(whole.model.cfg, opt_cfg)
    batch = TokenPipeline(whole.model.cfg.vocab_size, b, s,
                          args.seed).batch_at(LM_TRAIN_STEPS, dev)
    busy = _device_busy(lambda: step(whole.model, whole.opt_state, batch))
    busy["busy_share"] = (None if busy["device_ms"] is None
                          else busy["device_ms"] / steady)
    model, params = whole.model, dict(whole.model.named_parameters())
    with torch.no_grad():
        fwd_s = host_s(lambda: model.train_loss(batch))[1]

    def fwd_bwd():
        model.train_loss(batch)[0].backward()

    fwd_bwd_s = host_s(fwd_bwd)[1]
    # [1] alone: apply returns the parameters and the state, which would
    # otherwise stay alive into the qwen3-4b run
    opt_s = host_s(lambda: opt_lib.apply(
        opt_cfg, whole.opt_state, params,
        {k: p.grad for k, p in params.items()}))[1]
    model.zero_grad(set_to_none=True)
    granite["profiled_step"] = busy
    granite["split"] = {"forward_ms": fwd_s * 1e3,
                        "forward_backward_ms": fwd_bwd_s * 1e3,
                        "optimizer_ms": opt_s * 1e3}
    del model, params, whole, step, batch
    free()

    # qwen3-4b: remat "full", bf16 moments
    bb, bs = LM_TRAIN_BIG_SHAPE
    cfg = get_arch(LM_TRAIN_BIG_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    opt_cfg = opt_lib.OptConfig(warmup_steps=20, total_steps=LM_TRAIN_BIG_STEPS,
                                moment_dtype="bfloat16")
    state = opt_lib.init(opt_cfg, dict(model.named_parameters()))
    step = dryrun.build_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(cfg.vocab_size, bb, bs, 0)
    losses, big_ms = [], []
    for i in range(LM_TRAIN_BIG_STEPS):
        batch = pipe.batch_at(i, dev)
        (model, state, m), sec = host_s(lambda: step(model, state, batch))
        losses.append(float(m["loss"]))
        big_ms.append(sec * 1e3)
    big_steady = _warm_median(big_ms)
    qwen = {"arch": LM_TRAIN_BIG_ARCH, "layers": cfg.num_layers,
            "batch": bb, "seq": bs, "steps": LM_TRAIN_BIG_STEPS,
            "remat_policy": cfg.remat_policy,
            "moment_dtype": opt_cfg.moment_dtype,
            **_train_bound_ms(model, bb * bs, 2), "step_ms": big_ms,
            "ms_per_step": big_steady, "ms_statistic": "median of steps 2-",
            "tokens_per_s": bb * bs / big_steady * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(), "losses": losses}
    qwen["bound_share"] = qwen["bound_ms"] / big_steady
    del model, state, step, batch, m
    free()
    counts = launch_counts()
    failed = []
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"{LM_TRAIN_BIG_ARCH} losses {losses}")
    emit({"phase": "lm_train", "granite": granite, "qwen": qwen, "gpu": gpu,
          "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_train: {failed}")
    return counts


def _timed(fn):
    """(fn's value, CUDA-event ms, host-clock ms) of one call."""
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    value = fn()
    end.record()
    torch.cuda.synchronize()
    return value, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def _lm_mesh_serve(model, tokens, fed, max_seq: int, mesh=None,
                   margins: bool = False) -> dict:
    """A prefill of ``tokens`` and a decode step per entry of ``fed``
    (fed[t] the tokens of step t, or None: the run's own argmax), under
    ``mesh`` where given: the logits of every call on the CPU, each
    layer's routing and aux after every call (with ``margins``, its
    router margins: ``_router_margins``), ms
    a call (CUDA events and host clock), the collectives of each decode
    step, the caches' bytes."""
    import contextlib

    import torch

    from repro_torch.models import sharding

    ctx = sharding.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    out = {"logits": [], "routing": [], "aux": [], "margins": [],
           "event_ms": [], "host_ms": [], "collectives": []}
    with ctx:
        for t in range(len(fed) + 1):
            sharding.reset_collective_stats()
            record = []
            with (_router_margins(record) if margins
                  else contextlib.nullcontext()):
                if t == 0:
                    (logits, state), ev, host = _timed(lambda: model.prefill(
                        {"tokens": tokens}, max_seq=max_seq))
                    out["cache_bytes"] = _lm_cache_bytes(state)
                    out["allocated_after_prefill"] = torch.cuda.memory_allocated()
                else:
                    tok = (fed[t - 1] if fed[t - 1] is not None
                           else out["logits"][-1].argmax(-1, keepdim=True).int())
                    (logits, state), ev, host = _timed(
                        lambda: model.decode_step(state, tok.to(tokens.device)))
            out["collectives"].append(sharding.collective_stats())
            out["logits"].append(logits.cpu())
            out["routing"].append(_lm_routing(model))
            out["aux"].append([float(blk.moe_stats.aux)
                               for blk in model._modules.get("layers", ())
                               if blk.moe_stats is not None])
            out["margins"].append(record)
            out["event_ms"].append(ev)
            out["host_ms"].append(host)
    return out


def _router_margins(record: list):
    """A context in which each MoE call also appends to ``record`` its
    router's top-k margin a token (the k-th largest softmax probability
    less the (k+1)-th, f32 on the CPU; the routing a rounding can flip
    is one with a small margin); the forward is unchanged."""
    import contextlib

    import torch

    from repro_torch.models import moe

    ffn = moe.moe_ffn

    def recorded(p, cfg, x):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        top = probs.topk(cfg.moe_top_k + 1, dim=-1).values
        record.append((top[:, -2] - top[:, -1]).cpu())
        return ffn(p, cfg, x)

    @contextlib.contextmanager
    def patched():
        moe.moe_ffn = recorded
        try:
            yield
        finally:
            moe.moe_ffn = ffn

    return patched()


def _lm_serve_tp_rank(dev, mesh, toks, fed: list, max_seq: int,
                      ones: dict) -> dict:
    """The lm_serve_tp runs of one rank (see LM_SERVE_TP_RUNS' comment):
    each model drawn from LM_SEED in the serving layout of ``mesh``, the
    runs of ``_lm_mesh_serve`` fed ``fed`` (those of LM_SERVE_TP_ONE:
    ``ones[key]``'s tokens) with their logits' digests (the logits kept
    on the (0, 0) rank, the routings on the model ranks 0), the bytes
    the full-depth bf16 granite's parameters and GQA caches requested,
    those each LM_SERVE_TP_BYTES_HELD run's bf16 parameters and caches
    requested beside dryrun.reckon's decode cells, the memory of the
    serially built runs, the host seconds of each build and run, and the
    kernel launches of the runs."""
    import dataclasses
    import gc
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, layers, sharding

    def run(model, tokens, fed_tokens, seq):
        r = _lm_mesh_serve(model, tokens, [torch.from_numpy(f)
                                           for f in fed_tokens], seq, mesh)
        if mesh.get_coordinate()[1]:
            r.pop("routing")  # the model ranks of a data group route alike
        logits = torch.stack(r.pop("logits"))
        r["logits_sha256"] = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
        if list(mesh.get_coordinate()) == [0, 0]:
            r["logits"] = logits
        return r

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()

    def draw(cfg, dtype):
        free()
        base = _requested_bytes()
        model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED),
                      train_mesh=mesh, fsdp=False, dtype=dtype)
        torch.cuda.synchronize()
        requested = _requested_bytes() - base
        torch.cuda.empty_cache()  # the whole blocks drawn before slicing
        return model, requested

    def build(cfg, dtype, serial=False):
        """The model and the bytes its parameters requested; ``serial``:
        the ranks draw one at a time, each its memory read after."""
        if not serial:
            return draw(cfg, dtype)
        free()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        for r in range(dist.get_world_size()):
            if r == dist.get_rank():
                model, requested = draw(cfg, dtype)
                free_b, total_b = torch.cuda.mem_get_info()
                memory.append({"weights": str(dtype), "rank_turn": r,
                               "card_used_bytes_after": total_b - free_b,
                               "peak_allocated_bytes":
                                   torch.cuda.max_memory_allocated(),
                               "peak_reserved_bytes":
                                   torch.cuda.max_memory_reserved()})
            dist.barrier()
        return model, requested

    def cache_bytes(model, batch, seq):
        """The bytes an empty serving state of ``batch`` x ``seq``
        requests."""
        with sharding.set_mesh(mesh):
            torch.cuda.synchronize()
            base = _requested_bytes()
            state = model.init_caches(batch, seq)
            torch.cuda.synchronize()
            got = _requested_bytes() - base
        del state
        return got

    cfg = get_arch(LM_MESH_ARCH)
    out = {"one_bytes": {}, "seconds": {}}
    memory = []
    reset_launch_counts()
    saved = layers.COMPUTE_DTYPE
    try:
        for dtype in ("float32", "bfloat16"):
            layers.COMPUTE_DTYPE = getattr(torch, dtype)
            (model, requested), out["seconds"][f"build_{dtype}"] = host_s(
                lambda: build(cfg, layers.COMPUTE_DTYPE))
            if dtype == "bfloat16":
                out["params_bytes_requested"] = requested
                out["params_dtypes"] = sorted({str(p.dtype)
                                               for p in model.parameters()})
                out["cache_bytes_requested"] = cache_bytes(
                    model, toks.shape[0], max_seq)
            for name, dt, depth in LM_SERVE_TP_RUNS:
                if dt == dtype:
                    out[name], out["seconds"][name] = host_s(lambda: run(
                        _lm_view(model, depth), toks, fed, max_seq))
            del model
            for key, arch, depth, _ in LM_SERVE_TP_ONE:
                one = ones[key]
                ocfg = dataclasses.replace(get_arch(arch), num_layers=depth)
                name = key if dtype == "float32" else f"{key}_bf16"
                (model, requested), out["seconds"][f"build_{name}"] = host_s(
                    lambda: build(ocfg, layers.COMPUTE_DTYPE,
                                  serial=key in LM_SERVE_TP_SERIAL_BUILD))
                rows = one["tokens"].shape[0]
                if key in LM_SERVE_TP_BYTES_HELD and dtype == "bfloat16":
                    out["one_bytes"][key] = {
                        "params_bytes_requested": requested,
                        "cache_bytes_requested": cache_bytes(
                            model, rows, one["max_seq"]),
                        "reckoned": dryrun.reckon(ocfg, "decode", rows,
                                                  one["max_seq"], mesh)}
                out[name], out["seconds"][name] = host_s(lambda: run(
                    model, torch.from_numpy(one["tokens"]).to(dev),
                    one["fed"], one["max_seq"]))
                del model
    finally:
        layers.COMPUTE_DTYPE = saved
    out["reckoned"] = dryrun.reckon(cfg, "decode", toks.shape[0], max_seq, mesh)
    out["serial_build_memory"] = memory
    out["launches"] = launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lm_serve_tp_refs(model, toks, fed: list, max_seq: int, dev):
    """lm_serve_tp's one-process references (see LM_SERVE_TP_RUNS'
    comment), from lm_mesh's f32 ``model`` (cast to bf16 at rest on the
    way: the caller's model is spent): each granite run's data halves
    fed their halves of ``fed``, then each LM_SERVE_TP_ONE run with f32
    weights fed its own argmax and with the same weights in bf16 fed the
    same tokens (a routed arch: each data half alone, with its router
    margins).  Returns (references by run name, the LM_SERVE_TP_ONE
    runs' inputs for the ranks by key)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, layers

    half = toks.shape[0] // LM_MESH_SHAPE[0]
    refs = {}
    for dtype in ("float32", "bfloat16"):
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        model.to(layers.COMPUTE_DTYPE)
        for name, dt, depth in LM_SERVE_TP_RUNS:
            if dt == dtype:
                refs[name] = [_lm_mesh_serve(
                    _lm_view(model, depth), toks[i * half:(i + 1) * half],
                    [torch.from_numpy(f[i * half:(i + 1) * half]) for f in fed],
                    max_seq, margins=True) for i in range(LM_MESH_SHAPE[0])]
    ones = {}
    for key, arch, depth, (ob, os_, og) in LM_SERVE_TP_ONE:
        ocfg = dataclasses.replace(get_arch(arch), num_layers=depth)
        otokens = np.random.default_rng(LM_SEED).integers(
            0, ocfg.vocab_size, (ob, os_), dtype=np.int32)
        otoks = torch.from_numpy(otokens).to(dev)
        routed = ocfg.family == "moe"
        groups = LM_MESH_SHAPE[0] if routed else 1
        rows = ob // groups

        def serve(m, tokens_fed):
            return [_lm_mesh_serve(
                m, otoks[i * rows:(i + 1) * rows],
                [None if f is None else torch.from_numpy(
                    f[i * rows:(i + 1) * rows]) for f in tokens_fed],
                os_ + og, margins=routed) for i in range(groups)]

        gc.collect()
        torch.cuda.empty_cache()
        layers.COMPUTE_DTYPE = torch.float32
        omodel = Model(ocfg, dev,
                       torch.Generator(device=dev).manual_seed(LM_SEED))
        refs[key] = serve(omodel, [None] * og)
        ofed = [np.concatenate([r["logits"][t].argmax(-1, keepdim=True).int()
                                .numpy() for r in refs[key]])
                for t in range(og)]
        layers.COMPUTE_DTYPE = torch.bfloat16
        omodel.to(torch.bfloat16)
        refs[f"{key}_bf16"] = serve(omodel, ofed)
        del omodel
        ones[key] = {"tokens": otokens, "max_seq": os_ + og, "fed": ofed}
    return refs, ones


def lm_mesh_rank(dev, tokens, fed: dict, max_seq: int, ones: dict) -> dict:
    """One rank of phase lm_mesh: granite drawn from LM_SEED on the card,
    its experts sharded over "model" (model.shard_model), then lm_moe's
    prefill and decode steps under the (2, 2) mesh in f32 and bf16
    compute, fed ``fed[dtype]``'s tokens; its memory and times.  Then
    phase lm_serve_tp's runs (``_lm_serve_tp_rank``, fed ``fed`` and
    ``ones``' tokens) under ``out["serve_tp"]``."""
    import gc
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch import parallel
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, layers
    from repro_torch.models.model import shard_model

    cfg = get_arch(LM_MESH_ARCH)
    mesh = parallel.make_mesh(LM_MESH_SHAPE, ("data", "model"), dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED))
    whole = torch.cuda.memory_allocated() - base
    shard_model(model, mesh)
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - base
    out = {"coord": [int(c) for c in mesh.get_coordinate()],
           "params": sum(p.numel() for p in model.parameters()),
           "allocated_params_bytes": params_bytes,
           "allocated_whole_model_bytes": whole}
    toks = torch.from_numpy(tokens).to(dev)
    _lm_mesh_serve(model, toks[:, :15], [None], 16, mesh)  # warm-up
    saved = layers.COMPUTE_DTYPE
    try:
        for name, dtype, depth, _ in LM_MESH_RUNS:
            layers.COMPUTE_DTYPE = getattr(torch, dtype)
            run = _lm_mesh_serve(_lm_view(model, depth), toks,
                                 [torch.from_numpy(f) for f in fed[name]],
                                 max_seq, mesh)
            run["allocated_caches_bytes"] = (run.pop("allocated_after_prefill")
                                             - base - params_bytes)
            logits = torch.stack(run["logits"])
            run["logits_sha256"] = hashlib.sha256(
                logits.numpy().tobytes()).hexdigest()
            if out["coord"] != [0, 0]:
                del run["logits"]  # every rank holds the gathered logits
            else:
                run["logits"] = logits
            out[name] = run
    finally:
        layers.COMPUTE_DTYPE = saved
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["serve_tp"] = _lm_serve_tp_rank(dev, mesh, toks, fed["f32"], max_seq,
                                        ones)
    return out


def lm_mesh_phase(dev, gpu: str) -> tuple[dict, dict]:
    """Phases lm_mesh and lm_serve_tp, in one 4-rank world (see the module
    docstring and LM_SERVE_TP_RUNS' comment).  Returns the launch
    counts of the port's kernels over each phase (none runs on either)."""
    import gc

    import numpy as np
    import torch

    from repro_torch import parallel
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model, layers

    reset_launch_counts()
    cfg = get_arch(LM_MESH_ARCH)
    b, s, g = LM_MESH_RUN
    max_seq = s + g
    half = b // LM_MESH_SHAPE[0]
    tokens = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED))
    one = {"params": sum(p.numel() for p in model.parameters()),
           "allocated_params_bytes": torch.cuda.memory_allocated() - base}
    toks = torch.from_numpy(tokens).to(dev)
    _lm_mesh_serve(model, toks[:, :15], [None], 16)  # warm-up
    refs, fed = {}, {}
    saved = layers.COMPUTE_DTYPE
    try:
        for name, dtype, depth, steps in LM_MESH_RUNS:
            layers.COMPUTE_DTYPE = getattr(torch, dtype)
            # the reference: each data half alone (one dispatch group each)
            halves = [_lm_mesh_serve(_lm_view(model, depth),
                                     toks[i * half:(i + 1) * half],
                                     [None] * steps, max_seq)
                      for i in range(LM_MESH_SHAPE[0])]
            fed[name] = [np.concatenate([h["logits"][t].argmax(-1, keepdim=True)
                                         .int().numpy() for h in halves])
                         for t in range(steps)]
            refs[name] = halves
            if name == "bf16":  # the one-process serving time at 4 rows
                whole = _lm_mesh_serve(model, toks, [None] * g, max_seq)
                one.update(prefill_ms=whole["event_ms"][0],
                           decode_ms_per_step=_warm_median(whole["event_ms"]),
                           decode_host_ms_per_step=_warm_median(whole["host_ms"]),
                           cache_bytes=whole["cache_bytes"],
                           allocated_caches_bytes=whole["allocated_after_prefill"]
                           - base - one["allocated_params_bytes"])
                del whole
        (tp_refs, ones), refs_s = host_s(lambda: _lm_serve_tp_refs(
            model, toks, fed["f32"], max_seq, dev))
        del model
    finally:
        layers.COMPUTE_DTYPE = saved
    gc.collect()
    torch.cuda.empty_cache()

    mla = dataclasses.replace(get_arch(LM_SERVE_TP_MLA_ARCH),
                              num_layers=LM_SERVE_TP_MLA_DEPTH)
    print(f"lm_serve_tp: {LM_SERVE_TP_MLA_ARCH} at {LM_SERVE_TP_MLA_DEPTH} "
          f"layer(s), reckoned card peak {_mla_build_peak(mla)} bytes while "
          "the ranks build it", file=sys.stderr, flush=True)
    results, wall = host_s(lambda: parallel.run_ranks(
        LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1], lm_mesh_rank, tokens, fed,
        max_seq, ones, timeout=LM_MESH_TIMEOUT_S))
    outs = [r.value for r in results]
    failed = []
    rows = {}
    for name, _, depth, steps in LM_MESH_RUNS:
        want = torch.stack([torch.cat([h["logits"][t] for h in refs[name]])
                            for t in range(steps + 1)])
        got = torch.from_numpy(outs[0][name]["logits"])
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        per_call = [float((got[t] - want[t]).abs().max()) / scale
                    for t in range(steps + 1)]
        aux_want = np.mean([np.asarray(h["aux"]) for h in refs[name]], axis=0)
        aux_err = float(np.abs(np.asarray(outs[0][name]["aux"]) - aux_want).max())
        flips = [0] * (steps + 1)  # a call's flipped (layer, token) routings
        for out in outs:
            if out["coord"][1]:
                continue  # the model ranks of a data group route alike
            i = out["coord"][0]
            for call in range(steps + 1):
                for got_r, want_r in zip(out[name]["routing"][call],
                                         refs[name][i]["routing"][call]):
                    flips[call] += int((np.asarray(got_r) != want_r.numpy())
                                       .any(-1).sum())
        digests = {o[name]["logits_sha256"] for o in outs}
        rows[name] = {
            "depth": depth or cfg.num_layers,
            "bar_use_bf16": _bar_use(got, want, LM_BF16_TOL),
            "max_abs_err": err, "largest_abs_logit": scale,
            "rel_err": err / scale, "rel_err_prefill": per_call[0],
            "rel_err_worst_step": max(per_call[1:]),
            "aux_max_abs_err": aux_err,
            "routing_flips_prefill": flips[0],
            "routing_flips_decode": sum(flips[1:]),
            "routings_prefill": b * s * (depth or cfg.num_layers),
            "decode_steps": steps,
            "routings_decode": steps * b * (depth or cfg.num_layers),
            "ranks_logits_bitwise_equal": len(digests) == 1,
            "ranks": [{
                "coord": o["coord"],
                "prefill_ms": o[name]["event_ms"][0],
                "prefill_host_ms": o[name]["host_ms"][0],
                "decode_ms_per_step": _warm_median(o[name]["event_ms"]),
                "decode_host_ms_per_step": _warm_median(o[name]["host_ms"]),
                "all_reduce_per_step": _warm_median(
                    [c["all_reduce"] for c in o[name]["collectives"]]),
                "all_gather_per_step": _warm_median(
                    [c["all_gather"] for c in o[name]["collectives"]]),
                "collective_host_ms_per_step": _warm_median(
                    [c["seconds"] * 1e3 for c in o[name]["collectives"]]),
                "prefill_all_reduce": o[name]["collectives"][0]["all_reduce"],
                "prefill_collective_host_ms":
                    o[name]["collectives"][0]["seconds"] * 1e3,
                "cache_bytes": o[name]["cache_bytes"],
                "allocated_caches_bytes": o[name]["allocated_caches_bytes"]}
                for o in outs]}
        if len(digests) != 1:
            failed.append(f"{name}: the ranks' gathered logits differ")
    f32 = rows["f32"]
    if not f32["rel_err"] <= LM_MESH_TOL:
        failed.append(f"f32 logits {f32['rel_err']} of the largest |logit| "
                      f"> {LM_MESH_TOL}")
    if not f32["aux_max_abs_err"] <= LM_MESH_AUX_TOL:
        failed.append(f"f32 aux {f32['aux_max_abs_err']} > {LM_MESH_AUX_TOL}")
    held = rows[f"bf16_depth{LM_MESH_BF16_DEPTH}"]
    if not held["bar_use_bf16"] <= 1.0:
        failed.append(f"bf16 at depth {LM_MESH_BF16_DEPTH}: bar use "
                      f"{held['bar_use_bf16']} of {LM_BF16_TOL}")
    for name, row in rows.items():
        for o in row["ranks"]:
            if (o["all_reduce_per_step"], o["all_gather_per_step"]) != (
                    5 * row["depth"], 1):
                failed.append(f"{name} rank {o['coord']}: "
                              f"{o['all_reduce_per_step']} all_reduces and "
                              f"{o['all_gather_per_step']} all_gathers a "
                              f"step, not {5 * row['depth']} and 1")
    counts = launch_counts()
    emit({"phase": "lm_mesh", "arch": LM_MESH_ARCH, "mesh": LM_MESH_SHAPE,
          "backend": "gloo", "run": LM_MESH_RUN, "max_seq": max_seq,
          "bar": LM_MESH_TOL, "aux_bar": LM_MESH_AUX_TOL, "world_wall_s": wall,
          "one_process": one,
          "ranks": [{k: o[k] for k in ("coord", "params",
                                      "allocated_params_bytes",
                                      "allocated_whole_model_bytes")}
                    for o in outs],
          **rows, "gpu": gpu,
          "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_mesh: {failed}")
    tp_counts = _lm_serve_tp_report(
        [o["serve_tp"] for o in outs], [o["coord"] for o in outs], tp_refs,
        wall, refs_s, gpu)
    return counts, tp_counts


def _tp_ranks_row(run: dict) -> dict:
    """One rank's times and collectives of an lm_serve_tp run: the
    prefill's and a decode step's (the median after the first) ms on CUDA
    events and on the host clock, the calls of each kind and the host ms
    of gloo a step, its share of the step's host ms."""
    coll = run["collectives"]
    row = {"prefill_ms": run["event_ms"][0],
           "prefill_host_ms": run["host_ms"][0],
           "prefill_calls": {k: coll[0][k] for k in _TP_CALLS},
           "prefill_gloo_host_ms": coll[0]["seconds"] * 1e3,
           "decode_ms_per_step": _warm_median(run["event_ms"]),
           "decode_host_ms_per_step": _warm_median(run["host_ms"]),
           "calls_per_step": {k: _warm_median([c[k] for c in coll])
                              for k in _TP_CALLS},
           "gloo_host_ms_per_step_by_kind": {
               k: _warm_median([c[f"{k}_seconds"] * 1e3 for c in coll])
               for k in _TP_CALLS},
           "gloo_host_ms_per_step": _warm_median(
               [c["seconds"] * 1e3 for c in coll]),
           "cache_bytes": run["cache_bytes"]}
    row["gloo_share"] = (row["gloo_host_ms_per_step"]
                         / row["decode_host_ms_per_step"])
    return row


_TP_CALLS = ("all_reduce", "all_gather", "all_to_all")


def _kept(ids, cap: int):
    """The experts that each token's pairs (``ids`` (tokens, top_k))
    reach with ``cap`` slots an expert, -1 for a pair dropped: the pairs
    of an expert rank in token order, as ``moe.dispatch`` ranks them."""
    import numpy as np

    flat = ids.ravel()
    order = np.argsort(flat, kind="stable")
    first = np.searchsorted(flat[order], flat[order], side="left")
    keep = np.empty(len(flat), bool)
    keep[order] = np.arange(len(flat)) - first < cap
    return np.where(keep.reshape(ids.shape), ids, -1)


def _tp_taint(got: dict, want: dict, rows: int, prompt: int, cfg) -> dict:
    """Which logits of one dispatch group's run (``got``, against the
    one-process ``want``: ``_lm_mesh_serve``'s outputs, ``rows`` rows of
    ``prompt`` tokens, the MoE layers of ``cfg``) a routing flip can
    reach.  A token's MoE output at a layer moves where its routing
    flips, or where a flip moves which of its pairs the capacity drops;
    that moves its logits, and those of its row's later positions unless
    the layer is the last (through the K/V it writes).  A flip that
    nothing earlier reaches (no move at a position <= its own below its
    layer) is primary: a near tie of the router.  Returns the clean
    (call, row) mask, the (call, layer) cells with a move, the primary
    flips with ``want``'s router margins there and the median margin of
    ``want``'s routings."""
    import numpy as np

    from repro_torch.models import moe

    depth = cfg.num_layers
    calls = len(want["routing"])
    # call, layer, token, row, position and whether it flipped, a move
    cols = [[], [], [], [], [], []]
    for c in range(calls):
        cap = moe.capacity(rows * prompt if c == 0 else rows, cfg)
        for lay in range(depth):
            ids = np.asarray(got["routing"][c][lay])
            ref = want["routing"][c][lay].numpy()
            t = np.nonzero((_kept(ids, cap) != _kept(ref, cap)).any(-1))[0]
            r, q = (divmod(t, prompt) if c == 0
                    else (t, np.full_like(t, prompt + c - 1)))
            for col, v in zip(cols, (np.full_like(t, c), np.full_like(t, lay),
                                     t, r, q, (ids[t] != ref[t]).any(-1))):
                col.append(v)
    fc, fl, ft, fr, fq, flip = (np.concatenate(col) for col in cols)
    # reached: a move of the row at a position <= q below its layer
    reached = np.zeros(len(fc), bool)
    clean = np.ones((calls, rows), bool)
    at = np.array([prompt - 1] + [prompt + c - 1 for c in range(1, calls)])
    for r in range(rows):
        own = np.nonzero(fr == r)[0]
        if not len(own):
            continue
        order = own[np.argsort(fq[own], kind="stable")]
        lowest = np.minimum.accumulate(fl[order])
        k = np.searchsorted(fq[order], fq[own], side="right") - 1
        reached[own] = lowest[k] < fl[own]
        below = own[fl[own] < depth - 1]
        first = fq[below].min() if len(below) else np.inf
        clean[:, r] = ~((at >= first) | np.isin(at, fq[own]))
    primary = flip & ~reached
    margins = np.concatenate([m.numpy() for call in want["margins"]
                              for m in call])
    return {"clean": clean, "cells": set(zip(fc.tolist(), fl.tolist())),
            "primary": [float(want["margins"][c][lay][t]) for c, lay, t
                        in zip(fc[primary], fl[primary], ft[primary])],
            "flips": int(flip.sum()), "drop_moves": int((~flip).sum()),
            "margin_median": float(np.median(margins))}


def _aux_clean(cells: set, calls: int, depth: int):
    """The (call, layer) aux a flip at a (call, layer) of ``cells`` cannot
    reach: none at that call at or below the layer, none at an earlier
    call below it (through the cache)."""
    import numpy as np

    return np.array([[not any((c2 < c and l2 < lay) or (c2 == c and l2 <= lay)
                              for c2, l2 in cells)
                      for lay in range(depth)] for c in range(calls)],
                    bool).reshape(calls, depth)


def _lm_serve_tp_report(outs: list, coords: list, refs: dict, wall: float,
                        refs_s: float, gpu: str) -> dict:
    """Phase lm_serve_tp's line from the ranks' runs (``outs``, in rank
    order, at ``coords``) against the one-process references ``refs``
    (``_lm_serve_tp_refs``, which took ``refs_s`` host seconds); returns
    the kernel launches of the ranks' runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch(LM_MESH_ARCH)
    b, s, g = LM_MESH_RUN
    failed = []
    first = outs[coords.index([0, 0])]
    runs = [(name, dt, dataclasses.replace(cfg, num_layers=depth or
                                           cfg.num_layers), s)
            for name, dt, depth in LM_SERVE_TP_RUNS]
    for key, arch, depth, run in LM_SERVE_TP_ONE:
        ocfg = dataclasses.replace(get_arch(arch), num_layers=depth)
        runs += [(key, "float32", ocfg, run[1]),
                 (f"{key}_bf16", "bfloat16", ocfg, run[1])]
    rows, counts_by_depth = {}, {}
    for name, dtype, c, prompt in runs:
        want = torch.stack([torch.cat([h["logits"][t] for h in refs[name]])
                            for t in range(len(refs[name][0]["logits"]))])
        got = torch.from_numpy(first[name]["logits"])
        calls, batch = want.shape[:2]
        scale = float(want.abs().max())
        # the dispatch groups' taints (a dense model routes nothing)
        taints = [_tp_taint(o[name], refs[name][coord[0]],
                            batch // LM_MESH_SHAPE[0], prompt, c)
                  for coord, o in sorted(zip(coords, outs))
                  if coord[1] == 0 and c.family == "moe"]
        clean = (torch.from_numpy(np.concatenate([t["clean"] for t in taints],
                                                 axis=1))
                 if taints else torch.ones((calls, batch), dtype=torch.bool))
        err = (got - want).abs().amax(-1) / scale  # (calls, rows)
        primary = sorted(m for t in taints for m in t["primary"])

        def worst(sel):
            mask = clean[sel]
            return float(err[sel][mask].max()) if mask.any() else None

        row = {"weights": dtype, "layers": c.num_layers,
               "max_abs_err": float((got - want).abs().max()),
               "largest_abs_logit": scale,
               "rel_err_prefill": float(err[0].max()),
               "rel_err_worst_step": float(err[1:].max()),
               "bar_use_bf16": _bar_use(got, want, LM_BF16_TOL),
               "routing_flips": sum(t["flips"] for t in taints),
               "primary_flips": len(primary),
               "primary_flip_margins": primary[:LM_SERVE_TP_MARGINS_SHOWN],
               "primary_flip_margin_max": primary[-1] if primary else None,
               "routing_margin_median": (taints[0]["margin_median"]
                                         if c.family == "moe" else None),
               "capacity_drop_moves": sum(t["drop_moves"] for t in taints),
               "clean_rows_prefill": int(clean[0].sum()),
               "clean_rows_decode": int(clean[1:].sum()),
               "rows_decode": int(clean[1:].numel()),
               "rel_err_prefill_clean": worst(slice(0, 1)),
               "rel_err_worst_step_clean": worst(slice(1, None)),
               "bar_use_bf16_clean": (_bar_use(got[clean], want[clean],
                                               LM_BF16_TOL)
                                      if clean.any() else None),
               "ranks_logits_bitwise_equal": len(
                   {o[name]["logits_sha256"] for o in outs}) == 1,
               "ranks": [{"coord": coord, **_tp_ranks_row(o[name])}
                         for coord, o in zip(coords, outs)]}
        if c.family == "moe":
            aux_want = np.mean([np.asarray(h["aux"]) for h in refs[name]], axis=0)
            aux_err = np.abs(np.asarray(first[name]["aux"]) - aux_want)
            held = _aux_clean(set().union(*(t["cells"] for t in taints)),
                              calls, c.num_layers)
            row.update(
                aux_max_abs_err_prefill=float(aux_err[0].max()),
                aux_max_abs_err_decode=float(aux_err[1:].max()),
                aux_clean_prefill=int(held[0].sum()),
                aux_clean_decode=int(held[1:].sum()),
                aux_max_abs_err_prefill_clean=(float(aux_err[0][held[0]].max())
                                               if held[0].any() else None),
                aux_max_abs_err_decode_clean=(float(aux_err[1:][held[1:]].max())
                                              if held[1:].any() else None))
        rows[name] = row
        if not row["ranks_logits_bitwise_equal"]:
            failed.append(f"{name}: the ranks' gathered logits differ")
        if dtype == "float32":
            bars = [("rel_err_prefill_clean", LM_MESH_TOL),
                    ("rel_err_worst_step_clean", LM_DECODE_F32_TOL),
                    ("aux_max_abs_err_prefill_clean", LM_MESH_AUX_TOL),
                    ("aux_max_abs_err_decode_clean",
                     LM_SERVE_TP_DECODE_AUX_TOL)]
        else:
            bars = [("bar_use_bf16_clean", 1.0)]
        if not (row["clean_rows_prefill"] and row["clean_rows_decode"]):
            failed.append(f"{name}: no clean prefill or decode row to hold")
        for key, bar in bars:
            if row.get(key) is not None and not row[key] <= bar:
                failed.append(f"{name}: {key} {row[key]} > {bar}")
        # the calls are the same a step on every rank, and fixed plus a
        # count a layer (the CPU tests hold the count to the config)
        steps = [cc for o in outs for cc in o[name]["collectives"][1:]]
        if any({k: cc[k] for k in _TP_CALLS} != {k: steps[0][k]
                                                 for k in _TP_CALLS}
               for cc in steps):
            failed.append(f"{name}: the calls of a decode step differ "
                          "between steps or ranks")
        if c.name == LM_MESH_ARCH:
            counts_by_depth[c.num_layers] = [
                steps[0][k] for k in _TP_CALLS] + [
                outs[0][name]["collectives"][0]["all_to_all"]]
        if c.family == "ssm" and not steps[0]["all_to_all"]:
            # the mixer computes on its heads: a [z | x] exchange a step
            failed.append(f"{name}: a decode step made no all_to_all")
        if c.use_mla:
            # the embedding's sum; per layer the absorbed queries' gather,
            # the softmax's three all_reduces, wo's sum, the MoE's combine
            # and aux mean; the logits gathered over "model" and "data"
            want_calls = {"all_reduce": 1 + 6 * c.num_layers,
                          "all_gather": c.num_layers + 2, "all_to_all": 0}
            if {k: steps[0][k] for k in _TP_CALLS} != want_calls:
                failed.append(f"{name}: a decode step made "
                              f"{[steps[0][k] for k in _TP_CALLS]} calls, "
                              f"not {want_calls}")
    depths = sorted(counts_by_depth)
    lo, mid = depths[0], depths[1]
    for d in depths:
        for x0, x1, x in zip(counts_by_depth[lo], counts_by_depth[mid],
                             counts_by_depth[d]):
            if (x - x0) * (mid - lo) != (x1 - x0) * (d - lo):
                failed.append(f"granite calls at {d} layers "
                              f"{counts_by_depth[d]} are not those at "
                              f"{lo} layers plus a count a layer")
                break
    reckoned = first["reckoned"]
    kv_want = reckoned["cache_bytes"] - 4 * cfg.num_layers  # int32 lengths
    byte_rows = []
    for coord, o in zip(coords, outs):
        byte_rows.append({"coord": coord,
                          "params_bytes_requested": o["params_bytes_requested"],
                          "params_dtypes": o["params_dtypes"],
                          "cache_bytes_requested": o["cache_bytes_requested"]})
        if o["params_bytes_requested"] != reckoned["params_bytes"]:
            failed.append(f"rank {coord}: {o['params_bytes_requested']} bytes "
                          f"of parameters requested, reckoned "
                          f"{reckoned['params_bytes']}")
        if o["cache_bytes_requested"] != kv_want:
            failed.append(f"rank {coord}: {o['cache_bytes_requested']} cache "
                          f"bytes requested, reckoned {kv_want}")
    # the bf16 serving layouts of LM_SERVE_TP_BYTES_HELD: the bytes each
    # rank requests for its parameters and its caches (mamba2: the rank's
    # rows and heads; deepseek: its rows and slice of the sequence) and
    # the bytes its run's caches hold, as reckoned
    one_bytes = {key: [] for key in LM_SERVE_TP_BYTES_HELD}
    one_depth = {key: depth for key, _, depth, _ in LM_SERVE_TP_ONE}
    for key, held in one_bytes.items():
        for coord, o in zip(coords, outs):
            sb = o["one_bytes"][key]
            reck = sb["reckoned"]
            cache_want = reck["cache_bytes"] - 4 * one_depth[key]
            held.append({"coord": coord, **{k: v for k, v in sb.items()
                                            if k != "reckoned"},
                         "state_bytes": o[f"{key}_bf16"]["cache_bytes"],
                         "reckoned_params_bytes": reck["params_bytes"],
                         "reckoned_cache_bytes": cache_want})
            if sb["params_bytes_requested"] != reck["params_bytes"]:
                failed.append(f"{key} rank {coord}: "
                              f"{sb['params_bytes_requested']} bytes of "
                              f"parameters requested, reckoned "
                              f"{reck['params_bytes']}")
            for what in ("cache_bytes_requested", "state_bytes"):
                if held[-1][what] != cache_want:
                    failed.append(f"{key} rank {coord}: {what} "
                                  f"{held[-1][what]}, reckoned {cache_want}")
    mla = dataclasses.replace(get_arch(LM_SERVE_TP_MLA_ARCH),
                              num_layers=LM_SERVE_TP_MLA_DEPTH)
    mb, mp, mg = LM_SERVE_TP_MLA_RUN
    # a rank's latent caches if they were whole along "model"
    mla_whole = (LM_SERVE_TP_MLA_DEPTH * (mb // LM_MESH_SHAPE[0]) * (mp + mg)
                 * (mla.kv_lora_rank + mla.qk_rope_head_dim) * 2)
    serial = [{"coord": coord, "builds": o["serial_build_memory"]}
              for coord, o in zip(coords, outs)]
    counts = {k: sum(o["launches"][k] for o in outs)
              for k in first["launches"]}
    if any(counts.values()):
        failed.append(f"kernels launched: {counts}")
    emit({"phase": "lm_serve_tp", "arch": LM_MESH_ARCH, "mesh": LM_MESH_SHAPE,
          "layout": "param_specs(fsdp=False)", "backend": "gloo",
          "exchange": "all_to_all_single", "run": LM_MESH_RUN,
          "max_seq": s + g, "qwen_run": LM_SERVE_TP_QWEN_RUN,
          "mamba2_run": LM_SERVE_TP_SSM_RUN,
          "mamba2_bytes": one_bytes["mamba2"],
          "deepseek_run": LM_SERVE_TP_MLA_RUN,
          "deepseek_depth": LM_SERVE_TP_MLA_DEPTH,
          "deepseek_bytes": one_bytes["deepseek"],
          "deepseek_cache_bytes_whole_along_model": mla_whole,
          "deepseek_serial_build": serial,
          "deepseek_reckoned_card_peak_bytes": _mla_build_peak(mla),
          "bars": {"prefill": LM_MESH_TOL, "decode": LM_DECODE_F32_TOL,
                   "aux": LM_MESH_AUX_TOL,
                   "decode_aux": LM_SERVE_TP_DECODE_AUX_TOL,
                   "bf16": LM_BF16_TOL},
          "world_wall_s": wall, "refs_s": refs_s,
          "rank_seconds": first["seconds"],
          "reckoned": reckoned, "bytes": byte_rows,
          **rows, "gpu": gpu, "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_serve_tp: {failed}")
    return counts


def _mla_build_peak(cfg) -> int:
    """The card's reckoned peak bytes while lm_serve_tp's ranks build
    ``cfg`` one at a time with f32 weights: every rank's f32 slices (twice
    dryrun.reckon's bf16 parameter bytes a rank of the serving layout)
    and the last rank's whole block, drawn in f32 before it is sliced."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import Model

    b, p, g = LM_SERVE_TP_MLA_RUN
    mesh = AbstractMesh(LM_MESH_SHAPE, ("data", "model"))
    slices = 2 * dryrun.reckon(cfg, "decode", b, p + g, mesh)["params_bytes"]
    block = Model(cfg, "meta").layers[0]
    return (math.prod(LM_MESH_SHAPE) * slices
            + sum(t.numel() for t in block.parameters())
            * torch.finfo(torch.float32).bits // 8)


def _requested_bytes() -> int:
    """The bytes the live tensors on the card asked the caching allocator
    for (each request's size before the allocator rounds it up)."""
    import torch

    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _allocated_vs_reckoned(build) -> dict:
    """``build`` = [(part, make)], ``make()`` -> the part's tensors,
    allocated on the card: each part's growth of the requested bytes
    (what the tensors asked for) and of memory_allocated (the blocks the
    allocator handed out), and its tensor count."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"requested": {}, "allocated": {}, "tensors": {}}
    keep = []
    for part, make in build:
        req, alloc = _requested_bytes(), torch.cuda.memory_allocated()
        tensors = make()
        keep.append(tensors)
        torch.cuda.synchronize()
        out["requested"][part] = _requested_bytes() - req
        out["allocated"][part] = torch.cuda.memory_allocated() - alloc
        out["tensors"][part] = len(tensors)
    del keep
    return out


def dryrun_report_phase(dev, gpu: str) -> dict:
    """Phase dryrun_report (see the module docstring).  Returns the
    launch counts of the port's kernels over the phase (none)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, SHAPES, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model, sharding
    from repro_torch.train import optimizer as opt_lib

    reset_launch_counts()
    budget = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    statuses = {}
    for arch in sorted(ARCHS):
        for shape in sorted(SHAPES):
            for mp in (False, True):
                rec = dryrun.run_cell(arch, shape, mp, budget_bytes=budget)
                statuses[rec["status"]] = statuses.get(rec["status"], 0) + 1
                line = {"phase": "dryrun_cell", "arch": arch, "shape": shape,
                        "mesh": rec["mesh"], "status": rec["status"]}
                if rec["status"] == "ok":
                    m = rec["memory"]
                    line.update(kind=rec["kind"], devices=rec["devices"],
                                gb_a_rank=m["argument_bytes"] / 1e9,
                                params_gb=m["params_bytes"] / 1e9,
                                optimizer_gb=m["optimizer_bytes"] / 1e9,
                                caches_gb=m["cache_bytes"] / 1e9,
                                batch_gb=m["batch_bytes"] / 1e9,
                                fits=m["fits"])
                else:
                    line["reason"] = rec.get("reason")
                emit(line)
    report_s = time.perf_counter() - t0

    cfg = get_arch(LM_MESH_ARCH)
    held = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=(Path(tmp) / "init").as_uri(),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(dev)
            tb, ts = LM_TRAIN_SHAPE
            want = dryrun.reckon(cfg, "train", tb, ts, mesh, opt_lib.OptConfig())
            box = {}

            def params():
                box["model"] = Model(cfg, dev,
                                     torch.Generator(device=dev).manual_seed(0))
                return list(box["model"].parameters())

            def optimizer():
                box["opt"] = opt_lib.init(opt_lib.OptConfig(), dict(
                    box["model"].named_parameters()))
                return [box["opt"].step, *box["opt"].mu.values(),
                        *box["opt"].nu.values()]

            def train_batch():
                return [torch.zeros((tb, ts), dtype=torch.int32, device=dev)
                        for _ in range(2)]

            got = _allocated_vs_reckoned([("params", params),
                                               ("optimizer", optimizer),
                                               ("batch", train_batch)])
            held["train"] = (want, got)
            box.clear()
            torch.cuda.empty_cache()

            db, ds, _ = LM_MESH_RUN
            ds += LM_MESH_RUN[2]
            want = dryrun.reckon(cfg, "decode", db, ds, mesh)

            def bf16_params():
                box["model"] = Model(cfg, dev, torch.Generator(
                    device=dev).manual_seed(0)).to(torch.bfloat16)
                return list(box["model"].parameters())

            def caches():
                with sharding.set_mesh(mesh):
                    box["state"] = box["model"].init_caches(db, ds)
                return [t for c in box["state"].caches
                        for t in (c.k, c.v, c.k_scale, c.v_scale)
                        if t is not None]

            def decode_batch():
                return [torch.zeros((db, 1), dtype=torch.int32, device=dev)]

            got = _allocated_vs_reckoned([("params", bf16_params),
                                               ("caches", caches),
                                               ("batch", decode_batch)])
            held["decode"] = (want, got)
            box.clear()
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

    failed = []
    rows = {}
    keys = {"params": "params_bytes", "optimizer": "optimizer_bytes",
            "caches": "cache_bytes", "batch": "batch_bytes"}
    for cell, (want, got) in held.items():
        row = {"reckoned": want, **got}
        for part, n in got["tensors"].items():
            diff = got["requested"][part] - want[keys[part]]
            row[f"{part}_diff_bytes"] = diff
            row[f"{part}_allocated_diff_bytes"] = (got["allocated"][part]
                                                   - want[keys[part]])
            if abs(diff) > DRYRUN_ALLOC_SLACK * n:
                failed.append(f"{cell} {part}: requested "
                              f"{got['requested'][part]}, reckoned "
                              f"{want[keys[part]]} ({n} tensors)")
        rows[cell] = row
    counts = launch_counts()
    emit({"phase": "dryrun_report", "cells": sum(statuses.values()),
          "statuses": statuses, "report_s": report_s, "budget_bytes": budget,
          "held": rows, "slack_bytes_a_tensor": DRYRUN_ALLOC_SLACK,
          "gpu": gpu, "launches": counts, "failed": failed})
    if sum(statuses.values()) != 80 or statuses.get("error"):
        failed.append(f"cells: {statuses}")
    if failed:
        raise AssertionError(f"dryrun_report: {failed}")
    return counts


def _opt_bytes(state) -> int:
    """Bytes of an OptState's step and moments."""
    return state.step.element_size() + sum(
        t.numel() * t.element_size() for d in (state.mu, state.nu)
        for t in d.values())


def _lm_train_dp_reference(cfg, opt_cfg, batches: list, dev, state_dp,
                           params: dict) -> dict:
    """One process on the card computing what the mesh step computes:
    each half-batch's gradient, the two averaged, then AdamW, from the
    same seed; held to the mesh run's parameters and to this rank's
    moment slices (cut by ``state_dp``'s ZeRO-1 layout)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt_lib

    model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED))
    ref = dict(model.named_parameters())
    state = opt_lib.init(opt_cfg, ref)
    losses, norms = [], []
    for batch in batches:
        rows = batch["tokens"].shape[0]
        half_losses, half_grads = [], []
        for h in (slice(0, rows // 2), slice(rows // 2, rows)):
            loss, _ = model.train_loss({k: v[h] for k, v in batch.items()})
            loss.backward()
            half_losses.append(loss.detach())
            half_grads.append({k: p.grad for k, p in ref.items()})
            model.zero_grad(set_to_none=True)
        grads = {k: (half_grads[0][k] + half_grads[1][k]) / 2 for k in ref}
        del half_grads
        _, state, m = opt_lib.apply(opt_cfg, state, ref, grads)
        del grads
        losses.append(float((half_losses[0] + half_losses[1]) / 2))
        norms.append(float(m["grad_norm"]))
    def mine(moments: dict) -> dict:
        return {k: state_dp.layout.part(k, moments[k]) for k in state_dp.mu}

    return {"losses": losses, "grad_norms": norms,
            "params_rel": _leaf_rel(params, ref),
            "mu_rel": _leaf_rel(state_dp.mu, mine(state.mu)),
            "nu_rel": _leaf_rel(state_dp.nu, mine(state.nu))}


def _lm_train_dp_resume(dev, params: dict, state) -> dict:
    """launch.train.train_lm in this world, as torchrun runs it (the
    (ranks, 1) mesh, ZeRO-1 moments; every rank gathers a save, rank 0
    writes it), with granite cut to LM_TRAIN_DP_DEPTH: LM_TRAIN_DP_SAVE_AT
    steps saved with --ckpt-dir, then a second train_lm resuming from
    that checkpoint to LM_TRAIN_DP_STEPS; its parameters and moment
    slices held to ``params`` and ``state``, the run of the same steps
    without the round trip (train_lm draws the same model, batches and
    schedule: seed 0, lr 3e-4, 20 warm-up steps)."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train

    ck_dir = ROOT / "build" / "lm_train_dp_ckpt"
    b, s = LM_TRAIN_SHAPE
    base = ["--mode", "lm", "--arch", LM_TRAIN_ARCH, "--batch", str(b),
            "--seq", str(s), "--log-every", str(LM_TRAIN_DP_STEPS),
            "--ckpt-dir", str(ck_dir)]
    lead = dist.get_rank() == 0
    if lead:
        shutil.rmtree(ck_dir, ignore_errors=True)
    dist.barrier()
    get_arch = train.get_arch  # train_lm has no depth flag: cut it here
    train.get_arch = lambda name: dataclasses.replace(
        get_arch(name), num_layers=LM_TRAIN_DP_DEPTH)
    try:
        first, first_s = host_s(lambda: train.train_lm(train.parse_args(
            base + ["--steps", str(LM_TRAIN_DP_SAVE_AT)]), dev))
        del first
        dist.barrier()  # rank 0's save is on disk before anyone resumes
        out = {"first_run_s": first_s}
        if lead:
            path = ck_dir / f"step_{LM_TRAIN_DP_SAVE_AT:09d}"
            out["checkpoint_bytes"] = sum(f.stat().st_size
                                          for f in path.iterdir())
        run, out["resumed_run_s"] = host_s(lambda: train.train_lm(
            train.parse_args(base + ["--steps", str(LM_TRAIN_DP_STEPS)]), dev))
    finally:
        train.get_arch = get_arch
    dist.barrier()
    if lead:
        shutil.rmtree(ck_dir, ignore_errors=True)
    got = dict(run.model.named_parameters())
    out.update(from_step=run.start, losses=run.losses,
               step_s=run.step_s,
               params_bitwise=all(torch.equal(got[k], p)
                                  for k, p in params.items()),
               params_rel=_leaf_rel(got, params),
               mu_rel=_leaf_rel(run.opt_state.mu, state.mu),
               nu_rel=_leaf_rel(run.opt_state.nu, state.nu),
               step_equal=int(run.opt_state.step) == int(state.step))
    return out


def lm_train_dp_rank(dev) -> dict:
    """One rank of phase lm_train_dp: granite cut to LM_TRAIN_DP_DEPTH on
    the (ranks, 1) mesh, LM_TRAIN_DP_STEPS data-parallel steps with ZeRO-1
    moments (ms, collectives, losses, peak), the parameters' digest and
    the moments' bytes against dryrun.reckon; the checkpoint round trip
    through train_lm (``_lm_train_dp_resume``); the run held to one
    process's halves, computed in this rank; then the full-depth build
    against the reckoning."""
    import gc
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model, sharding
    from repro_torch.train import optimizer as opt_lib

    full = get_arch(LM_TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_TRAIN_DP_DEPTH)
    b, s = LM_TRAIN_SHAPE
    opt_cfg = opt_lib.OptConfig(lr=3e-4, warmup_steps=20,
                                total_steps=LM_TRAIN_DP_STEPS)
    mesh = make_local_mesh(dev)
    pipe = TokenPipeline(cfg.vocab_size, b, s, 0)
    batches = [pipe.batch_at(i, dev) for i in range(LM_TRAIN_DP_STEPS)]
    out = {"coord": [int(c) for c in mesh.get_coordinate()]}
    with sharding.set_mesh(mesh):
        model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED))
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        req = _requested_bytes()
        state = opt_lib.init(opt_cfg, params)
        torch.cuda.synchronize()
        out["moment_bytes_requested"] = _requested_bytes() - req
        out["moment_bytes"] = _opt_bytes(state)
        out["reckoned_optimizer_bytes"] = dryrun.reckon(
            cfg, "train", b, s, mesh, opt_cfg)["optimizer_bytes"]
        step = dryrun.build_train_step(cfg, opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, step_ms, coll = [], [], [], []
        for batch in batches:
            sharding.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            coll.append(sharding.collective_stats())
        out.update(losses=losses, grad_norms=norms, step_ms=step_ms,
                   collectives=coll, peak_bytes=torch.cuda.max_memory_allocated(),
                   moments_held=len(state.mu), params_total=len(params))
        sha = hashlib.sha256()
        for p in params.values():
            sha.update(p.detach().cpu().numpy().tobytes())
        out["params_sha256"] = sha.hexdigest()
    gc.collect()
    torch.cuda.empty_cache()
    out["resume"] = _lm_train_dp_resume(dev, params, state)
    gc.collect()
    torch.cuda.empty_cache()
    # every rank runs the reference and holds its own moment slices to it
    out["reference"] = _lm_train_dp_reference(cfg, opt_cfg, batches, dev,
                                              state, params)
    del model, params, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    # full depth: the model in its training layout (FSDP by the
    # threshold) and its ZeRO-1 state, no step
    with sharding.set_mesh(mesh):
        torch.cuda.synchronize()
        base = _requested_bytes()
        model = Model(full, dev, torch.Generator(device=dev).manual_seed(LM_SEED),
                      train_mesh=mesh)
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        params_req = _requested_bytes() - base
        state = opt_lib.init(opt_cfg, params, model.train_layout)
        torch.cuda.synchronize()
        want = dryrun.reckon(full, "train", b, s, mesh, opt_cfg)
        whole = sum(math.prod(sp.shape) * 4
                    for sp in model.train_layout.splits.values())
        out["full_depth"] = {
            "layers": full.num_layers, "fsdp": model.train_layout.fsdp,
            "params_bytes_requested": params_req,
            "params_bytes": sum(p.numel() * 4 for p in params.values()),
            "params_held": len(params),
            "moment_bytes_requested": _requested_bytes() - base - params_req,
            "moment_bytes": _opt_bytes(state),
            "reckoned_optimizer_bytes": want["optimizer_bytes"],
            "reckoned_params_bytes": want["params_bytes"],
            "whole_params_bytes": whole,
            "whole_moment_bytes": 2 * whole + 4}
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_dp_phase(dev, gpu: str) -> dict:
    """Phase lm_train_dp (see the module docstring).  Returns the launch
    counts of the port's kernels over the phase (none runs on it)."""
    import gc

    import torch

    from repro_torch import parallel
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    results, wall = host_s(lambda: parallel.run_ranks(
        LM_TRAIN_DP_RANKS, lm_train_dp_rank, timeout=LM_TRAIN_DP_TIMEOUT_S))
    outs = [r.value for r in results]
    ref = outs[0]["reference"]
    failed = []
    loss_diff = max(abs(x - y) for o in outs
                    for x, y in zip(o["losses"], o["reference"]["losses"]))
    if not loss_diff <= LM_TRAIN_DP_TOL:
        failed.append(f"losses {loss_diff} from one process's > "
                      f"{LM_TRAIN_DP_TOL}")
    for o in outs:
        for key in ("params_rel", "mu_rel", "nu_rel"):
            if not o["reference"][key] <= REL_TOL:
                failed.append(f"rank {o['coord']}: {key} "
                              f"{o['reference'][key]} > {REL_TOL}")
    if len({o["params_sha256"] for o in outs}) != 1:
        failed.append("the ranks' parameters differ")
    for o in outs:
        r = o["resume"]
        loss_gap = max(abs(x - y) for x, y in zip(
            r["losses"], o["losses"][LM_TRAIN_DP_SAVE_AT:]))
        if not (r["from_step"] == LM_TRAIN_DP_SAVE_AT and r["step_equal"]
                and loss_gap <= LM_TRAIN_DP_TOL and max(
                    r[k] for k in ("params_rel", "mu_rel", "nu_rel"))
                <= REL_TOL):
            failed.append(f"rank {o['coord']} resume: {r}")
    for o in outs:
        for where in (o, o["full_depth"]):
            # the tensors' bytes exactly; the bytes they asked the caching
            # allocator for within its slack a tensor
            want = where["reckoned_optimizer_bytes"]
            slack = DRYRUN_ALLOC_SLACK * (1 + 2 * o["moments_held"])
            if where["moment_bytes"] != want or abs(
                    where["moment_bytes_requested"] - want) > slack:
                failed.append(f"rank {o['coord']}: moments "
                              f"{where['moment_bytes']} (requested "
                              f"{where['moment_bytes_requested']}), "
                              f"reckoned {want}")
        fd = o["full_depth"]
        want = fd["reckoned_params_bytes"]
        if not fd["fsdp"] or fd["params_bytes"] != want or abs(
                fd["params_bytes_requested"] - want) > (
                    DRYRUN_ALLOC_SLACK * fd["params_held"]):
            failed.append(f"rank {o['coord']}: full-depth parameters "
                          f"{fd['params_bytes']} (requested "
                          f"{fd['params_bytes_requested']}, fsdp "
                          f"{fd['fsdp']}), reckoned {want}")
    counts = launch_counts()
    emit({"phase": "lm_train_dp", "arch": LM_TRAIN_ARCH,
          "depth": LM_TRAIN_DP_DEPTH, "ranks": LM_TRAIN_DP_RANKS,
          "mesh": [LM_TRAIN_DP_RANKS, 1], "backend": "gloo",
          "global_batch": LM_TRAIN_SHAPE, "steps": LM_TRAIN_DP_STEPS,
          "world_wall_s": wall, "loss_max_abs_diff": loss_diff,
          "loss_bar": LM_TRAIN_DP_TOL, "rel_bar": REL_TOL,
          "reference": {"losses": ref["losses"],
                        "grad_norms": ref["grad_norms"],
                        **{f"rank{i}_{k}": o["reference"][k]
                           for i, o in enumerate(outs)
                           for k in ("params_rel", "mu_rel", "nu_rel")}},
          "per_rank": [{
              "coord": o["coord"], "losses": o["losses"],
              "grad_norms": o["grad_norms"], "step_ms": o["step_ms"],
              "ms_per_step": _warm_median(o["step_ms"]),
              "all_reduce_per_step": [c["all_reduce"] for c in o["collectives"]],
              "all_gather_per_step": [c["all_gather"] for c in o["collectives"]],
              "collective_host_s_per_step": [c["seconds"]
                                             for c in o["collectives"]],
              "peak_bytes": o["peak_bytes"], "moment_bytes": o["moment_bytes"],
              "moment_bytes_requested": o["moment_bytes_requested"],
              "reckoned_optimizer_bytes": o["reckoned_optimizer_bytes"],
              "moments_held": o["moments_held"], "params": o["params_total"],
              "resume": o["resume"],
              "full_depth": o["full_depth"]} for o in outs],
          "params_bitwise_equal": len({o["params_sha256"] for o in outs}) == 1,
          "gpu": gpu, "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_train_dp: {failed}")
    return counts


def _lm_train_tp_run(dev, mesh, arch: str, batches: list, opt_cfg) -> dict:
    """One trained run of phase lm_train_tp in this rank: ``arch`` at full
    width cut to LM_TRAIN_TP_DEPTH, drawn in the (2, 2) mesh's training
    layout with fsdp=True, LM_TRAIN_TP_STEPS steps of build_train_step
    (ms by CUDA events and by the host clock, gloo calls and their host
    seconds, bytes); whether the slices that two data ranks both hold are
    bitwise equal; rank 0 keeps the parameters gathered whole on the
    host for the reference."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, sharding
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_arch(arch), num_layers=LM_TRAIN_TP_DEPTH)
    with sharding.set_mesh(mesh):
        torch.cuda.synchronize()
        base = _requested_bytes()
        model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED),
                      train_mesh=mesh, fsdp=True)
        lay = model.train_layout
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        params_req = _requested_bytes() - base
        state = opt_lib.init(opt_cfg, params, lay)
        torch.cuda.synchronize()
        moments_req = _requested_bytes() - base - params_req
        step = dryrun.build_train_step(cfg, opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, host_ms, event_ms, coll = [], [], [], [], []
        for batch in batches:
            sharding.reset_collective_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            model, state, m = step(model, state, batch)
            end.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            coll.append(sharding.collective_stats())
        peak = torch.cuda.max_memory_allocated()
        # the leaves no data split covers are held alike by both data ranks
        rep = [p.detach().reshape(-1) for k, p in params.items()
               if lay.splits[k].data is None]
        mine = torch.cat(rep) if rep else torch.zeros(0, device=dev)
        theirs = sharding.all_gather_flat(mine, sharding.data_group(mesh))
        shared_bitwise = all(torch.equal(t, theirs[0]) for t in theirs)
        lead = sharding.tp_index(mesh) == 0 and sharding.dp_index(mesh) == 0
        whole = {}
        for k, p in params.items():  # every rank gathers, rank 0 keeps
            w = lay.whole(k, p.detach())
            if lead:
                whole[k] = w.cpu()
            del w
    out = {"arch": arch, "layers": cfg.num_layers, "losses": losses,
           "grad_norms": norms, "host_ms": host_ms, "event_ms": event_ms,
           "collectives": coll, "peak_bytes": peak,
           "params_bytes": sum(p.numel() * 4 for p in params.values()),
           "params_bytes_requested": params_req,
           "moment_bytes": _opt_bytes(state),
           "moment_bytes_requested": moments_req,
           "shared_bytes": mine.numel() * 4,
           "shared_bitwise": shared_bitwise, "whole": whole}
    del model, params, state, step, mine, theirs, rep
    return out


def _lm_train_tp_reference(dev, arch: str, batches: list, opt_cfg,
                           got: dict) -> dict:
    """One process on the card computing what the (2, 2) step computes:
    each data half's gradient, the two averaged, then AdamW, from the
    same seed; the run's losses, grad norms and its parameters held to
    ``got`` (gathered whole) as a share of each leaf's largest
    magnitude."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_arch(arch), num_layers=LM_TRAIN_TP_DEPTH)
    model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED))
    ref = dict(model.named_parameters())
    state = opt_lib.init(opt_cfg, ref)
    losses, norms = [], []
    for batch in batches:
        rows = batch["tokens"].shape[0]
        grads, half_losses = None, []
        for h in (slice(0, rows // 2), slice(rows // 2, rows)):
            loss, _ = model.train_loss({k: v[h] for k, v in batch.items()})
            loss.backward()
            half_losses.append(float(loss.detach()))
            if grads is None:
                grads = {k: p.grad for k, p in ref.items()}
            else:
                for k, p in ref.items():
                    grads[k] = (grads[k] + p.grad) / 2
            model.zero_grad(set_to_none=True)
        _, state, m = opt_lib.apply(opt_cfg, state, ref, grads)
        del grads
        losses.append((half_losses[0] + half_losses[1]) / 2)
        norms.append(float(m["grad_norm"]))
    rel = {k: _leaf_rel({k: got[k].to(dev)}, {k: p}) for k, p in ref.items()}
    worst = max(rel, key=rel.get)
    del model, ref, state
    return {"losses": losses, "grad_norms": norms, "params_rel": rel[worst],
            "worst_leaf": worst}


def _lm_train_tp_full_build(dev, mesh) -> dict:
    """qwen3-4b at full depth drawn in the (2, 2) mesh's training layout
    with fsdp=None (the threshold turns FSDP on) and its ZeRO-1 state, no
    step: the bytes requested against dryrun.reckon's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, sharding
    from repro_torch.train import optimizer as opt_lib

    cfg = get_arch(LM_TRAIN_TP_FULL_ARCH)
    opt_cfg = opt_lib.OptConfig(lr=3e-4, warmup_steps=20,
                                total_steps=LM_TRAIN_TP_STEPS)
    with sharding.set_mesh(mesh):
        torch.cuda.synchronize()
        base = _requested_bytes()
        t0 = time.perf_counter()
        model = Model(cfg, dev, torch.Generator(device=dev).manual_seed(LM_SEED),
                      train_mesh=mesh)
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        params_req = _requested_bytes() - base
        state = opt_lib.init(opt_cfg, params, model.train_layout)
        torch.cuda.synchronize()
        want = dryrun.reckon(cfg, "train", *LM_TRAIN_TP_FULL_SHAPE, mesh,
                             opt_cfg)
        out = {"arch": LM_TRAIN_TP_FULL_ARCH, "layers": cfg.num_layers,
               "fsdp": model.train_layout.fsdp, "build_s": build_s,
               "params_held": len(params), "moments_held": len(state.mu),
               "params_bytes": sum(p.numel() * 4 for p in params.values()),
               "params_bytes_requested": params_req,
               "moment_bytes": _opt_bytes(state),
               "moment_bytes_requested": _requested_bytes() - base - params_req,
               "reckoned_params_bytes": want["params_bytes"],
               "reckoned_optimizer_bytes": want["optimizer_bytes"],
               "whole_params_bytes": sum(
                   math.prod(sp.shape) * 4
                   for sp in model.train_layout.splits.values())}
    del model, params, state
    return out


def lm_train_tp_rank(dev) -> dict:
    """One rank of phase lm_train_tp: the trained runs of LM_TRAIN_TP_ARCHS
    on the (2, 2) mesh in f32 compute, each held to one process's halves
    run in rank 0 once the sharded state is freed; then the full-depth
    build."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch import parallel
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import layers
    from repro_torch.train import optimizer as opt_lib

    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh(LM_TRAIN_TP_MESH, ("data", "model"), dev)
    out = {"coord": [int(c) for c in mesh.get_coordinate()], "runs": []}
    b, s = LM_TRAIN_TP_SHAPE
    opt_cfg = opt_lib.OptConfig(lr=3e-4, warmup_steps=20,
                                total_steps=LM_TRAIN_TP_STEPS,
                                eps=LM_TRAIN_TP_EPS)
    for arch in LM_TRAIN_TP_ARCHS:
        pipe = TokenPipeline(get_arch(arch).vocab_size, b, s, 0)
        batches = [pipe.batch_at(i, dev) for i in range(LM_TRAIN_TP_STEPS)]
        run = _lm_train_tp_run(dev, mesh, arch, batches, opt_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        whole = run.pop("whole")
        if whole:
            run["reference"] = _lm_train_tp_reference(dev, arch, batches,
                                                       opt_cfg, whole)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        out["runs"].append(run)
    layers.COMPUTE_DTYPE = torch.bfloat16
    out["full_depth"] = _lm_train_tp_full_build(dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_tp_phase(dev, gpu: str) -> dict:
    """Phase lm_train_tp (see the module docstring).  Returns the launch
    counts of the port's kernels over the phase (none runs on it)."""
    import gc

    import torch

    from repro_torch import parallel
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    ranks = math.prod(LM_TRAIN_TP_MESH)
    results, wall = host_s(lambda: parallel.run_ranks(
        ranks, lm_train_tp_rank, timeout=LM_TRAIN_TP_TIMEOUT_S))
    outs = [r.value for r in results]
    failed, runs = [], []
    for i, arch in enumerate(LM_TRAIN_TP_ARCHS):
        ref = outs[0]["runs"][i]["reference"]
        loss_diff = max(abs(x - y) for o in outs
                        for x, y in zip(o["runs"][i]["losses"], ref["losses"]))
        if not loss_diff <= LM_TRAIN_TP_TOL:
            failed.append(f"{arch}: losses {loss_diff} from one process's "
                          f"> {LM_TRAIN_TP_TOL}")
        if not ref["params_rel"] <= REL_TOL:
            failed.append(f"{arch}: parameters {ref['params_rel']} of a "
                          f"leaf's max from one process's > {REL_TOL}")
        for o in outs:
            r = o["runs"][i]
            if not r["shared_bitwise"]:
                failed.append(f"{arch} rank {o['coord']}: the data ranks' "
                              "shared slices differ")
        runs.append({
            "arch": arch, "layers": LM_TRAIN_TP_DEPTH,
            "loss_max_abs_diff": loss_diff, "reference": ref,
            "per_rank": [{
                "coord": o["coord"], "losses": o["runs"][i]["losses"],
                "grad_norms": o["runs"][i]["grad_norms"],
                "host_ms": o["runs"][i]["host_ms"],
                "event_ms": o["runs"][i]["event_ms"],
                "all_gather_per_step": [c["all_gather"] for c in
                                        o["runs"][i]["collectives"]],
                "all_reduce_per_step": [c["all_reduce"] for c in
                                        o["runs"][i]["collectives"]],
                "reduce_scatter_per_step": [c["reduce_scatter"] for c in
                                            o["runs"][i]["collectives"]],
                "collective_host_s_per_step": [c["seconds"] for c in
                                               o["runs"][i]["collectives"]],
                "gb_params": o["runs"][i]["params_bytes"] / 1e9,
                "gb_moments": o["runs"][i]["moment_bytes"] / 1e9,
                "gb_peak": o["runs"][i]["peak_bytes"] / 1e9,
                "shared_bytes": o["runs"][i]["shared_bytes"],
                "shared_bitwise": o["runs"][i]["shared_bitwise"]}
                for o in outs]})
    for o in outs:
        fd = o["full_depth"]
        slack = DRYRUN_ALLOC_SLACK
        if not (fd["fsdp"] and fd["params_bytes"] == fd["reckoned_params_bytes"]
                and abs(fd["params_bytes_requested"]
                        - fd["reckoned_params_bytes"])
                <= slack * fd["params_held"]
                and fd["moment_bytes"] == fd["reckoned_optimizer_bytes"]
                and abs(fd["moment_bytes_requested"]
                        - fd["reckoned_optimizer_bytes"])
                <= slack * (1 + 2 * fd["moments_held"])):
            failed.append(f"rank {o['coord']} full depth: {fd}")
    counts = launch_counts()
    emit({"phase": "lm_train_tp", "mesh": list(LM_TRAIN_TP_MESH),
          "backend": "gloo", "fsdp": True, "compute": "float32",
          "global_batch": LM_TRAIN_TP_SHAPE, "steps": LM_TRAIN_TP_STEPS,
          "world_wall_s": wall, "loss_bar": LM_TRAIN_TP_TOL,
          "rel_bar": REL_TOL, "runs": runs,
          "full_depth": [o["full_depth"] for o in outs],
          "gpu": gpu, "launches": counts, "failed": failed})
    if failed:
        raise AssertionError(f"lm_train_tp: {failed}")
    return counts


def dryrun_sped_rank(dev, n: int, e: int, k: int) -> dict:
    """One rank of phase dryrun_sped: every variant of
    launch.dryrun_sped.build_step on this rank's edge slice of the
    (ranks, 1) mesh, then (rank 0) the same variant in one process (no
    mesh), both from the same seeded edges and panel: ms a step, the
    all_reduces and their bytes, the largest difference."""
    import torch
    import torch.distributed as dist

    from repro_torch import parallel
    from repro_torch.core import solvers
    from repro_torch.launch import dryrun_sped

    mesh = parallel.default_edge_mesh(device=dev)
    edges = dryrun_sped.random_edges(n, e, seed=LM_SEED, device=dev)
    v = solvers.init_state(torch.Generator(device=dev).manual_seed(LM_SEED),
                           n, k).v
    out = {}
    dryrun_sped.build_step("cheb64_fused", mesh, ("data", "model"))(v, edges)
    for variant in dryrun_sped.VARIANTS:  # timed after that one warm-up
        step = dryrun_sped.build_step(variant, mesh, ("data", "model"))
        dryrun_sped.reset_stats()
        got, ev, host = _timed(lambda: step(v, edges))
        st = dryrun_sped.stats()
        row = {"ms": ev, "host_ms": host, "all_reduce": st["all_reduce"],
               "bytes": st["bytes"], "finite": bool(torch.isfinite(got).all())}
        if dist.get_rank() == 0:
            one = dryrun_sped.build_step(variant, None, ())
            want, one_ms, _ = _timed(lambda: one(v, edges))
            row.update(one_process_ms=one_ms,
                       max_abs_err=float((got - want).abs().max()),
                       largest=float(want.abs().max()))
        out[variant] = row
    return out


def dryrun_sped_phase(dev, gpu: str) -> dict:
    """Phase dryrun_sped (see the module docstring).  Returns the launch
    counts of the port's kernels over the phase (none runs on it)."""
    import gc
    import tempfile

    import torch

    from repro_torch import parallel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun_sped
    from repro_torch.core import solvers

    reset_launch_counts()
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        (code, report_s) = host_s(lambda: dryrun_sped.main(
            ["--out", tmp, "--device", str(dev)]))
        cells = {p.stem: json.loads(p.read_text())
                 for p in Path(tmp).glob("*.json")}
    if code != 0 or len(cells) != 8:
        failed.append(f"report: exit {code}, {len(cells)} cells")
    n, e, k = DRYRUN_SPED_SMALL
    results, wall = host_s(lambda: parallel.run_ranks(
        DRYRUN_SPED_RANKS, dryrun_sped_rank, n, e, k,
        timeout=LM_TRAIN_DP_TIMEOUT_S))
    outs = [r.value for r in results]
    per_matvec = {"limit251": 2, "cheb64": 2, "cheb64_fused": 1,
                  "cheb64_bf16": 1}
    small = {}
    for variant in dryrun_sped.VARIANTS:
        r0 = outs[0][variant]
        matvecs = dryrun_sped.make_series(variant).degree + (
            0 if variant == "limit251" else 1)  # Clenshaw: degree + 1
        count = matvecs * per_matvec[variant]
        item = 2 if variant.endswith("bf16") else 4
        tol = (DRYRUN_SPED_BF16_TOL if variant.endswith("bf16")
               else REL_TOL) * r0["largest"]
        small[variant] = {"ranks": [o[variant] for o in outs],
                          "expected_all_reduce": count, "tolerance": tol}
        if not r0["max_abs_err"] <= tol:
            failed.append(f"{variant}: {r0['max_abs_err']} > {tol}")
        for o in outs:
            if (o[variant]["all_reduce"], o[variant]["bytes"]) != (
                    count, count * n * k * item) or not o[variant]["finite"]:
                failed.append(f"{variant}: {o[variant]}")
        cell = cells.get(f"sped__{variant}__pod")
        if cell is None or cell["collectives"]["count"]["all-reduce"] != count:
            failed.append(f"{variant}: the report's count")
    del results, outs
    # one cheb64_fused step at the production shape, one process
    gc.collect()
    torch.cuda.empty_cache()
    N, E, K = dryrun_sped.N_NODES, dryrun_sped.N_EDGES, dryrun_sped.K
    torch.cuda.synchronize()
    req = _requested_bytes()
    t0 = time.perf_counter()
    edges = dryrun_sped.random_edges(N, E, seed=LM_SEED, device=dev)
    v = solvers.init_state(torch.Generator(device=dev).manual_seed(LM_SEED),
                           N, K).v
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    args_requested = _requested_bytes() - req
    args = v.numel() * v.element_size() + sum(
        t.numel() * t.element_size() for t in edges.values())
    step = dryrun_sped.build_step("cheb64_fused", None, ())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, ms, host_ms = _timed(lambda: step(v, edges))
    prod = {"n": N, "num_edges": E, "k": K, "ms": ms, "host_ms": host_ms,
            "setup_s": setup_s, "argument_bytes": args,
            "argument_bytes_requested": args_requested,
            "reckoned_argument_bytes": dryrun_sped.argument_bytes(1),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_over_arguments": torch.cuda.max_memory_allocated() - base,
            "finite": bool(torch.isfinite(out).all())}
    # the report's reckoning for one device, against the bytes the panel
    # and edges asked the card's allocator for (what stays live of their
    # making), within its slack a tensor
    want_args = dryrun_sped.argument_bytes(1)
    if args != want_args or abs(args_requested - want_args) > (
            DRYRUN_ALLOC_SLACK * (1 + len(edges))):
        failed.append(f"production arguments {args} (requested "
                      f"{args_requested}), reckoned {want_args}")
    if not prod["finite"]:
        failed.append("the production step is not finite")
    del edges, v, out, step
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    emit({"phase": "dryrun_sped", "report_s": report_s,
          "cells": {t: {"count": c["collectives"]["count"]["all-reduce"],
                        "total_bytes": c["collectives"]["total_bytes"],
                        "argument_bytes": c["memory"]["argument_bytes"]}
                    for t, c in sorted(cells.items())},
          "small": {"n": n, "num_edges": e, "k": k,
                    "ranks": DRYRUN_SPED_RANKS, "world_wall_s": wall,
                    **small},
          "production": prod, "gpu": gpu, "launches": counts,
          "failed": failed})
    if failed:
        raise AssertionError(f"dryrun_sped: {failed}")
    return counts


def main() -> int:
    import numpy as np
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

    from repro_torch import parallel, spectral
    from repro_torch.core import (ClusteringConfig, SolverConfig, backend,
                                  graphs, limit_neg_exp, metrics, operators,
                                  solvers, spectral_cluster)
    from repro_torch.core import kmeans as km
    from repro_torch.core import laplacian as lap
    from repro_torch.core import baselines, walks
    from repro_torch.core import program
    from repro_torch.stream import graph_store as gstore
    from repro_torch.stream import tracking, updates, warm
    from repro_torch.stream.service import ServiceConfig, StreamingService
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.edge_spmm import ops as es_ops
    from repro_torch.kernels.edge_spmm import ref as es_ref
    from repro_torch.kernels.eg_update import ops as eg_ops
    from repro_torch.kernels.eg_update import ref as eg_ref
    from repro_torch.kernels.kmeans_dist import ops as km_ops
    from repro_torch.kernels.kmeans_dist import ref as km_ref
    from repro_torch.kernels.laplacian_poly import ops as lp_ops
    from repro_torch.kernels.laplacian_poly import ref as lp_ref

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

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
        return _held(name, kernel_fn(), plain_fn())

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

    def rect_check(label, rows_r, v_full, start, c_r, also=()):
        """K2's rectangular launch on a panel shard's owned rows (R rows
        whose own terms are v_full[start:start + R], neighbours anywhere
        in v_full) held to its plain twin and timed, with its bound:
        the CSR, the live half-edges, V once, the self rows and out."""
        r_r = rows_r.row_ptr.shape[0] - 1

        def launch():
            return es_ops.model_local_rows(rows_r, v_full, -c_r, 1.0, start)

        err_r, tol_r = compare(
            f"edge_spmm_nb (rectangular, {label})", launch,
            lambda: es_ref.edge_spmm_rows(
                rows_r.row_ptr, rows_r.other, rows_r.weight, v_full, -c_r,
                1.0, v_self=v_full[start:start + r_r]))
        for ref_label, ref_fn in also:
            compare(f"edge_spmm_nb (rectangular, {label}, {ref_label})",
                    launch, ref_fn)
        live = int(rows_r.row_ptr[-1])
        kk = v_full.shape[1]
        b_ms, b_by = bound((r_r + 1) * 4 + live * 8
                           + v_full.shape[0] * kk * 4 + 2 * r_r * kk * 4,
                           live * kk * 2 + 4 * r_r * kk)
        counts_r = rows_r.row_ptr[1:] - rows_r.row_ptr[:-1]
        out = {"shape": label, "rows": r_r, "panel_rows": v_full.shape[0],
               "k": kk, "live_half_edges": live,
               "longest_row": int(counts_r.max()),
               "hub_rows": int((rows_r.hub_rows < r_r).sum()),
               "max_abs_err": err_r, "tolerance": tol_r,
               "ms": cuda_ms(launch, 20), "bound_ms": b_ms,
               "bound_by": b_by,
               "bitwise_repeatable": bool(torch.equal(launch(), launch()))}
        emit({"phase": "check_rectangular", **out})
        if not out["bitwise_repeatable"]:
            raise AssertionError(f"edge_spmm_nb (rectangular, {label}): two "
                                 "calls differ")
        return out

    # K2's rectangular launch: the owned rows of shard 1 of 2 of this graph
    # (its self rows start at row 2^19), held also to the square launch
    rows_r1 = es_ops.build_model_shard_rows(g.src, g.dst, g.weight, n, 2, 1)
    kernels["edge_spmm_nb"]["rectangular"] = [rect_check(
        "sparse SBM 2^20, shard 1 of 2", rows_r1, v, n // 2, c,
        also=[("square launch",
               lambda: es_ops.edge_spmm_rows_nb(rows, v, -c, 1.0)[n // 2:])])]
    del rows_r1

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
                       lambda: lp_ref.dense_matvec_panel(ld, vd)), graphs=True)
    check("dense_matvec_panel",
          lambda: lp_ops.dense_matvec_panel(ld, vd),
          lambda: lp_ref.dense_matvec_panel(ld, vd),
          lambda: ld @ vd,
          nbytes=nd * nd * 4 + 2 * nd * k * 4, flops=2 * nd * nd * k,
          reps=50, replaces="src/repro/kernels/laplacian_poly/kernel.py:80",
          source="src/repro_torch/csrc/laplacian_poly.cu", graphs=True)
    del ld  # rebuilt in phase 5; phase 4's peak memory leaves it out

    # kmeans_dist at the benchmark's k-means: 2^22 rows of a row-normalised
    # (n, 30) embedding, 30 centres drawn from it; its 3 n m d operations
    # are each an FP32 instruction, worth an FMA's two flops of the peak.
    # It sums in torch.sum's order, so it is held to its twin bit for bit.
    nk, mk = 1 << 22, 30
    gen_k = torch.Generator(device=dev).manual_seed(9)
    xk = torch.nn.functional.normalize(
        torch.randn((nk, mk), generator=gen_k, device=dev), dim=1)
    ck = xk[torch.randint(0, nk, (mk,), generator=gen_k, device=dev)]
    prev_k = km_ref.nearest(xk, ck[1:])[0]
    check("kmeans_dist",
          lambda: km_ops.nearest(xk, ck)[0], lambda: km_ref.nearest(xk, ck)[0],
          lambda: torch.min(torch.cdist(xk, ck), dim=1),
          nbytes=4 * nk * mk + 12 * nk + 4 * mk * mk, flops=6 * nk * mk * mk,
          reps=20, replaces="none: repro's k-means is plain jnp",
          source="src/repro_torch/csrc/kmeans_dist.cu")
    kb_ms, kb_by = bound(4 * nk * mk + 8 * nk + 4 * mk, 6 * nk * mk)
    kernels["kmeans_dist"]["running_min"] = {
        "m": 1, "ms": cuda_ms(lambda: km_ops.running_min(xk, ck[:1], prev_k), 20),
        "plain_ms": cuda_ms(lambda: km_ref.running_min(xk, ck[:1], prev_k), 20),
        "bound_ms": kb_ms, "bound_by": kb_by}
    # and at phase 4's (2^20, 10) panel with 10 centres of its rows
    xf = panel(n, k, 8)
    held_k = {}
    for label, xs, cs, ps in (("benchmark", xk, ck, prev_k),
                              ("full run", xf, xf[:k], None)):
        got, want = km_ops.nearest(xs, cs), km_ref.nearest(xs, cs)
        held_k[label] = {
            "shape": list(xs.shape) + [cs.shape[0]],
            "min_bitwise": bool(torch.equal(got[0], want[0])),
            "argmin_equal": bool(torch.equal(got[1], want[1])),
            "running_bitwise": bool(torch.equal(
                km_ops.running_min(xs, cs[:1], ps),
                km_ref.running_min(xs, cs[:1], ps))),
            "bitwise_repeatable": bool(
                torch.equal(got[0], km_ops.nearest(xs, cs)[0])
                and torch.equal(got[1], km_ops.nearest(xs, cs)[1]))}
    kernels["kmeans_dist"]["held"] = held_k
    emit({"phase": "check", "name": "kmeans_dist",
          "running_min": kernels["kmeans_dist"]["running_min"], "held": held_k})
    for label, row in held_k.items():
        if not all(v for v in row.values() if isinstance(v, bool)):
            raise AssertionError(f"kmeans_dist ({label}) is not its twin "
                                 f"bit for bit: {row}")
    del xk, ck, prev_k, xf

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
    for name in ("edge_spmm_nb", "gram2k", "panel_mix", "kmeans_dist"):
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

    # ---- 8. minibatch estimator, small (one K1 launch per drawn factor) ----
    gm, truth_m = graphs.clique_graph(120, 3, seed=4, device=dev)
    cfg_ms = ClusteringConfig(
        num_clusters=3, transform="limit_neg_exp", degree=51,
        estimation="minibatch", batch_edges=512,
        solver=SolverConfig(method="mu_eg", lr=0.1, steps=1500, eval_every=250),
        seed=0)
    reset_launch_counts()
    (labels_ms, _), mb_small_s = host_s(lambda: spectral_cluster(gm, cfg_ms))
    counts_mb_small = launch_counts()
    agreement_ms = float(km.cluster_agreement(labels_ms, truth_m, 3))
    emit({"phase": "minibatch_small", "n": 120, "num_edges": gm.num_edges,
          "batch_edges": 512, "degree": 51, "solver_steps": 1500,
          "seconds": mb_small_s, "agreement": agreement_ms,
          "us_per_factor": mb_small_s / counts_mb_small["edge_spmm"] * 1e6,
          "launches": counts_mb_small})
    if not agreement_ms > STOCHASTIC_AGREEMENT:
        raise AssertionError(f"minibatch clique agreement {agreement_ms} <= "
                             f"{STOCHASTIC_AGREEMENT}")
    if counts_mb_small["edge_spmm"] != 1500 * 51:
        raise AssertionError(f"minibatch run launched K1 "
                             f"{counts_mb_small['edge_spmm']} times, not one per "
                             f"drawn factor ({1500 * 51})")
    for name in ("gram2k", "panel_mix"):
        if counts_mb_small[name] <= 0:
            raise AssertionError(f"minibatch small run launched no {name}")

    # ---- 9. minibatch estimator at full size ------------------------------
    batch_full = 65_536
    cfg_mf = ClusteringConfig(num_clusters=8, degree=251,
                              estimation="minibatch", batch_edges=batch_full,
                              solver=SolverConfig(steps=10, eval_every=10),
                              seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (labels_mf, info_mf), mb_full_s = host_s(lambda: spectral_cluster(g, cfg_mf))
    counts_mb_full = launch_counts()
    peak_mf = torch.cuda.max_memory_allocated()
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_mb_full[name] <= 0:
            raise AssertionError(f"full-size minibatch run launched no {name}")
    eig_mf = info_mf["eigvecs"]
    if not (labels_mf.shape == (n,) and eig_mf.shape == (n, k)
            and bool(torch.isfinite(eig_mf).all())
            and int(labels_mf.min()) >= 0 and int(labels_mf.max()) < 8):
        raise AssertionError("full-size minibatch run gave malformed output")
    col_norm_mf = float((torch.linalg.vector_norm(eig_mf, dim=0) - 1).abs().max())
    if not col_norm_mf <= 1e-4:
        raise AssertionError(f"minibatch eigvec columns off unit norm by "
                             f"{col_norm_mf}")
    e_full = g.num_edges
    st_mf = solvers.init_from_panel(eig_mf)
    u_mf = st_mf.v

    def device_profile(fn, reps: int = 20) -> dict:
        """Device operations and device-busy ms per call of ``fn`` from a
        torch.profiler trace (kernels, copies and sets on the card)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return {"device_ops": len(ops) / reps,
                "device_busy_ms": sum(e.time_range.elapsed_us()
                                      for e in ops) / 1e3 / reps}

    def factor_split(batch: int) -> dict:
        """One drawn factor's pieces, each in CUDA events on the full
        graph: the draw and gather of one call's (degree + 1, B) batches
        (per factor), the batch's row-CSR build, K1 on it, the AXPY; the
        operator call itself per factor; the factor and the build replayed
        from a CUDA graph (their card time without the host's launches);
        and the factor's device operations and busy time in a trace."""
        gen = torch.Generator(device=dev).manual_seed(5)
        scale = e_full / batch

        def draw_gather():
            sel = torch.randint(0, e_full, (252, batch), generator=gen,
                                device=dev)
            return g.src[sel].long(), g.dst[sel].long(), g.weight[sel] * scale

        src_b, dst_b, w_b = draw_gather()
        rows_b = es_ops.build_edge_rows(src_b[0], dst_b[0], w_b[0], n)
        lu = es_ops.edge_spmm_rows(rows_b, u_mf)
        s_b = limit_neg_exp(251, scale=8.0 / rho)
        c_b = 8.0 / rho / 251
        op_b = operators.minibatch_operator(g, s_b, batch, backend="kernel")

        def factor():
            return u_mf - c_b * es_ops.edge_spmm(src_b[0], dst_b[0], w_b[0], u_mf)

        return {
            "batch_edges": batch,
            "draw_gather_ms": cuda_ms(draw_gather, 10) / 251,
            "row_csr_build_ms": cuda_ms(lambda: es_ops.build_edge_rows(
                src_b[0], dst_b[0], w_b[0], n), 20),
            "k1_ms": cuda_ms(lambda: es_ops.edge_spmm_rows(rows_b, u_mf), 20),
            "axpy_ms": cuda_ms(lambda: u_mf - c_b * lu, 20),
            "factor_ms": cuda_ms(factor, 20),
            "operator_ms_per_factor": cuda_ms(lambda: op_b(gen, u_mf), 2) / 251,
            "factor_graph_ms": graph_ms(factor, calls=50),
            "row_csr_build_graph_ms": graph_ms(lambda: es_ops.build_edge_rows(
                src_b[0], dst_b[0], w_b[0], n), calls=50),
            "factor_trace": device_profile(factor),
            "hub_rows": int((rows_b.hub_rows < n).sum()),
            "longest_row": int((rows_b.row_ptr[1:] - rows_b.row_ptr[:-1]).max()),
        }, (src_b[0], dst_b[0], rows_b)

    split_full, (src_b, dst_b, rows_b) = factor_split(batch_full)
    split_small_b, _ = factor_split(1024)
    # K1 on one drawn batch of the full graph against its plain twin; its
    # bound: the batch's edges (12 B each), the rows of V it touches, and
    # the (n, k) output written once
    mb_err, mb_tol = compare(
        "edge_spmm (minibatch batch)",
        lambda: es_ops.edge_spmm_rows(rows_b, u_mf),
        lambda: es_ref.edge_spmm_rows(rows_b.row_ptr, rows_b.other,
                                      rows_b.weight, u_mf, 1.0, 0.0))
    touched = int(torch.unique(torch.cat([src_b, dst_b])).numel())
    mb_bound, mb_bound_by = bound(batch_full * 12 + touched * k * 4
                                  + n * k * 4, batch_full * k * 6)
    op_mf = operators.minibatch_operator(g, limit_neg_exp(251, scale=8.0 / rho),
                                         batch_full, backend="kernel")
    gen_mf = torch.Generator(device=dev).manual_seed(6)
    step_mf_ms = cuda_ms(lambda: step_fn(st_mf, op_mf(gen_mf, st_mf.v), 1e-3), 3)
    emit({"phase": "minibatch_full", "n": n, "num_edges": e_full, "k": k,
          "degree": 251, "solver_steps": 10, "batch_edges": batch_full,
          "batch_fraction": batch_full / e_full,
          "spectral_cluster_s": mb_full_s, "solver_step_ms": step_mf_ms,
          "factor_split": split_full, "factor_split_b1024": split_small_b,
          "k1_batch_max_abs_err": mb_err, "k1_batch_tolerance": mb_tol,
          "k1_batch_ms": split_full["k1_ms"], "k1_batch_bound_ms": mb_bound,
          "k1_batch_bound_by": mb_bound_by, "k1_batch_touched_rows": touched,
          "max_memory_allocated": peak_mf, "col_norm_err": col_norm_mf,
          "agreement": float(km.cluster_agreement(labels_mf, truth, 8)),
          "launches": counts_mb_full})
    del op_mf, st_mf, u_mf, rows_b, src_b, dst_b

    # ---- 10. walk estimator, small (K3/K4 solve, plain-torch walks) --------
    inc_s, inc_host_s = host_s(lambda: lap.build_edge_incidence(gs))
    wb_s = walks.sample_walks(torch.Generator(device=dev).manual_seed(4), inc_s,
                              4096, 6)
    log_pmin = -5 * float(torch.log(torch.tensor(float(inc_s.deg_star_inc)))) \
        - float(torch.log(torch.tensor(float(gs.num_edges))))
    walks_proper = bool(torch.all(wb_s.alpha != 0)) and set(
        wb_s.alpha[:, 1].unique().tolist()) <= {-1.0, 1.0, 2.0} and bool(
        torch.all(wb_s.logp[:, -1] >= log_pmin - 1e-4))
    if not walks_proper:
        raise AssertionError("walks sampled on the card are not proper")
    cfg_ws = ClusteringConfig(
        num_clusters=4, estimation="walks", degree=251, num_walkers=4096,
        solver=SolverConfig(method="mu_eg", lr=0.05, steps=600, eval_every=100),
        seed=0)
    reset_launch_counts()
    (labels_ws, info_ws), walks_s = host_s(lambda: spectral_cluster(gs, cfg_ws))
    counts_walks = launch_counts()
    agreement_ws = float(km.cluster_agreement(labels_ws, truth_s, 4))
    rho_s = float(lap.spectral_radius_upper_bound(gs))
    op_w = walks.walk_polynomial_operator(
        gs, inc_s, walks.lowdeg_negexp_coeffs(6, rho_s, 8.0 / rho_s), 0.0, 4096)
    st_w = solvers.init_from_panel(info_ws["eigvecs"])
    gen_w = torch.Generator(device=dev).manual_seed(7)
    walk_op_ms = cuda_ms(lambda: op_w(gen_w, st_w.v), 20)
    walk_step_ms = cuda_ms(lambda: step_fn(st_w, op_w(gen_w, st_w.v), 0.05), 20)
    emit({"phase": "walks_small", "n": 160, "num_edges": gs.num_edges,
          "degree": 6, "num_walkers": 4096, "solver_steps": 600,
          "incidence_host_s": inc_host_s,
          "incidence_width": int(inc_s.nbrs.shape[1]),
          "spectral_cluster_s": walks_s, "operator_ms": walk_op_ms,
          "solver_step_ms": walk_step_ms, "agreement": agreement_ws,
          "plan": info_ws["plan"], "launches": counts_walks})
    if not agreement_ws > STOCHASTIC_AGREEMENT:
        raise AssertionError(f"walks clique agreement {agreement_ws} <= "
                             f"{STOCHASTIC_AGREEMENT}")
    for name in ("gram2k", "panel_mix"):
        if counts_walks[name] != 600:
            raise AssertionError(f"walks run launched {name} "
                                 f"{counts_walks[name]} times, not 600")

    # ---- 11. baselines (dense Bethe Hessian; Lanczos and CG on K2) ---------
    gb, truth_b = graphs.sbm_graph(180, 3, p_in=0.25, p_out=0.01, seed=0,
                                   device=dev)
    (labels_b, info_b), bethe_s = host_s(
        lambda: baselines.bethe_hessian_cluster(gb, 3))
    agreement_b = float(km.cluster_agreement(labels_b, truth_b, 3))
    if not (agreement_b > BETHE_AGREEMENT
            and info_b["negative_eigs"] >= BETHE_NEGATIVE_EIGS):
        raise AssertionError(f"Bethe Hessian: agreement {agreement_b}, "
                             f"{info_b['negative_eigs']} negative eigenvalues")
    # the row CSR the kernel path builds; K2 past 4096
    rows_g = es_ops.build_edge_rows(g.src, g.dst, g.weight, n)
    fused_g = backend.rows_fused_step(rows_g)
    in_k2 = [0.0]

    def k2_matvec(x):
        t0 = time.perf_counter()
        out = fused_g(x, 1.0, 0.0)
        sync()
        in_k2[0] += time.perf_counter() - t0
        return out

    reset_launch_counts()
    (lam_l, vec_l), lanczos_s = host_s(lambda: baselines.lanczos_bottom_k(
        k2_matvec, n, k, iters=64, seed=0, device=dev))
    lanczos_k2_s = in_k2[0]
    si_op = baselines.shift_invert_operator(lambda x: fused_g(x, 1.0, 0.0),
                                            shift=0.05, cg_iters=50)
    v_si = panel(n, k, 8)
    si_out, shift_invert_s = host_s(lambda: si_op(v_si))
    counts_baselines = launch_counts()
    resid_l = float(torch.linalg.vector_norm(
        fused_g(vec_l, 1.0, 0.0) - vec_l * lam_l[None, :], dim=0).max())
    if not (bool(torch.isfinite(lam_l).all()) and bool(torch.isfinite(si_out).all())
            and counts_baselines["edge_spmm_nb"] == 64 + 51):
        raise AssertionError(f"baselines at n = {n}: lanczos {lam_l}, "
                             f"launches {counts_baselines}")
    # Lanczos hands K2 (n,) vectors, its k = 1 body: held to the twin on
    # the same row CSR, and the whole Lanczos run to one over the plain
    # segment matvec from the same numpy start vector
    q_l = panel(n, 1, 10)[:, 0]
    vec_err, vec_tol = compare(
        "edge_spmm_nb on an (n,) vector", lambda: fused_g(q_l, 1.0, 0.0),
        lambda: es_ref.edge_spmm_rows(rows_g.row_ptr, rows_g.other,
                                      rows_g.weight, q_l[:, None], 1.0,
                                      0.0)[:, 0])
    lam_seg, _ = baselines.lanczos_bottom_k(
        lambda x: lap.edge_matvec_arrays(g.src, g.dst, g.weight, x), n, k,
        iters=64, seed=0, device=dev)
    lanczos_gap = float((lam_l - lam_seg).abs().max())
    if not lanczos_gap <= LANCZOS_TOL:
        raise AssertionError(f"Lanczos on K2 vs segment: eigenvalues "
                             f"{lam_l.tolist()} vs {lam_seg.tolist()}")
    emit({"phase": "baselines", "bethe_n": 180, "bethe_agreement": agreement_b,
          "bethe_negative_eigs": info_b["negative_eigs"], "bethe_r": info_b["r"],
          "bethe_s": bethe_s, "n": n, "k": k, "lanczos_iters": 64,
          "lanczos_s": lanczos_s, "lanczos_k2_s": lanczos_k2_s,
          "lanczos_host_share": 1.0 - lanczos_k2_s / lanczos_s,
          "lanczos_eigs": lam_l.tolist(), "lanczos_max_residual": resid_l,
          "k2_vector_max_abs_err": vec_err, "k2_vector_tolerance": vec_tol,
          "lanczos_vs_segment_max_abs_diff": lanczos_gap,
          "shift_invert_cg_iters": 50, "shift_invert_s": shift_invert_s,
          "shift_invert_ms": cuda_ms(lambda: si_op(v_si), 2),
          "launches": counts_baselines})
    del si_out, v_si, vec_l, rows_g, fused_g, q_l

    # ---- 12. streaming state, bench_stream.py's configuration --------------
    def churn_batches(graph, batch, seed=1):
        """bench_stream.py's _perturb_one_percent: delete E/200 random edges
        and insert E/200 random pairs, as canonical batches of ``batch``
        entries (deletes first) for the store."""
        rng = np.random.default_rng(seed)
        e = graph.num_edges
        m = max(e // 200, 1)
        src, dst = graph.src.cpu().numpy(), graph.dst.cpu().numpy()
        gone = rng.choice(e, size=m, replace=False)
        add = np.sort(rng.integers(0, graph.num_nodes, size=(m, 2)).astype(
            np.int32), axis=1)
        add = add[add[:, 0] != add[:, 1]]
        pairs = np.concatenate([np.stack([src[gone], dst[gone]], 1), add])
        ws = np.concatenate([np.zeros(m), np.ones(len(add))])
        return [gstore.coalesce_batch(pairs[i:i + batch], ws[i:i + batch],
                                      pad_to=batch, device=dev)
                for i in range(0, len(pairs), batch)], 2 * m

    def dilated(store, c_scale=1.0):
        """The store's captured dilated operator (I - c L)^15 at c =
        c_scale * strength / rho / degree, rho the store's Gershgorin
        bound, over its cached row CSR."""
        store, rho_st = gstore.spectral_radius_upper_bound(store)
        c_st = c_scale * STREAM_STRENGTH / float(rho_st) / STREAM_DEGREE
        return store, c_st, operators.dilated_step_operator(
            gstore.fused_step(store), c_st, STREAM_DEGREE, capture=True)

    def held_to_plain(label, store, c_st, op, v, lr):
        """The store's dilated operator (K1/K2) against the segment loop
        on the run's panel V, then K3 and K4 against their twins on that
        V and AV: the shapes the streaming solve gave them."""
        errs = {"dilated": compare(
            f"{label}: dilated operator vs segment", lambda: op(v),
            lambda: operators.dilated_operator_arrays(
                store.src, store.dst, store.weight, c_st, STREAM_DEGREE,
                backend="segment")(v))[0]}
        return {**errs, **_held_eg(label, v, op(v), lr)}

    n_ss, k_ss = 10_000, 8
    g_ss, _ = graphs.sparse_sbm_graph(n_ss, 10, avg_degree_in=10.0,
                                      avg_degree_out=1.0, seed=0, device=dev)
    cfg_w = warm.WarmConfig(tol=STREAM_TOL, chunk=10, max_steps=5000, lr=0.3)
    store_s = gstore.from_edge_list(g_ss)
    batches_s, churned_s = churn_batches(g_ss, 256)
    reset_launch_counts()
    store_s, _, op_cold = dilated(store_s)
    gen_ss = torch.Generator(device=dev).manual_seed(0)
    (state_ss, cold_ss), cold_ss_s = host_s(lambda: warm.reconverge(
        gen_ss, op_cold, n_ss, k_ss, cfg_w))
    stats_s = [0, 0, 0]
    for b in batches_s:
        store_s, _, st_b = gstore.apply_edge_batch(store_s, b)
        stats_s = [a + int(x) for a, x in zip(stats_s, st_b)]
    _, rows_ss_s = host_s(lambda: gstore.edge_rows(store_s))
    store_s, c_ss, op_warm = dilated(store_s)
    (warm_state_ss, warm_ss), warm_ss_s = host_s(lambda: warm.reconverge(
        gen_ss, op_warm, n_ss, k_ss, cfg_w, v_prev=state_ss.v))
    counts_stream_small = launch_counts()
    errs_ss = held_to_plain("stream_small", store_s, c_ss, op_warm,
                            warm_state_ss.v, cfg_w.lr)
    # the residual the warm re-solve starts from (reconverge's info keeps
    # only the final one)
    warm_start_ss = float(metrics.operator_residual(
        op_warm, solvers.init_from_panel(state_ss.v).v))
    emit({"phase": "stream_small", "n": n_ss, "num_edges": g_ss.num_edges,
          "capacity": store_s.capacity, "k": k_ss, "degree": STREAM_DEGREE,
          "strength": STREAM_STRENGTH, "churned": churned_s,
          "batches": len(batches_s), "matched_inserted_dropped": stats_s,
          "cold_iterations": cold_ss["iterations"],
          "cold_residual": cold_ss["residual"], "cold_s": cold_ss_s,
          "warm": warm_ss["warm"], "warm_start_residual": warm_start_ss,
          "warm_iterations": warm_ss["iterations"],
          "warm_residual": warm_ss["residual"], "warm_s": warm_ss_s,
          "iteration_ratio": cold_ss["iterations"] / max(warm_ss["iterations"],
                                                        cfg_w.chunk),
          "row_csr_rebuild_host_s": rows_ss_s, "max_abs_err": errs_ss,
          "apply_b256_ms": cuda_ms(lambda: gstore.apply_edge_batch(
              store_s, batches_s[0]), 20),
          "launches": counts_stream_small})
    if not (warm_ss["residual"] <= STREAM_TOL
            and warm_ss["iterations"] < cold_ss["iterations"]):
        raise AssertionError(f"stream_small: warm {warm_ss} vs cold {cold_ss}")
    del store_s, state_ss, warm_state_ss, op_cold, op_warm

    # ---- 13. streaming state at full width (2^20 nodes, capacity 2^24) -----
    store_f, admit_s = host_s(lambda: gstore.from_edge_list(g))
    batches_f, churned_f = churn_batches(g, 4096)
    b256 = gstore.coalesce_batch(
        np.stack([batches_f[0].src[:256].cpu().numpy(),
                  batches_f[0].dst[:256].cpu().numpy()], 1),
        np.zeros(256), pad_to=256, device=dev)
    apply_ms = {bsz: cuda_ms(lambda: gstore.apply_edge_batch(store_f, b), 10)
                for bsz, b in ((256, b256), (4096, batches_f[0]))}
    sync()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    applied = gstore.apply_edge_batch(store_f, batches_f[0])
    sync()
    apply_peak = torch.cuda.max_memory_allocated() - base_bytes
    del applied
    dirty, dw256, _ = gstore.apply_edge_batch(store_f, b256)
    if not apply_peak < APPLY_PEAK_BYTES:
        raise AssertionError(f"one apply at capacity {store_f.capacity} took "
                             f"{apply_peak} bytes")
    refresh_ms = cuda_ms(lambda: gstore.refresh_degrees(dirty), 10)
    rebuild_ms = cuda_ms(lambda: es_ops.build_edge_rows(
        store_f.src, store_f.dst, store_f.weight, n), 5)
    store_f, c_f, dil = dilated(store_f)
    _, c_half, dil_half = dilated(store_f, 0.5)
    v_f = panel(n, k, 9)
    out_c = [dil(v_f), dil_half(v_f)]
    dil_err, dil_tol = compare(
        "dilated operator (K2 graph vs segment)", lambda: dil(v_f),
        lambda: operators.dilated_operator_arrays(
            store_f.src, store_f.dst, store_f.weight, c_f, STREAM_DEGREE,
            backend="segment")(v_f))
    compare("dilated operator at c / 2 (K2 graph vs segment)",
            lambda: dil_half(v_f),
            lambda: operators.dilated_operator_arrays(
                store_f.src, store_f.dst, store_f.weight, c_half, STREAM_DEGREE,
                backend="segment")(v_f))
    c_gap = float((out_c[0] - out_c[1]).abs().max())
    if not c_gap > 0:
        raise AssertionError("the dilated operator gives one answer at two c")
    dil_ms = cuda_ms(lambda: dil(v_f), 10)
    est_f = updates.anchor_estimate(gstore.fused_step(store_f), v_f)
    fou_ms = cuda_ms(lambda: updates.first_order_update(
        est_f, b256.src, b256.dst, dw256), 10)
    drift_f = float(updates.first_order_update(est_f, b256.src, b256.dst,
                                               dw256).drift)
    cfg_f = warm.WarmConfig(tol=STREAM_TOL, chunk=10, max_steps=200, lr=0.3)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _, _, op_cf = dilated(store_f)
    gen_f = torch.Generator(device=dev).manual_seed(0)
    (state_f, cold_f), cold_f_s = host_s(lambda: warm.reconverge(
        gen_f, op_cf, n, k, cfg_f))
    apply_f_s = 0.0
    for b in batches_f:
        (store_f, _, _), s_b = host_s(lambda: gstore.apply_edge_batch(store_f, b))
        apply_f_s += s_b
    store_f, _, op_wf = dilated(store_f)
    (_, warm_f), warm_f_s = host_s(lambda: warm.reconverge(
        gen_f, op_wf, n, k, cfg_f, v_prev=state_f.v))
    counts_stream_full = launch_counts()
    warm_start_f = float(metrics.operator_residual(
        op_wf, solvers.init_from_panel(state_f.v).v))
    peak_stream = torch.cuda.max_memory_allocated()
    emb_f = state_f.v / torch.clamp(torch.linalg.vector_norm(
        state_f.v, dim=1, keepdim=True), min=1e-12)
    labels_1 = km.kmeans(torch.Generator(device=dev).manual_seed(1), emb_f, 8).labels
    labels_2 = km.kmeans(torch.Generator(device=dev).manual_seed(2), emb_f, 8).labels
    tracker = tracking.LabelTracker(8)
    tracker.update(labels_1)
    stable, track_s = host_s(lambda: tracker.update(labels_2))
    emit({"phase": "stream_full", "n": n, "num_edges": g.num_edges,
          "capacity": store_f.capacity, "k": k, "degree": STREAM_DEGREE,
          "strength": STREAM_STRENGTH, "admit_s": admit_s,
          "apply_b256_ms": apply_ms[256], "apply_b4096_ms": apply_ms[4096],
          "apply_peak_bytes": apply_peak, "refresh_degrees_ms": refresh_ms,
          "row_csr_rebuild_ms": rebuild_ms, "dilated_operator_ms": dil_ms,
          "dilated_max_abs_err": dil_err, "dilated_tolerance": dil_tol,
          "dilated_two_c_max_abs_diff": c_gap,
          "first_order_update_b256_ms": fou_ms, "first_order_drift": drift_f,
          "cold_iterations": cold_f["iterations"],
          "cold_residual": cold_f["residual"], "cold_s": cold_f_s,
          "churned": churned_f, "churn_batches": len(batches_f),
          "churn_apply_host_s": apply_f_s, "warm": warm_f["warm"],
          "warm_start_residual": warm_start_f,
          "warm_iterations": warm_f["iterations"],
          "warm_residual": warm_f["residual"], "warm_s": warm_f_s,
          "max_memory_allocated": peak_stream,
          "label_tracker_s": track_s,
          "label_churn_after_matching": tracking.label_churn(labels_1, stable),
          "label_churn_raw": tracking.label_churn(labels_1, labels_2),
          "launches": counts_stream_full})
    if not (np.isfinite(warm_f["residual"]) and np.isfinite(cold_f["residual"])):
        raise AssertionError(f"stream_full residuals {cold_f} / {warm_f}")
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_stream_full[name] <= 0:
            raise AssertionError(f"stream_full launched no {name}")
    del store_f, dil, dil_half, out_c, est_f, state_f, op_cf, op_wf

    # ---- 14. the streaming service: bench_stream.py's mixed fleet --------
    fleet_cfg = ServiceConfig(k=6, num_clusters=4, degree=15, steps_per_tick=5,
                              lr=0.3, tol=2e-3, dilation_strength=8.0,
                              max_tick_multiplier=16, seed=0)
    fleet = [(f"fast{i}", *graphs.sbm_graph(FLEET_N, 4, p_in=0.35, p_out=0.01,
                                            seed=i, device=dev))
             for i in range(FLEET_FAST)]
    fleet += [(f"slow{i}", *graphs.sbm_graph(FLEET_N, 4, p_in=0.12,
                                             p_out=0.04, seed=100 + i,
                                             device=dev))
              for i in range(FLEET_SLOW)]
    fleet_runs = {}
    reset_launch_counts()
    for schedule in ("round_robin", "residual_decay"):
        svc = StreamingService(dataclasses.replace(fleet_cfg,
                                                   tick_schedule=schedule))
        for sid, g_t, _ in fleet:
            svc.add_graph(sid, g_t, edge_capacity=FLEET_CAPACITY)
        ticks, wall = host_s(lambda: svc.run_until_converged(max_ticks=600))
        residuals = {sid: svc.session_info(sid)["residual"]
                     for sid, _, _ in fleet}
        fleet_runs[schedule] = {
            "service": svc, "ticks": ticks, "wall_s": wall,
            "tick_invocations": svc.tick_invocations,
            "device_work_steps": svc.device_work,
            "multiplied_ticks": svc.multiplied_ticks,
            "captures": sum(p.captures for p in svc._compiled.values()),
            "programs": svc.compile_count,
            "layout_fills": svc.layout_fills,
            "ms_per_invocation": wall / max(svc.tick_invocations, 1) * 1e3,
            "converged": svc.all_converged,
            "max_residual": max(residuals.values()),
            "degrees": sorted({key[1] for key, _ in svc._compiled})}
    counts_service_small = launch_counts()
    for schedule, run in fleet_runs.items():
        svc = run.pop("service")
        run["agreement"] = float(np.mean([
            float(km.cluster_agreement(torch.from_numpy(svc.labels(sid)),
                                       lab, fleet_cfg.num_clusters))
            for sid, _, lab in fleet]))
        if not (run["converged"] and run["max_residual"] <= fleet_cfg.tol):
            raise AssertionError(f"service_small {schedule}: {run}")
        if run["captures"] != run["programs"]:
            raise AssertionError(f"service_small {schedule}: {run['captures']} "
                                 f"captures for {run['programs']} programs")
    # a kernel tick against the segment tick (the plain twins) on the same
    # inputs: the admitted fleet's stores, panels, c and lr, budgets 1 and 2
    svc = StreamingService(fleet_cfg)
    for sid, g_t, _ in fleet:
        svc.add_graph(sid, g_t, edge_capacity=FLEET_CAPACITY)
    members = list(svc._sessions.values())
    deg_f = svc._session_degree(members[0])
    if any(svc._session_degree(m) != deg_f for m in members):
        raise AssertionError("service_small: the fleet spans two degrees")
    rows_f = [gstore.edge_rows(m.store) for m in members]
    cs_f = [program.dilation_scale(m.plan, deg_f) for m in members]
    vs_f = torch.stack([m.v for m in members])
    lrs_f = [m.lr for m in members]
    chunks_f = [1 + i % 2 for i in range(len(members))]
    sched_f = program.StepSchedule(degree=deg_f, steps=fleet_cfg.steps_per_tick,
                                   backend="kernel")
    prog_f = program.build_tick_program(sched_f)
    prog_f(rows_f, cs_f, vs_f, lrs_f, chunks_f)  # eager run and capture
    seg_f = program.build_tick_program(
        dataclasses.replace(sched_f, backend="segment"))
    tick_errs = [compare(
        f"service_small tick ({label}) vs segment",
        lambda j=j: prog_f(rows_f, cs_f, vs_f, lrs_f, chunks_f)[j],
        lambda j=j: seg_f(rows_f, cs_f, vs_f, lrs_f, chunks_f)[j])[0]
        for j, label in enumerate(("panels", "residuals"))]
    replay_ms = cuda_ms(lambda: prog_f(rows_f, cs_f, vs_f, lrs_f, chunks_f), 5)
    emit({"phase": "service_small", "tenants": len(fleet), "n": FLEET_N,
          "edge_capacity": FLEET_CAPACITY, "k": fleet_cfg.k,
          "steps_per_tick": fleet_cfg.steps_per_tick, "degree": deg_f,
          **fleet_runs,
          "tick_invocations_rr_over_scheduled": (
              fleet_runs["round_robin"]["tick_invocations"]
              / max(fleet_runs["residual_decay"]["tick_invocations"], 1)),
          "kernel_vs_segment_max_abs_err": tick_errs,
          "replayed_tick_ms_budgets_1_2": replay_ms,
          "launches": counts_service_small})
    del svc, members, rows_f, vs_f, prog_f, seg_f

    # ---- 15. the streaming service at full width ---------------------------
    def tenant_graph(i):
        """Phase 4's graph under a seeded node permutation, weights
        x (1 + i/2): c differs per tenant, and rows of two tenants that
        mix up show."""
        perm = torch.randperm(n, generator=torch.Generator(device=dev)
                              .manual_seed(1000 + i), device=dev)
        s_t, d_t = perm[g.src.long()], perm[g.dst.long()]
        return lap.EdgeList(torch.minimum(s_t, d_t).int(),
                            torch.maximum(s_t, d_t).int(),
                            g.weight * (1.0 + i / 2.0), n)

    # round_robin keeps the 3 ticks at occupancy 4: the residual-decay
    # scheduler may sub-batch tenants whose forecasts differ into smaller
    # occupancies (programs of their own), which service_small drives
    cfg_svc = ServiceConfig(k=k, num_clusters=8, tick_schedule="round_robin")
    sync()
    torch.cuda.reset_peak_memory_stats()
    svc = StreamingService(cfg_svc)
    admit = []
    for i in range(SERVICE_TENANTS):
        g_t = tenant_graph(i)
        _, admit_t = host_s(lambda: svc.add_graph(f"t{i}", g_t))
        sess = svc._sessions[f"t{i}"]
        admit.append({"seconds": admit_t, "family": sess.plan.family,
                      "degree": sess.plan_degree, "rho": sess.rho,
                      "rho_ub": sess.rho_ub, "tau": sess.tau, "lr": sess.lr,
                      "edge_capacity": sess.store.capacity})
        del g_t
    rng_u = np.random.default_rng(5)
    src2, dst2, _ = svc.live_edges("t2")
    gone = rng_u.choice(len(src2), SERVICE_UPDATE_B // 2, replace=False)
    upd_pairs = np.concatenate([
        np.stack([src2[gone], dst2[gone]], 1),
        rng_u.integers(0, n, size=(SERVICE_UPDATE_B // 2, 2))])
    upd_w = np.concatenate([np.zeros(SERVICE_UPDATE_B // 2),
                            np.ones(SERVICE_UPDATE_B // 2)])
    del src2, dst2
    tenants = [svc._sessions[f"t{i}"] for i in range(SERVICE_TENANTS)]
    ticks_f, before_upd, check_in, check_out = [], None, None, None
    reset_launch_counts()
    for t in range(SERVICE_TICKS):
        if t == 2:
            before_upd = (svc.compile_count,
                          sum(p.captures for p in svc._compiled.values()))
            _, update_s = host_s(lambda: svc.apply_updates(
                "t2", upd_pairs, upd_w))
        if t == 1:  # the first replayed tick: every tenant is checked on it
            check_in = [(s_.v, program.dilation_scale(
                s_.plan, svc._session_degree(s_)), s_.lr, s_.store,
                svc._session_degree(s_)) for s_ in tenants]
        c_before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out_t, tick_s = host_s(svc.tick)
        end.record()
        sync()
        c_after = launch_counts()
        ticks_f.append({
            "ms": start.elapsed_time(end), "host_s": tick_s,
            "invocations": svc.tick_invocations,
            "multiplied_ticks": svc.multiplied_ticks,
            "residuals": out_t,
            "launches": {name: c_after[name] - c_before[name]
                         for name in c_after}})
        if t == 1:
            check_out = [(s_.v, out_t[s_.sid]) for s_ in tenants]
    counts_service_full = launch_counts()
    after_upd = (svc.compile_count,
                 sum(p.captures for p in svc._compiled.values()))
    peak_service = torch.cuda.max_memory_allocated()
    if before_upd != after_upd or after_upd != (1, 1):
        raise AssertionError(f"service_full: programs/captures {before_upd} "
                             f"before the update, {after_upd} after")
    for t_rec in ticks_f:
        if not (len(t_rec["residuals"]) == SERVICE_TENANTS and all(
                np.isfinite(r) for r in t_rec["residuals"].values())):
            raise AssertionError(f"service_full tick: {t_rec}")
    for sid in svc.session_ids():
        v_t = svc.panel(sid)
        if not (v_t.shape == (n, k) and bool(torch.isfinite(v_t).all())):
            raise AssertionError(f"service_full: {sid}'s panel is malformed")
    # every tenant's replayed tick against its own dilated operator +
    # run_chunk from the same panel, c and lr: a row offset or hub list
    # that goes wrong for members past the first shows here
    step_fn_f = solvers.make_step_fn("mu_eg", "kernel", dev)
    tenant_errs, tenant_res_gaps = [], []
    for i, ((v_in, c_i, lr_i, store_i, deg_i), (v_out, res_out)) in enumerate(
            zip(check_in, check_out)):
        op_i = operators.dilated_step_operator(gstore.fused_step(store_i), c_i,
                                               deg_i, capture=True)
        state_i, res_i = program.run_chunk(
            op_i, step_fn_f, solvers.SolverState(v=v_in, step=torch.zeros(
                (), dtype=torch.int32, device=dev)),
            lr_i, cfg_svc.steps_per_tick)
        tenant_errs.append(compare(f"service_full tenant {i} tick vs its own run",
                                   lambda: v_out, lambda: state_i.v))
        tenant_res_gaps.append(abs(float(res_i) - res_out))
        if not tenant_res_gaps[-1] <= REL_TOL * float(res_i):
            raise AssertionError(f"service_full tenant {i} residual {res_out} "
                                 f"vs {float(res_i)}")
        del op_i, state_i
    # the pieces of a tick: the layout fill, one K2 factor on the group
    # layout (4 x 2^20 rows; held to its plain twin on the same layout) and
    # on tenant 0's own permuted row CSR, the four members' solver steps
    # (K3, the k x k algebra, K4)
    deg_0, c_0, store_0 = check_in[0][4], check_in[0][1], check_in[0][3]
    member_rows = [gstore.edge_rows(m.store) for m in tenants]
    member_cs = [program.dilation_scale(m.plan, deg_0) for m in tenants]
    sync()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows_g = program.group_edge_rows(member_rows, member_cs)
    sync()
    layout_peak = torch.cuda.max_memory_allocated() - base_bytes
    layout_ms = cuda_ms(lambda: program.group_edge_rows(
        member_rows, member_cs, out=rows_g), 3)
    vs_g = torch.stack([m.v for m in tenants])
    fused_g = backend.rows_fused_step(rows_g)
    group_factor_err, group_factor_tol = compare(
        "service_full K2 on the group layout vs plain",
        lambda: fused_g(vs_g.reshape(-1, k), -1.0, 1.0),
        lambda: es_ref.edge_spmm_rows(rows_g.row_ptr, rows_g.other,
                                      rows_g.weight, vs_g.reshape(-1, k),
                                      -1.0, 1.0))
    group_factor_ms = cuda_ms(
        lambda: fused_g(vs_g.reshape(-1, k), -1.0, 1.0), 10)
    group_factor_bound = bound(SERVICE_TENANTS * k2_bytes(g),
                               SERVICE_TENANTS * (2 * g.num_edges * k * 2
                                                  + 4 * n * k))[0]
    fused_0 = gstore.fused_step(store_0)
    tenant_factor_ms = cuda_ms(lambda: fused_0(vs_g[0], -c_0, 1.0), 10)
    avs_g = fused_g(vs_g.reshape(-1, k), -1.0, 1.0).reshape(vs_g.shape)
    lrs_g = torch.tensor([m.lr for m in tenants], device=dev)
    member_steps_ms = cuda_ms(lambda: program._step_all(
        step_fn_f, vs_g, avs_g, lrs_g), 10)
    del rows_g, fused_g, avs_g
    # the split a residual-decay tick makes when two halves of the group
    # ride different budgets: two sub-batches of occupancy 2 through one
    # program in turn, so every call refills the layout (A B A B A: the
    # replays of one pair repeat bitwise)
    prog_2 = program.build_tick_program(program.StepSchedule(
        degree=deg_0, steps=cfg_svc.steps_per_tick, backend="kernel"))
    pairs = [[0, 1], [2, 3]]
    split_calls = []
    for call in range(5):
        idx = pairs[call % 2]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        out_2 = prog_2([member_rows[i] for i in idx],
                       [member_cs[i] for i in idx], vs_g[idx],
                       [tenants[i].lr for i in idx], 1)
        end.record()
        sync()
        split_calls.append((start.elapsed_time(end), out_2))
    for a_, b_ in ((1, 3), (2, 4)):
        for x, y in zip(split_calls[a_][1], split_calls[b_][1]):
            if not torch.equal(x, y):
                raise AssertionError("service_full split: a refilled replay "
                                     "did not repeat its pair's answer")
    if (prog_2.captures, prog_2.layout_fills) != (1, 5):
        raise AssertionError(f"service_full split: {prog_2.captures} captures, "
                             f"{prog_2.layout_fills} fills in 5 calls")
    split = {"occupancy": 2, "calls": 5, "captures": prog_2.captures,
             "layout_fills": prog_2.layout_fills,
             "first_call_ms": split_calls[0][0],
             "refill_and_replay_ms": [t_ for t_, _ in split_calls[1:]]}
    del prog_2, split_calls, out_2, vs_g, member_rows
    emit({"phase": "service_full", "tenants": SERVICE_TENANTS, "n": n,
          "num_edges": g.num_edges, "k": k, "degree": deg_0,
          "steps_per_tick": cfg_svc.steps_per_tick, "admission": admit,
          "update_b": SERVICE_UPDATE_B, "update_s": update_s,
          "ticks": ticks_f, "programs_captures_before_update": before_upd,
          "programs_captures_after_update": after_upd,
          "layout_fills": svc.layout_fills,
          "group_layout_fill_ms": layout_ms,
          "group_layout_fill_peak_bytes": layout_peak,
          "group_factor_max_abs_err": group_factor_err,
          "group_factor_tolerance": group_factor_tol,
          "group_factor_ms": group_factor_ms,
          "group_factor_bound_ms": group_factor_bound,
          "tenant0_own_factor_ms": tenant_factor_ms,
          "natural_order_factor_ms": kernels["edge_spmm_nb"]["ms"],
          "member_steps_ms": member_steps_ms,
          "tenant_max_abs_err": [e for e, _ in tenant_errs],
          "tenant_tolerance": [t_ for _, t_ in tenant_errs],
          "tenant_residual_gap": tenant_res_gaps, "split": split,
          "max_memory_allocated": peak_service,
          "launches": counts_service_full})
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_service_full[name] <= 0:
            raise AssertionError(f"service_full launched no {name}")
    # tenant 0's tick-1 inputs, for its edge-sharded tick in sharded_service
    tick_in_0 = (check_in[0][0].cpu().numpy(), check_in[0][1], check_in[0][2],
                 check_in[0][4])
    del svc, tenants, check_in, check_out

    # ---- 16. the serving layer: bench_serve.py's load ----------------------
    reset_launch_counts()
    small_serve = serve_small_phase(dev)
    counts_serve_small = launch_counts()
    for pipeline in ("serialized", "double_buffer"):
        run = small_serve[pipeline]
        if run["captures"] != run["programs"]:
            raise AssertionError(f"serve_small {pipeline}: {run['captures']} "
                                 f"captures for {run['programs']} programs")
    emit({**small_serve, "launches": counts_serve_small})
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_serve_small[name] <= 0:
            raise AssertionError(f"serve_small launched no {name}")

    # ---- 17. the process shell on the card -------------------------------
    http_serve = serve_http_phase(SERVE_HTTP_ARGS)
    counts_serve_http = http_serve["engine"]["kernel_launches"]
    emit(http_serve)
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_serve_http[name] <= 0:
            raise AssertionError(f"serve_http launched no {name}")

    # ---- 18. the serving layer at full width -----------------------------
    full_serve = serve_full_phase(tenant_graph, cfg_svc, n, dev)
    counts_serve_full = full_serve["launches"]
    emit(full_serve)
    if not full_serve["captures"] == full_serve["programs"] >= 1:
        raise AssertionError(f"serve_full: {full_serve['captures']} captures "
                             f"for {full_serve['programs']} programs")
    if sum(full_serve["queries_overlapping_a_capture"].values()) < 1:
        raise AssertionError("serve_full: no query overlapped a capture")
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_serve_full[name] <= 0:
            raise AssertionError(f"serve_full launched no {name}")

    # ---- 19. the edge-sharded clique solve: 2 ranks on this card ----------
    # ranks of one card take gloo (NCCL refuses two ranks on one GPU); the
    # solve is phase small's but cut to SHARDED_SMALL_STEPS steps, since a
    # factor costs an all_reduce of ~1 ms (2 ranks) here (at 20 steps one
    # label of 160 still differed from phase small's on the card)
    torch.cuda.empty_cache()
    res_ss, ss_wall = host_s(lambda: parallel.run_ranks(
        SHARDED_SMALL_RANKS, sharded_small_rank, cfg_s, SHARDED_SMALL_STEPS,
        timeout=SHARDED_TIMEOUT_S))
    outs_ss = [r.value for r in res_ss]
    counts_sharded_small = parallel.sum_launches(o["launches"] for o in outs_ss)
    if not parallel.bitwise_equal([o["panel"] for o in outs_ss]):
        raise AssertionError("sharded_small: the ranks' panels differ")
    emit({"phase": "sharded_small", "ranks": SHARDED_SMALL_RANKS,
          "backend": "gloo",
          "n": 160, "degree": cfg_s.degree, "steps": SHARDED_SMALL_STEPS,
          "world_wall_s": ss_wall, "solve_and_kmeans_s": outs_ss[0]["seconds"],
          "agreement": outs_ss[0]["agreement"], "small_agreement": agreement,
          "subspace_error": outs_ss[0]["subspace_error"].tolist(),
          "launches": counts_sharded_small})
    if outs_ss[0]["agreement"] != agreement:
        raise AssertionError(f"sharded_small agreement {outs_ss[0]['agreement']}"
                             f" != phase small's {agreement}")
    for name in ("edge_spmm", "gram2k", "panel_mix"):
        if counts_sharded_small[name] <= 0:
            raise AssertionError(f"sharded_small launched no {name}")

    # ---- 20. the edge-sharded operator and solve at n = 2^20 ----------------
    s_plan = spectral.series_from_plan(plan_af)
    v0_sf = panel(n, k, 5)
    op_1p = operators.edge_series_operator(g, s_plan, backend="kernel")
    want_sf = op_1p(v0_sf)
    want_solve = solvers.run_solver(op_1p, n, SolverConfig(
        lr=lr_af, steps=SHARDED_SOLVE_STEPS, eval_every=SHARDED_SOLVE_STEPS,
        k=k, backend="kernel"), init_v=v0_sf)[0].v
    arrays_g = tuple(t.cpu().numpy() for t in (g.src, g.dst, g.weight))
    v0_np = v0_sf.cpu().numpy()
    del op_1p
    torch.cuda.empty_cache()
    res_sf, sf_wall = host_s(lambda: parallel.run_ranks(
        SHARDED_RANKS, sharded_full_rank, *arrays_g, n, plan_af, v0_np, lr_af,
        SHARDED_SOLVE_STEPS, SHARDED_SPLIT_REPS, timeout=SHARDED_TIMEOUT_S))
    outs_sf = [r.value for r in res_sf]
    res_nccl, nccl_wall = host_s(lambda: parallel.run_ranks(
        1, sharded_operator_rank, *arrays_g, n, plan_af, v0_np,
        backend="nccl", timeout=SHARDED_TIMEOUT_S))
    out_nccl = res_nccl[0].value
    counts_sharded_full = parallel.sum_launches(
        [o["launches"] for o in outs_sf] + [out_nccl["launches"]])
    for key in ("out", "solve_panel"):
        if not parallel.bitwise_equal([o[key] for o in outs_sf]):
            raise AssertionError(f"sharded_full: the ranks' {key} differ")
    sf_err = compare("sharded_full operator (4 gloo ranks) vs one process",
                     lambda: torch.from_numpy(outs_sf[0]["out"]).to(dev),
                     lambda: want_sf)
    nccl_err = compare("sharded_full operator (1 NCCL rank) vs one process",
                       lambda: torch.from_numpy(out_nccl["out"]).to(dev),
                       lambda: want_sf)
    sf_solve_err = float((torch.from_numpy(outs_sf[0]["solve_panel"]).to(dev)
                          - want_solve).abs().max())
    emit({"phase": "sharded_full", "ranks": SHARDED_RANKS, "backend": "gloo",
          "n": n, "num_edges": g.num_edges, "k": k, "degree": plan_af.degree,
          "shard_slots": outs_sf[0]["shard_slots"], "world_wall_s": sf_wall,
          "operator_first_call_s": [o["first_call_s"] for o in outs_sf],
          "operator_call_s": [o["call_s"] for o in outs_sf],
          "shard_k2_ms": [o["shard_k2_ms"] for o in outs_sf],
          "all_reduce_ms": [o["all_reduce_ms"] for o in outs_sf],
          "panel_bytes": n * k * 4,
          "axpy_ms": [o["axpy_ms"] for o in outs_sf],
          "solve_steps": SHARDED_SOLVE_STEPS,
          "solve_s": [o["solve_s"] for o in outs_sf],
          "max_memory_allocated": [o["max_memory_allocated"] for o in outs_sf],
          "operator_max_abs_err": sf_err[0], "operator_tolerance": sf_err[1],
          "solve_max_abs_err": sf_solve_err, "solve_tolerance": STEPS_TOL,
          "nccl_one_rank": {"world_wall_s": nccl_wall,
                            "operator_first_call_s": out_nccl["first_call_s"],
                            "max_abs_err": nccl_err[0]},
          "launches": counts_sharded_full})
    if not sf_solve_err <= STEPS_TOL:
        raise AssertionError(f"sharded_full: {SHARDED_SOLVE_STEPS} sharded steps "
                             f"differ from one process by {sf_solve_err}")
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_sharded_full[name] <= 0:
            raise AssertionError(f"sharded_full launched no {name}")
    del want_sf, want_solve, v0_sf, outs_sf, res_sf, arrays_g

    # ---- 21. the edge-sharded service: the fleet, and a 2^20 tick ------------
    fleet_np = [(sid, *(t.cpu().numpy() for t in (g_t.src, g_t.dst, g_t.weight)),
                 g_t.num_nodes) for sid, g_t, _ in fleet]
    cfg_rr = dataclasses.replace(fleet_cfg, tick_schedule="round_robin")
    res_fl, fl_wall = host_s(lambda: parallel.run_ranks(
        SHARDED_SERVICE_RANKS, sharded_fleet_rank, fleet_np, cfg_rr,
        FLEET_CAPACITY, timeout=SHARDED_TIMEOUT_S))
    outs_fl = [r.value for r in res_fl]
    fl = outs_fl[0]
    fl_agreement = float(np.mean([
        float(km.cluster_agreement(torch.from_numpy(fl["labels"][sid]), lab,
                                   fleet_cfg.num_clusters))
        for sid, _, lab in fleet]))
    rr = fleet_runs["round_robin"]
    v_t0, c_t0, lr_t0, deg_t0 = tick_in_0
    g_t0 = tenant_graph(0)
    store_t0 = gstore.from_edge_list(g_t0, capacity=SHARDED_TENANT_CAPACITY)
    prog_1p = program.build_tick_program(program.StepSchedule(
        degree=deg_t0, steps=cfg_svc.steps_per_tick, backend="kernel"))
    want_t0 = prog_1p([gstore.edge_rows(store_t0)], [c_t0],
                      torch.from_numpy(v_t0).to(dev)[None], [lr_t0], 1)
    arrays_t0 = tuple(t.cpu().numpy() for t in (g_t0.src, g_t0.dst, g_t0.weight))
    del prog_1p, store_t0, g_t0
    torch.cuda.empty_cache()
    res_t0, t0_wall = host_s(lambda: parallel.run_ranks(
        SHARDED_SERVICE_RANKS, sharded_tick_rank, *arrays_t0, n,
        SHARDED_TENANT_CAPACITY, v_t0, c_t0, lr_t0, deg_t0,
        cfg_svc.steps_per_tick, timeout=SHARDED_TIMEOUT_S))
    outs_t0 = [r.value for r in res_t0]
    if not parallel.bitwise_equal([o["panel"] for o in outs_t0]):
        raise AssertionError("sharded_service: the ranks' tick panels differ")
    t0_err = compare("sharded_service 2^20 tick (2 ranks) vs one process",
                     lambda: torch.from_numpy(outs_t0[0]["panel"]).to(dev),
                     lambda: want_t0[0][0])
    t0_res_gap = abs(outs_t0[0]["residual"] - float(want_t0[1][0]))
    counts_sharded_service = parallel.sum_launches(
        [o["launches"] for o in outs_fl] + [o["launches"] for o in outs_t0])
    emit({"phase": "sharded_service", "ranks": SHARDED_SERVICE_RANKS,
          "backend": "gloo",
          "fleet": {key: fl[key] for key in (
              "ticks", "wall_s", "tick_invocations", "device_work_steps",
              "programs", "captures", "converged", "max_residual")},
          "fleet_world_wall_s": fl_wall, "fleet_agreement": fl_agreement,
          "single_process": {"tick_invocations": rr["tick_invocations"],
                             "agreement": rr["agreement"],
                             "wall_s": rr["wall_s"]},
          "tenant_tick": {"n": n, "edge_capacity": SHARDED_TENANT_CAPACITY,
                          "degree": deg_t0,
                          "steps": cfg_svc.steps_per_tick,
                          "world_wall_s": t0_wall,
                          "seconds": [o["seconds"] for o in outs_t0],
                          "captures": [o["captures"] for o in outs_t0],
                          "max_memory_allocated": [
                              o["max_memory_allocated"] for o in outs_t0],
                          "max_abs_err": t0_err[0], "tolerance": t0_err[1],
                          "residual_gap": t0_res_gap},
          "launches": counts_sharded_service})
    if not (fl["converged"] and fl["max_residual"] <= fleet_cfg.tol):
        raise AssertionError(f"sharded_service fleet: {fl}")
    if fl["tick_invocations"] != rr["tick_invocations"] \
            or fl_agreement != rr["agreement"]:
        raise AssertionError(
            f"sharded_service fleet: {fl['tick_invocations']} invocations, "
            f"agreement {fl_agreement}; one process {rr['tick_invocations']}, "
            f"{rr['agreement']}")
    if fl["captures"] != 0 or any(o["captures"] != 0 for o in outs_t0):
        raise AssertionError("sharded_service: an eager program captured")
    if not t0_res_gap <= REL_TOL * float(want_t0[1][0]):
        raise AssertionError(f"sharded_service tick residual gap {t0_res_gap}")
    for name in ("edge_spmm", "edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_sharded_service[name] <= 0:
            raise AssertionError(f"sharded_service launched no {name}")
    edge_sharded_tick_s = [o["seconds"] for o in outs_t0]
    del outs_t0, res_t0

    def psums_want(method, degree, steps):
        """Run-time all_reduces of one panel-sharded tick of `steps` steps:
        per mu-EG step degree - 1 plain and 1 fused (Oja degree plain),
        then degree plain for the residual."""
        if method == "mu_eg":
            return ((degree - 1) * steps + degree, steps)
        return (degree * steps + degree, 0)

    def check_model_tick(label, outs, method, want, want_ps):
        """Hold the ranks' panel-sharded tick of ``method`` to the
        one-process ``want`` (panels, residual) and to the run-time
        all_reduce budget; returns the phase's numbers for it."""
        if not parallel.bitwise_equal([o[method]["panel"] for o in outs]):
            raise AssertionError(f"{label} {method}: the ranks' panels differ")
        err_m = compare(f"{label} {method} ({len(outs)} ranks) vs one process",
                        lambda: torch.from_numpy(outs[0][method]["panel"])
                        .to(dev), lambda: want[0][0])
        want_res = float(want[1][0])
        gap = abs(outs[0][method]["residual"] - want_res)
        if any(o[method]["psums"] != want_ps for o in outs):
            raise AssertionError(f"{label} {method}: all_reduces "
                                 f"{[o[method]['psums'] for o in outs]}, "
                                 f"want {want_ps}")
        if any(o[method]["captures"] != 0 for o in outs):
            raise AssertionError(f"{label}: an eager program captured")
        if not gap <= REL_TOL * want_res:
            raise AssertionError(f"{label} {method}: residual gap {gap}")
        return {"seconds": [o[method]["seconds"] for o in outs],
                "psums_plain_fused": outs[0][method]["psums"],
                "psums_want": want_ps, "captures": 0,
                "max_abs_err": err_m[0], "tolerance": err_m[1],
                "residual": outs[0][method]["residual"], "residual_gap": gap}

    def split_of(outs):
        return {"rows_per_shard": outs[0]["rows_per_shard"],
                "live_half_edges": [o["live_half_edges"] for o in outs],
                "longest_row": [o["longest_row"] for o in outs],
                "hub_rows": [o["hub_rows"] for o in outs],
                "owned_k2_ms": [o["owned_k2_ms"] for o in outs],
                "all_reduce_ms": [o["all_reduce_ms"] for o in outs],
                "panel_bytes": outs[0]["panel_bytes"],
                "max_memory_allocated": [o["max_memory_allocated"]
                                         for o in outs]}

    # ---- 22. panel sharding: bench_distributed's model tick on 2 ranks -----
    gm_s, _ = graphs.sparse_sbm_graph(MODEL_SMALL_N, 4, avg_degree_in=3.0,
                                      avg_degree_out=0.5, seed=0, device=dev)
    cap_ms = gstore.capacity_class(gm_s.num_edges)
    v0_ms = panel(MODEL_SMALL_N, MODEL_SMALL_K, 8)
    store_ms = gstore.from_edge_list(gm_s, capacity=cap_ms)
    want_ms = {}
    for method in ("mu_eg", "oja"):
        prog_1p = program.build_tick_program(program.StepSchedule(
            method=method, degree=MODEL_SMALL_DEGREE, steps=MODEL_SMALL_STEPS,
            backend="kernel"))
        want_ms[method] = prog_1p([gstore.edge_rows(store_ms)],
                                  [MODEL_SMALL_C], v0_ms[None],
                                  [MODEL_SMALL_LR], 1)
    arrays_ms = tuple(t.cpu().numpy() for t in (gm_s.src, gm_s.dst,
                                                gm_s.weight))
    res_ms, ms_wall = host_s(lambda: parallel.run_ranks(
        MODEL_RANKS, model_tick_rank, *arrays_ms, MODEL_SMALL_N, cap_ms,
        v0_ms.cpu().numpy(), MODEL_SMALL_C, MODEL_SMALL_LR, MODEL_SMALL_DEGREE,
        MODEL_SMALL_STEPS, ("mu_eg", "oja"), MODEL_SPLIT_REPS,
        timeout=SHARDED_TIMEOUT_S))
    outs_ms = [r.value for r in res_ms]
    counts_model_small = parallel.sum_launches(o["launches"] for o in outs_ms)
    emit({"phase": "model_sharded_small", "ranks": MODEL_RANKS,
          "backend": "gloo", "n": MODEL_SMALL_N, "num_edges": gm_s.num_edges,
          "edge_capacity": cap_ms, "k": MODEL_SMALL_K,
          "degree": MODEL_SMALL_DEGREE, "steps": MODEL_SMALL_STEPS,
          "c": MODEL_SMALL_C, "lr": MODEL_SMALL_LR, "world_wall_s": ms_wall,
          **{method: check_model_tick(
              "model_sharded_small", outs_ms, method, want_ms[method],
              psums_want(method, MODEL_SMALL_DEGREE, MODEL_SMALL_STEPS))
             for method in ("mu_eg", "oja")},
          **split_of(outs_ms),
          "rows_build_s": [o["rows_build_s"] for o in outs_ms],
          "launches": counts_model_small})
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_model_small[name] <= 0:
            raise AssertionError(f"model_sharded_small launched no {name}")
    del outs_ms, res_ms, want_ms, store_ms, gm_s

    # ---- 23. panel sharding at full width: a 2^20 tenant, a 10^6 graph ------
    # one world of 2 ranks: (1) sharded_service's tenant-0 tick,
    # panel-sharded; (2) the million-node row, each rank generating the
    # graph itself: admission with the probe and one tick of a
    # panel-sharded service, rank 0 holding the tick to one process's and
    # each rank K2's rectangular launch on its owned rows to the twin
    torch.cuda.empty_cache()
    res_mf, mf_wall = host_s(lambda: parallel.run_ranks(
        MODEL_RANKS, model_full_rank,
        (*arrays_t0, n, SHARDED_TENANT_CAPACITY, v_t0, c_t0, lr_t0, deg_t0,
         cfg_svc.steps_per_tick, ("mu_eg",), MODEL_SPLIT_REPS),
        (MILLION_N, MILLION_AVG_DEGREE, MILLION_ALPHA, 0, MILLION_CAPACITY,
         cfg_svc, MODEL_SPLIT_REPS), timeout=SHARDED_TIMEOUT_S))
    outs_mt = [r.value["tenant"] for r in res_mf]
    outs_mm = [r.value["million"] for r in res_mf]
    tenant_tick = {
        "n": n, "edge_capacity": SHARDED_TENANT_CAPACITY, "degree": deg_t0,
        "steps": cfg_svc.steps_per_tick,
        **check_model_tick("model_sharded_full tenant", outs_mt, "mu_eg",
                           want_t0, psums_want("mu_eg", deg_t0,
                                               cfg_svc.steps_per_tick)),
        "edge_sharded_seconds": edge_sharded_tick_s,
        "rows_build_s": [o["rows_build_s"] for o in outs_mt],
        **split_of(outs_mt)}
    counts_model_tenant = parallel.sum_launches(o["launches"] for o in outs_mt)
    del want_t0, outs_mt, arrays_t0

    mm, one_p = outs_mm[0], outs_mm[0]["one_process"]
    mm_psums = psums_want("mu_eg", mm["plan"]["degree"],
                          cfg_svc.steps_per_tick)
    if not parallel.bitwise_equal([o["tick"]["panel"] for o in outs_mm]):
        raise AssertionError("model_sharded_full million: the ranks' panels "
                             "differ")
    if any(o["tick"]["psums"] != mm_psums or o["tick"]["captures"] != 0
           for o in outs_mm):
        raise AssertionError(f"model_sharded_full million: all_reduces "
                             f"{[o['tick']['psums'] for o in outs_mm]} (want "
                             f"{mm_psums}), captures "
                             f"{[o['tick']['captures'] for o in outs_mm]}")
    mm_gap = abs(mm["tick"]["residual"] - one_p["residual"])
    if not (one_p["max_abs_err"] <= one_p["tolerance"]
            and mm_gap <= REL_TOL * one_p["residual"]):
        raise AssertionError(f"model_sharded_full million tick vs one "
                             f"process: {one_p}, residual gap {mm_gap}")
    million = {
        "n": MILLION_N, "num_edges": mm["num_edges"],
        "node_capacity": mm["node_capacity"],
        "edge_capacity": mm["edge_capacity"], "k": cfg_svc.k,
        "steps_per_tick": cfg_svc.steps_per_tick,
        "graph_host_s": [o["graph_host_s"] for o in outs_mm],
        "admission_s": [o["admission_s"] for o in outs_mm],
        "probe_s": [o["probe_s"] for o in outs_mm],
        "probe_lambda_max": mm["probe_lambda_max"], "plan": mm["plan"],
        "tick_s": [o["tick"]["seconds"] for o in outs_mm],
        "psums_plain_fused": mm["tick"]["psums"], "psums_want": mm_psums,
        "captures": 0, "residual": mm["tick"]["residual"],
        "one_process": one_p, "residual_gap": mm_gap, **split_of(outs_mm),
        "launches": parallel.sum_launches(o["launches"] for o in outs_mm)}
    # K2's rectangular launch on the million-node shards' owned rows, held
    # to its twin in each rank; the bound of this run's rows
    for s_r, o in enumerate(outs_mm):
        rect = o["rectangular"]
        if not (rect["max_abs_err"] <= rect["tolerance"]
                and rect["bitwise_repeatable"]):
            raise AssertionError(f"edge_spmm_nb (rectangular, million shard "
                                 f"{s_r}): {rect}")
        r_m, live, kk = o["rows_per_shard"], o["live_half_edges"], cfg_svc.k
        b_ms, b_by = bound((r_m + 1) * 4 + live * 8
                           + mm["node_capacity"] * kk * 4 + 2 * r_m * kk * 4,
                           live * kk * 2 + 4 * r_m * kk)
        row = {"shape": f"power law 10^6, shard {s_r} of {MODEL_RANKS}",
               "rows": r_m, "panel_rows": mm["node_capacity"], "k": kk,
               "live_half_edges": live, "longest_row": o["longest_row"],
               "hub_rows": o["hub_rows"], **rect, "ms": o["owned_k2_ms"],
               "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "check_rectangular", **row})
        kernels["edge_spmm_nb"]["rectangular"].append(row)
    counts_model_full = parallel.sum_launches(
        [counts_model_tenant, million["launches"]])
    emit({"phase": "model_sharded_full", "ranks": MODEL_RANKS,
          "backend": "gloo", "world_wall_s": mf_wall,
          "tenant_tick": tenant_tick, "million": million,
          "launches": counts_model_full})
    for name in ("edge_spmm_nb", "gram2k", "panel_mix"):
        if counts_model_full[name] <= 0:
            raise AssertionError(f"model_sharded_full launched no {name}")
    del outs_mm, res_mf, mm, one_p

    # ---- 24-30. the paper's figures ---------------------------------------
    counts_mdp = mdp_phase(dev)
    counts_mdp_full, kernels["edge_spmm_nb"]["grid_graph"] = \
        mdp_full_phase(dev)
    counts_cliques = cliques_phase(dev)
    counts_series_degree = series_degree_phase(dev)
    counts_transforms = transforms_phase(dev)
    counts_linkpred = linkpred_phase(dev)
    counts_walks_paper = walks_paper_phase(dev)

    # ---- 31. the LM substrate's serving path -------------------------------
    counts_lm_serve = lm_serve_phase(dev, gpu)

    # ---- 32. the LM substrate's MoE serving path ---------------------------
    counts_lm_moe = lm_moe_phase(dev, gpu)

    # ---- 33. the LM substrate's SSM, hybrid and enc-dec serving paths -----
    counts_lm_ssm = lm_ssm_phase(dev, gpu)

    # ---- 34. the paper's training loop --------------------------------------
    counts_train_sped = train_sped_phase(dev, gpu)

    # ---- 35. LM training -----------------------------------------------------
    counts_lm_train = lm_train_phase(dev, gpu)

    # ---- 36. the LM mesh path, and 41. tensor-parallel serving in its
    # world (phase lm_serve_tp) ---------------------------------------------
    counts_lm_mesh, counts_lm_serve_tp = lm_mesh_phase(dev, gpu)

    # ---- 37. the dry-run's cell report ----------------------------------------
    counts_dryrun = dryrun_report_phase(dev, gpu)

    # ---- 38. the data-parallel train step with ZeRO-1 ----------------------
    counts_lm_train_dp = lm_train_dp_phase(dev, gpu)

    # ---- 39. the SPED dry-run ---------------------------------------------
    counts_dryrun_sped = dryrun_sped_phase(dev, gpu)

    # ---- 40. tensor parallelism and FSDP of the LM train step ----------
    counts_lm_train_tp = lm_train_tp_phase(dev, gpu)

    # ---- 42. kernel list -------------------------------------------------
    main_path = (counts_small, counts_full, counts_dense, counts_auto_small,
                 counts_auto_full, counts_mb_small, counts_mb_full,
                 counts_walks, counts_baselines, counts_stream_small,
                 counts_stream_full, counts_service_small,
                 counts_service_full, counts_serve_small, counts_serve_http,
                 counts_serve_full, counts_sharded_small, counts_sharded_full,
                 counts_sharded_service, counts_model_small, counts_model_full,
                 counts_mdp, counts_mdp_full, counts_cliques,
                 counts_series_degree, counts_transforms, counts_linkpred,
                 counts_walks_paper, counts_lm_serve, counts_lm_moe,
                 counts_lm_ssm, counts_train_sped, counts_lm_train,
                 counts_lm_mesh, counts_dryrun, counts_lm_train_dp,
                 counts_dryrun_sped, counts_lm_train_tp, counts_lm_serve_tp)
    for name, row in kernels.items():
        row["launches"] = sum(c[name] for c in main_path)
        if row["launches"] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    emit({"phase": "total", "seconds": time.perf_counter() - _T0})
    emit({"kernels": list(kernels.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
