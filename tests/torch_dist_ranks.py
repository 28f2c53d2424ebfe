"""Rank bodies and shared inputs of the port's tests that spawn worlds:
tests/test_torch_distributed.py, tests/test_torch_model_sharded.py,
tests/test_torch_lm_mesh.py, tests/test_torch_dryrun_sped.py,
tests/test_torch_train_dp.py, tests/test_torch_train_tp.py and
tests/test_torch_serve_tp.py.

The test spawns one world per shard count (``parallel.run_ranks``); each
rank imports this module by name (the spawned interpreter gets the
test's ``sys.path``), runs :func:`run_all` (edge sharding) or
:func:`run_model` (panel sharding) on the CPU over ``gloo`` and
returns every case's output as numpy.  The inputs are built from numpy
seeds by the functions below, which the test also calls to build the
JAX side's inputs: both packages see the same edges, panels and draws.
This module imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.core import backend, distributed, graphs, kmeans, metrics
from repro_torch.core import laplacian as lap
from repro_torch.core import program, solvers
from repro_torch.core.series import limit_neg_exp
from repro_torch.core.walks import WalkBatch
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.spectral import probes
from repro_torch.stream import graph_store as gs
from repro_torch.stream.service import ServiceConfig, StreamingService

CPU = "cpu"
CASE_NAMES = ("capacity_padded", "non_aligned", "weighted")


# ---------------------------------------------------------------------------
# inputs (numpy, shared with the JAX side)
# ---------------------------------------------------------------------------

def rand_edges(seed: int, n: int, e: int):
    """tests/test_distributed.py's ``_rand_graph`` as numpy pairs, weights."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    return edges, w


def case_arrays(name: str):
    """(edges, weights, n, capacity or None) of tests/test_distributed.py's
    CASES: weighted / capacity-padded / non-aligned."""
    if name == "weighted":
        return (*rand_edges(0, 96, 300), 96, None)
    if name == "capacity_padded":
        return (*rand_edges(1, 96, 300), 96, 512)
    return (*rand_edges(2, 301, 517), 301, None)


def panel(seed: int, n: int, k: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def service_common() -> dict:
    return dict(k=5, num_clusters=3, degree=7, steps_per_tick=5, lr=0.3,
                seed=0, probe_spectrum=False, tick_schedule="round_robin")


UPDATE = ([[0, 5], [1, 7]], [1.0, 1.0])
SCRIPT_TICKS = 3  # ticks after the update batch
SOLVE_STEPS = 100  # the clique solve
UNTIL_TICKS = 20  # the service script's last run_until_converged
TICK_CHUNKS = (1, 2)  # the direct tick's per-member chunk budgets


def _graph(name: str) -> lap.EdgeList:
    edges, w, n, cap = case_arrays(name)
    g = lap.make_edge_list(edges, n, weights=w, device=CPU)
    return lap.pad_edge_list(g, cap) if cap else g


def service_graphs() -> dict:
    """tests/test_distributed.py's ``_service_graphs`` in the port."""
    g_sbm, _ = graphs.sbm_graph(120, 3, p_in=0.35, p_out=0.03, seed=1,
                                device=CPU)
    return {"weighted": _graph("weighted"), "capacity_padded": g_sbm,
            "non_aligned": _graph("non_aligned")}


# ---------------------------------------------------------------------------
# the rank body
# ---------------------------------------------------------------------------

def _operators(mesh, out: dict) -> None:
    num_shards = parallel.num_edge_shards(mesh)
    seg = distributed.sharded_laplacian_matvec(mesh, backend="segment")
    for name in CASE_NAMES:
        g = _graph(name)
        v = torch.from_numpy(panel(6, g.num_nodes, 4))
        gp = distributed.pad_edges_for_mesh(g, num_shards)
        out[f"{name}/matvec"] = seg(gp.src, gp.dst, gp.weight, v)
        sb = backend.sharded_blocking_for(gp, num_shards, block_n=64)
        out[f"{name}/blocked"] = distributed.sharded_blocked_matvec(mesh, sb)(v)
        rho = float(lap.spectral_radius_upper_bound(g))
        with program.count_psums() as stats:
            out[f"{name}/series"] = distributed.distributed_series_operator(
                mesh, g, limit_neg_exp(7, scale=1.2 / rho),
                backend="segment")(v)
        out[f"{name}/series_psums"] = (stats.plain, stats.fused)
        out[f"{name}/series_blocked"] = distributed.distributed_series_operator(
            mesh, g, limit_neg_exp(9, scale=1.0 / rho), block_n=64)(v)
    # several edge axes: a (2, S/2) or (S, 1) ("pod", "data") mesh
    world = parallel.num_edge_shards(mesh)
    shape = (2, world // 2) if world % 2 == 0 else (world, 1)
    mesh2 = parallel.make_mesh(shape, ("pod", "data"), CPU)
    g = _graph("non_aligned")
    v = torch.from_numpy(panel(6, g.num_nodes, 4))
    rho = float(lap.spectral_radius_upper_bound(g))
    s7 = limit_neg_exp(7, scale=1.2 / rho)
    for axes in (("pod", "data"), ("data",)):
        key = "+".join(axes)
        out[f"axes/{key}"] = distributed.distributed_series_operator(
            mesh2, g, s7, edge_axes=axes, backend="segment")(v)
        out[f"axes/{key}/shards"] = parallel.num_edge_shards(mesh2, axes)
        out[f"axes/{key}/sidx"] = parallel.shard_index(mesh2, axes)


def _solves(mesh, out: dict) -> None:
    g = _graph("weighted")
    rho = float(lap.spectral_radius_upper_bound(g))
    cfg = solvers.SolverConfig(method="mu_eg", lr=0.3, steps=10, eval_every=5,
                               k=4, seed=0, backend="segment")
    init = torch.from_numpy(panel(12, g.num_nodes, 4))
    state, _ = distributed.distributed_solve(
        mesh, g, limit_neg_exp(7, scale=1.2 / rho), cfg, backend="segment",
        init_v=init)
    out["solve/v"] = state.v
    # the clique solve to its bars: subspace error against dense eigh,
    # agreement of the labels
    gc, truth = graphs.clique_graph(120, 3, seed=0, device=CPU)
    rho = float(lap.spectral_radius_upper_bound(gc))
    _, v_star = metrics.ground_truth_bottom_k(lap.laplacian_dense(gc), 3)
    cfg = solvers.SolverConfig(method="mu_eg", lr=0.4, steps=SOLVE_STEPS,
                               eval_every=100, k=3, seed=0, backend="segment")
    state, trace = distributed.distributed_solve(
        mesh, gc, limit_neg_exp(21, scale=8.0 / rho), cfg, backend="segment",
        v_star=v_star, init_v=torch.from_numpy(panel(13, 120, 3)))
    emb = state.v[:, 1:3]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    labels = kmeans.kmeans(torch.Generator().manual_seed(1), emb, 3).labels
    out["clique/v"] = state.v
    out["clique/subspace_error"] = trace.subspace_error
    out["clique/agreement"] = float(kmeans.cluster_agreement(labels, truth, 3))


def _probe(mesh, out: dict, probe_v0: np.ndarray) -> None:
    g = _graph("weighted")
    gp = distributed.pad_edges_for_mesh(g, parallel.num_edge_shards(mesh))
    res = probes.probe_sharded_edge_arrays(
        mesh, gp.src, gp.dst, gp.weight, None, g.num_nodes,
        num_nodes=g.num_nodes, backend="segment",
        v0=torch.from_numpy(probe_v0))
    out["probe/lambda_max"] = float(res.lambda_max)
    out["probe/trace"] = float(res.trace)
    out["probe/ritz"] = res.ritz
    out["probe/weights"] = res.weights


def _stochastic(mesh, out: dict, draws: dict) -> None:
    sidx = parallel.shard_index(mesh)
    gc, _ = graphs.clique_graph(120, 3, seed=0, device=CPU)
    rho = float(lap.spectral_radius_upper_bound(gc))
    v = torch.from_numpy(panel(14, 120, 3))
    op = distributed.distributed_minibatch_operator(
        mesh, gc, limit_neg_exp(5, scale=2.0 / rho), draws["batch"],
        backend="segment")
    out["minibatch"] = op(None, v, sel=torch.from_numpy(draws["sel"][sidx]))
    # the ranks' own draws: independent across ranks, equal within a rank
    gen = torch.Generator().manual_seed(3)
    out["minibatch/drawn"] = op(gen, v)
    gr, _ = graphs.ring_of_cliques(3, 4, device=CPU)
    inc = lap.build_edge_incidence(gr)
    v = torch.eye(gr.num_nodes)
    wb = WalkBatch(*(torch.tensor(a) for a in draws["walks"][sidx]))
    for mode in ("importance", "rejection"):
        op = distributed.distributed_walk_operator(
            mesh, gr, inc, draws["coeffs"], 0.7, draws["walkers"], mode=mode)
        out[f"walks/{mode}"] = op(None, v, walks=wb,
                                  coins=torch.from_numpy(draws["coins"][sidx]))


def _ticks(mesh, out: dict, tick_in: dict) -> None:
    sched = program.StepSchedule(degree=5, steps=4, backend="segment")
    stores = [gs.from_edge_list(lap.make_edge_list(e, 96, weights=w,
                                                   device=CPU), capacity=512)
              for e, w in tick_in["graphs"]]
    rows = [gs.shard_edge_rows(st, mesh) for st in stores]
    prog = program.build_tick_program(sched, CPU, mesh=mesh)
    with program.count_psums() as stats:
        vs, res = prog(rows, tick_in["cs"], torch.from_numpy(tick_in["vs"]),
                       tick_in["lrs"], TICK_CHUNKS)
    out["tick/vs"], out["tick/res"] = vs, res
    out["tick/psums"] = (stats.plain, stats.fused)
    out["tick/captures"] = prog.captures
    # a tuple is ONE all_reduce of its flat concatenation, counted fused
    sidx = float(parallel.shard_index(mesh))
    with program.count_psums() as stats:
        out["psum/tuple/0"], out["psum/tuple/1"] = program._psum(
            (torch.full((3,), sidx), torch.full((2, 2), 2 * sidx)),
            parallel.edge_group(mesh))
    out["psum/tuple_counts"] = (stats.plain, stats.fused)


def _service(mesh, out: dict, resume: dict) -> None:
    num_shards = parallel.num_edge_shards(mesh)
    svc = StreamingService(ServiceConfig(mesh=mesh, **service_common()),
                           device=CPU)
    for sid, g in service_graphs().items():
        svc.add_graph(sid, g, resume_panel=resume[sid])
    out["svc/capacities_balanced"] = all(
        s.store.capacity % num_shards == 0 for s in svc._sessions.values())
    out["svc/tick1"] = svc.tick()
    out["svc/panels1"] = {sid: svc.panel(sid) for sid in svc.session_ids()}
    stats = svc.apply_updates("weighted", *UPDATE)
    out["svc/stats"] = tuple(int(x) for x in stats)
    out["svc/ticks"] = [svc.tick() for _ in range(SCRIPT_TICKS)]
    summary = svc.evict("non_aligned")
    out["svc/evicted"] = (summary["residual"], summary["ticks"],
                          summary["panel"])
    out["svc/until"] = svc.run_until_converged(max_ticks=UNTIL_TICKS)
    out["svc/info"] = {sid: svc.session_info(sid)
                       for sid in svc.session_ids()}
    out["svc/counters"] = (svc.tick_invocations, svc.device_work,
                           svc.compile_count,
                           sum(p.captures for p in svc._compiled.values()))
    # an edgeless admission: every shard's slice is all padding
    empty = StreamingService(ServiceConfig(
        mesh=mesh, **dict(service_common(), k=4, degree=5, steps_per_tick=3)),
        device=CPU)
    empty.add_graph("empty", lap.make_edge_list(np.zeros((0, 2), np.int64), 40,
                                                device=CPU),
                    resume_panel=resume["empty"])
    out["empty/tick"] = empty.tick()
    out["empty/v"] = empty.panel("empty")


def run_all(dev, inputs: dict) -> dict:
    """Every case of the test on this rank; returns {name: output}."""
    torch.set_num_threads(1)  # several ranks share the test worker's CPU
    mesh = parallel.default_edge_mesh(device=dev)
    out: dict = {"sidx": parallel.shard_index(mesh),
                 "shards": parallel.num_edge_shards(mesh)}
    _operators(mesh, out)
    _solves(mesh, out)
    _probe(mesh, out, inputs["probe_v0"])
    _stochastic(mesh, out, inputs["draws"])
    _ticks(mesh, out, inputs["tick"])
    _service(mesh, out, inputs["resume"])
    return out



# ---------------------------------------------------------------------------
# panel (model-axis) sharding: tests/test_torch_model_sharded.py
# ---------------------------------------------------------------------------

MODEL_AXES = ("model",)
MODEL_BLOCK_N = 32  # several owned row ranges on the 96-node tick graphs
MODEL_DEGREE, MODEL_STEPS = 5, 4
# (method, group size) of the direct ticks, and each size's chunk budgets
MODEL_TICKS = (("mu_eg", 1), ("mu_eg", 2), ("oja", 1), ("oja", 2))
MODEL_CHUNKS = {1: 2, 2: (1, 2)}
MODEL_AB = {"plain": (1.0, 0.0), "step": (-0.03, 1.0)}  # (alpha, beta)
MODEL_PROBE_STEPS = 12


def model_mesh(dev, num_shards: int):
    """The JAX package's ("data", "model") mesh of shape (1, S)."""
    return parallel.make_mesh((1, num_shards), ("data", "model"), dev)


def _model_ticks(mesh, out: dict, tick_in: dict) -> None:
    stores = [gs.from_edge_list(lap.make_edge_list(e, 96, weights=w,
                                                   device=CPU), capacity=512)
              for e, w in tick_in["graphs"]]
    rows = [gs.model_shard_rows(st, mesh, block_n=MODEL_BLOCK_N)
            for st in stores]
    out["model/rows_per_shard"] = rows[0].row_ptr.shape[0] - 1
    for method, g in MODEL_TICKS:
        prog = program.build_tick_program(
            program.StepSchedule(method=method, degree=MODEL_DEGREE,
                                 steps=MODEL_STEPS, backend="segment"),
            CPU, mesh=mesh, model_axes=MODEL_AXES)
        key = f"model_tick/{method}/{g}"
        with program.count_psums() as stats:
            vs, res = prog(rows[:g], tick_in["cs"][:g],
                           torch.from_numpy(tick_in["vs"][:g]),
                           tick_in["lrs"][:g], MODEL_CHUNKS[g])
        out[f"{key}/vs"], out[f"{key}/res"] = vs, res
        out[f"{key}/psums"] = (stats.plain, stats.fused)
        out[f"{key}/captures"] = prog.captures
        out[f"{key}/program"] = type(prog).__name__


def _model_rows(mesh, out: dict) -> None:
    """This rank's owned rows of every case graph, from its row CSR built
    in place and from the JAX-equal layout's shard."""
    num_shards = parallel.num_model_shards(mesh, MODEL_AXES)
    sidx = parallel.model_shard_index(mesh, MODEL_AXES)
    out["model/sidx"], out["model/shards"] = sidx, num_shards
    for name in CASE_NAMES:
        g = _graph(name)
        v = torch.from_numpy(panel(6, g.num_nodes, 4))
        mb = backend.model_blocking_for(g, num_shards, block_n=MODEL_BLOCK_N)
        rows = es_ops.build_model_shard_rows(
            g.src, g.dst, g.weight, g.num_nodes, num_shards, sidx,
            block_n=MODEL_BLOCK_N)
        start = sidx * mb.rows_per_shard
        for tag, (alpha, beta) in MODEL_AB.items():
            out[f"model_rows/{name}/{tag}"] = es_ops.model_local_rows(
                rows, v, alpha, beta, start)
        out[f"model_rows/{name}/blocking"] = es_ops.model_local_rows(
            es_ops.blocking_rows(mb.shard(sidx)), v, 1.0, 0.0, start)


def _model_probe(mesh, out: dict, probe_v0: np.ndarray) -> None:
    g = _graph("weighted")
    num_shards = parallel.num_model_shards(mesh, MODEL_AXES)
    v0 = torch.from_numpy(probe_v0)
    mb = backend.model_blocking_for(g, num_shards, block_n=MODEL_BLOCK_N)
    store = gs.from_edge_list(g, capacity=512)
    with program.count_psums() as stats:
        by_blocking = probes.probe_model_sharded(
            mesh, mb, g.num_nodes, num_steps=MODEL_PROBE_STEPS, v0=v0)
    out["model_probe/psums"] = (stats.plain, stats.fused)
    by_rows = probes.probe_model_sharded(
        mesh, gs.model_shard_rows(store, mesh, block_n=MODEL_BLOCK_N),
        g.num_nodes, num_nodes=store.num_nodes, num_steps=MODEL_PROBE_STEPS,
        v0=v0)
    gp = distributed.pad_edges_for_mesh(g, num_shards)
    by_edges = probes.probe_sharded_edge_arrays(
        mesh, gp.src, gp.dst, gp.weight, None, g.num_nodes,
        num_nodes=g.num_nodes, edge_axes=MODEL_AXES,
        num_steps=MODEL_PROBE_STEPS, v0=v0)
    for tag, res in (("blocking", by_blocking), ("rows", by_rows),
                     ("edges", by_edges)):
        out[f"model_probe/{tag}"] = {
            "lambda_max": float(res.lambda_max), "trace": float(res.trace),
            "ritz": res.ritz, "weights": res.weights}


def _model_rows_cached(store) -> bool:
    return any(isinstance(key, tuple) and key[0] == "model_rows"
               for key in store._cache)


def _model_service(mesh, out: dict, resume: dict) -> None:
    svc = StreamingService(ServiceConfig(mesh=mesh, model_axes=MODEL_AXES,
                                         **service_common()), device=CPU)
    for sid, g in service_graphs().items():
        svc.add_graph(sid, g, resume_panel=resume[sid])
    out["msvc/tick1"] = svc.tick()
    out["msvc/panels1"] = {sid: svc.panel(sid) for sid in svc.session_ids()}
    out["msvc/cached_after_tick"] = _model_rows_cached(
        svc._sessions["weighted"].store)
    svc.apply_updates("weighted", *UPDATE)
    out["msvc/cached_after_update"] = _model_rows_cached(
        svc._sessions["weighted"].store)
    out["msvc/tick2"] = svc.tick()
    out["msvc/cached_after_tick2"] = _model_rows_cached(
        svc._sessions["weighted"].store)
    out["msvc/panels2"] = {sid: svc.panel(sid) for sid in svc.session_ids()}
    out["msvc/programs"] = svc.compile_count
    out["msvc/group_keys"] = len({s.group_key
                                  for s in svc._sessions.values()})
    out["msvc/captures"] = sum(p.captures for p in svc._compiled.values())
    out["msvc/program_types"] = sorted({type(p).__name__
                                        for p in svc._compiled.values()})
    # admission probes through the owned-rows matvec plan as one device's
    plans = {}
    for tag, kw in (("model", dict(mesh=mesh, model_axes=MODEL_AXES)),
                    ("one_device", {})):
        probed = StreamingService(ServiceConfig(
            **kw, **dict(service_common(), probe_spectrum=True)), device=CPU)
        for sid, g in service_graphs().items():
            probed.add_graph(sid, g)
        plans[tag] = {sid: (s.rho, s.plan_degree, s.lr, s.plan.family)
                      for sid, s in probed._sessions.items()}
    out["msvc/plans"] = plans


def run_model(dev, inputs: dict) -> dict:
    """Every panel-sharded case on this rank; returns {name: output}."""
    torch.set_num_threads(1)  # several ranks share the test worker's CPU
    mesh = model_mesh(dev, dist.get_world_size())
    out: dict = {}
    _model_rows(mesh, out)
    _model_ticks(mesh, out, inputs["tick"])
    _model_probe(mesh, out, inputs["probe_v0"])
    _model_service(mesh, out, inputs["resume"])
    return out


# ---------------------------------------------------------------------------
# the LM mesh (tests/test_torch_lm_mesh.py): a (2, 2) ("data", "model") mesh
# ---------------------------------------------------------------------------

LM_MESH = (2, 2)


def lm_config(arch: str, overrides=None):
    """The port's smoke config of ``arch`` with ``overrides``."""
    import dataclasses

    from repro_torch import configs as tcfg

    cfg = tcfg.smoke_config(tcfg.get_arch(arch))
    return dataclasses.replace(cfg, **(overrides or {}))


def lm_params(tree):
    """A numpy parameter tree as the port's ``Params`` nodes."""
    from repro_torch.models.layers import Params

    return Params(**{k: lm_params(v) if isinstance(v, dict)
                     else torch.tensor(np.asarray(v, np.float32))
                     for k, v in tree.items()})


def _rows(mesh, batch: int):
    """(this rank's rows of an array, the global result of its rows')."""
    from repro_torch.models import sharding

    if not sharding.batch_split(mesh, batch):
        return torch.as_tensor, (lambda a: a)
    return (lambda a: sharding.own_rows(mesh, torch.as_tensor(a)),
            lambda a: sharding.gather_rows(mesh, a))


def _lm_cp_decode(mesh, case: dict) -> dict:
    """One GQA decode step against a cache filled to ``k.shape[1]``
    positions, each rank holding its shard (``attention.kv_layout``)."""
    from repro_torch.models import attention as attn

    cfg = lm_config(case["arch"], case.get("overrides"))
    b, max_seq = case["x"].shape[0], case["max_seq"]
    rows, seq, shard = attn.kv_layout(b, max_seq)
    own, gather = _rows(mesh, b)
    cache = attn.init_kv_cache(cfg, rows, seq, cfg.num_kv_heads, cfg.head_dim,
                               CPU, shard)
    attn.cache_update(cache, own(case["k"]), own(case["v"]), 0)
    start = 0 if shard is None else shard.start
    held = max(0, min(case["k"].shape[1], start + seq) - start)
    y, cache = attn.gqa_decode(lm_params(case["params"]), cfg,
                               own(case["x"]), cache)
    return {"out": gather(y), "length": cache.length, "sharded": shard is not None,
            "held_before": held, "positions": cache.k.shape[1]}


def _lm_mla_decode(mesh, case: dict) -> dict:
    """One MLA decode step (``attention.mla_decode``, every head on the
    rank) against a latent cache filled to ``c_kv.shape[1]`` positions,
    each rank holding its shard (``attention.kv_layout``); and whether a
    write past the sequence's end raises on this rank (the rank that
    holds none of its positions too)."""
    from repro_torch.models import attention as attn

    cfg = lm_config(case["arch"], case.get("overrides"))
    b, max_seq = case["x"].shape[0], case["max_seq"]
    rows, seq, shard = attn.kv_layout(b, max_seq)
    own, gather = _rows(mesh, b)
    cache = attn.init_mla_cache(cfg, rows, seq, CPU, shard)
    attn.mla_cache_update(cache, own(case["c_kv"]), own(case["k_rope"]), 0)
    start = 0 if shard is None else shard.start
    held = max(0, min(case["c_kv"].shape[1], start + seq) - start)
    y, cache = attn.mla_decode(lm_params(case["params"]), cfg,
                               own(case["x"]), cache)
    tail = own(case["c_kv"])[:, :3], own(case["k_rope"])[:, :3]
    past = _raises(lambda: attn.mla_cache_update(cache, *tail, max_seq - 2))
    return {"out": gather(y), "length": cache.length,
            "sharded": shard is not None, "held_before": held,
            "positions": cache.c_kv.shape[1], "write_past_end": past}


def _lm_moe(case: dict) -> dict:
    """``moe_ffn`` under the mesh on the global x."""
    from repro_torch.models import moe

    cfg = lm_config(case["arch"], case.get("overrides"))
    out, stats = moe.moe_ffn(lm_params(case["params"]), cfg,
                             torch.from_numpy(case["x"]))
    return {"out": out, "aux": stats.aux}


def _lm_model(mesh, case: dict) -> dict:
    """A prefill and ``fed``'s decode steps of a model sharded in place
    (``model.shard_model``), with the collectives of the last step."""
    from repro_torch import convert
    from repro_torch.models import sharding
    from repro_torch.models.model import shard_model

    cfg = lm_config(case["arch"], case.get("overrides"))
    model = shard_model(convert.lm_params_from_numpy(cfg, case["tree"],
                                                     device=CPU), mesh)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    logits, state = model.prefill(batch, max_seq=case["max_seq"])
    seq = [logits]
    for tok in case["fed"]:
        sharding.reset_collective_stats()
        logits, state = model.decode_step(state, torch.from_numpy(tok))
        seq.append(logits)
    return {"logits": torch.stack(seq), "step_collectives":
            sharding.collective_stats(),
            "params": sum(p.numel() for p in model.parameters())}


def run_lm_mesh(dev, inputs: dict) -> dict:
    """Every LM mesh case on this rank of a (2, 2) world, in f32 compute;
    returns {name: output}."""
    from repro_torch.models import layers, sharding

    torch.set_num_threads(1)  # several ranks share the test worker's CPU
    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh(LM_MESH, ("data", "model"), dev)
    out: dict = {"coord": tuple(mesh.get_coordinate())}
    with sharding.set_mesh(mesh):
        for name, case in inputs["attn"].items():
            out[f"attn/{name}"] = _lm_cp_decode(mesh, case)
        for name, case in inputs["mla"].items():
            out[f"mla/{name}"] = _lm_mla_decode(mesh, case)
        for name, case in inputs["moe"].items():
            out[f"moe/{name}"] = _lm_moe(case)
        for name, case in inputs["model"].items():
            out[f"model/{name}"] = _lm_model(mesh, case)
    return out


# ---------------------------------------------------------------------------
# the SPED dry-run step (tests/test_torch_dryrun_sped.py): a (S, 1) mesh
# ---------------------------------------------------------------------------

SPED_EDGE_AXES = ("data", "model")


def run_dryrun_sped(dev, inputs: dict) -> dict:
    """Every variant of ``launch.dryrun_sped.build_step`` on this rank's
    edge slice of a (world, 1) mesh: {variant: (panel, all_reduces,
    payload bytes)}."""
    from repro_torch.launch import dryrun_sped

    torch.set_num_threads(1)
    mesh = parallel.default_edge_mesh(device=dev)
    edges = {k: torch.from_numpy(v) for k, v in inputs["edges"].items()}
    v = torch.from_numpy(inputs["v"])
    out = {}
    for variant in dryrun_sped.VARIANTS:
        step = dryrun_sped.build_step(variant, mesh, SPED_EDGE_AXES)
        dryrun_sped.reset_stats()
        got = step(v, edges)
        st = dryrun_sped.stats()
        out[variant] = (got, st["all_reduce"], st["bytes"])
    return out


# ---------------------------------------------------------------------------
# the data-parallel train step (tests/test_torch_train_dp.py): (2, 1) mesh
# ---------------------------------------------------------------------------

def _dp_case(mesh, case: dict) -> dict:
    """``case["steps"]`` steps of ``dryrun.build_train_step`` under the
    mesh from the numpy tree: each step's loss and grad norm, then the
    parameters, the rank's moment slices and the whole moments."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding
    from repro_torch.train import optimizer as opt_lib

    cfg = lm_config(case["arch"], case.get("overrides"))
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    ocfg = opt_lib.OptConfig(**case["opt"])
    losses, norms = [], []
    with sharding.set_mesh(mesh):
        params = dict(model.named_parameters())
        state = opt_lib.init(ocfg, params)
        step = dryrun.build_train_step(cfg, ocfg, case.get("microbatches", 1))
        if case.get("aux_weight") is not None:
            train_loss = model.train_loss
            model.train_loss = lambda b: train_loss(
                b, aux_weight=case["aux_weight"])
        for batch in case["batches"]:
            model, state, m = step(model, state, {
                k: torch.from_numpy(v) for k, v in batch.items()})
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        mu, nu = opt_lib.whole_moments(state, params)
    return {"losses": torch.stack(losses), "grad_norms": torch.stack(norms),
            "params": convert.lm_params_to_numpy(model),
            "mu_local": {k: t.clone() for k, t in state.mu.items()},
            "mu": mu, "nu": nu,
            "moment_bytes": sum(t.numel() * t.element_size()
                                for d in (state.mu, state.nu)
                                for t in d.values())}


def _dp_checkpoint(mesh, case: dict, tmp: str) -> dict:
    """Two steps, a save by the ranks (rank 0 writes), a restore of a
    one-process save into a fresh state (the reverse direction) and its
    save again, then ``elastic_mesh`` dropping the last rank and the
    survivor's restore."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train import optimizer as opt_lib

    cfg = lm_config(case["arch"])
    ocfg = opt_lib.OptConfig(**case["opt"])
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    rank = dist.get_rank()
    out = {}
    with sharding.set_mesh(mesh):
        state = opt_lib.init(ocfg, dict(model.named_parameters()))
        step = dryrun.build_train_step(cfg, ocfg)
        for batch in case["batches"]:
            model, state, _ = step(model, state, {
                k: torch.from_numpy(v) for k, v in batch.items()})
        tree = convert.lm_train_tree(model, state)
        if rank == 0:
            ckpt.save(f"{tmp}/dp", 2, tree)
        dist.barrier()
        # the reverse: a one-process save restored on the ranks, saved again
        fresh = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
        fstate = opt_lib.init(ocfg, dict(fresh.named_parameters()))
        restored, _ = ckpt.restore(case["one_dir"],
                                   convert.lm_train_like(fresh, fstate))
        fstate = convert.load_lm_train_tree(fresh, fstate, restored)
        out["reverse_mu_local"] = {k: t.clone() for k, t in fstate.mu.items()}
        again = convert.lm_train_tree(fresh, fstate)
        if rank == 0:
            ckpt.save(f"{tmp}/again", int(fstate.step), again)
        dist.barrier()
    # rank 1 is lost: the survivors (rank 0) re-mesh
    mesh1, dropped = fault.elastic_mesh(ranks=[0], model_axis=1, device=CPU)
    out["dropped"] = dropped
    out["mesh_ranks"] = mesh1.mesh.flatten().tolist()
    if rank == 0:
        survivor = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
        sstate, sstep = fault.restore_on_mesh(f"{tmp}/dp", survivor, ocfg,
                                              mesh1)
        out["survivor"] = {"step": sstep, "params":
                           convert.lm_params_to_numpy(survivor),
                           "mu": dict(sstate.mu)}
    return out


TRAIN_LM_ARGS = ["--mode", "lm", "--arch", "qwen3-4b", "--smoke", "--steps",
                 "3", "--device", "cpu", "--log-every", "100"]


def _dp_train_lm(dev, tmp: str) -> dict:
    """``launch.train.train_lm`` in this world (what ``main`` runs under
    torchrun), checkpointing at its end."""
    from repro_torch.launch import train

    run = train.train_lm(train.parse_args(
        TRAIN_LM_ARGS + ["--ckpt-dir", f"{tmp}/lm"]), dev)
    return {"losses": run.losses, "grad_norms": run.grad_norms,
            "moments": len(run.opt_state.mu)}


def run_train_dp(dev, inputs: dict) -> dict:
    """Every data-parallel case on this rank of a (2, 1) ("data",
    "model") world, f32 compute; returns {name: output}."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers

    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    mesh = make_local_mesh(dev)
    out: dict = {"coord": tuple(mesh.get_coordinate())}
    for name, case in inputs["cases"].items():
        out[name] = _dp_case(mesh, case)
    out["checkpoint"] = _dp_checkpoint(mesh, inputs["checkpoint"],
                                       inputs["tmp"])
    out["train_lm"] = _dp_train_lm(dev, inputs["tmp"])
    return out


# ---------------------------------------------------------------------------
# the tensor-parallel train step (tests/test_torch_train_tp.py): (2, 2) mesh
# ---------------------------------------------------------------------------

TP_MESH = (2, 2)


def _np_tree(tree):
    """A tree of CPU tensors (dicts, NamedTuples, None) as numpy."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(v) for v in tree))
    return type(tree)(_np_tree(v) for v in tree)


def _local_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tp_case(mesh, case: dict) -> dict:
    """The case's model from its numpy tree in the (2, 2) mesh's training
    layout (``fsdp=True``): step 1's gradients gathered whole, then
    ``case["batches"]``' steps of ``dryrun.build_train_step``; the losses
    and grad norms, the whole (params, OptState) tree and the rank's
    parameter and moment bytes."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding
    from repro_torch.models.model import shard_model
    from repro_torch.train import optimizer as opt_lib

    cfg = lm_config(case["arch"], case.get("overrides"))
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    ocfg = opt_lib.OptConfig(**case["opt"])
    mb = case.get("microbatches", 1)
    losses, norms = [], []
    with sharding.set_mesh(mesh):
        shard_model(model, mesh, train=True, fsdp=True)
        lay = model.train_layout
        params = dict(model.named_parameters())
        state = opt_lib.init(ocfg, params, lay)
        if case.get("aux_weight") is not None:
            train_loss = model.train_loss
            model.train_loss = lambda b: train_loss(
                b, aux_weight=case["aux_weight"])

        def batch(i):
            return {k: torch.from_numpy(v)
                    for k, v in case["batches"][i].items()}

        step = dryrun.build_train_step(cfg, ocfg, mb)
        whole_grads = []  # each step's, gathered whole
        for i in range(len(case["batches"])):
            if i == 0 or case.get("keep_grads"):
                grads, _ = dryrun.train_grads(model, batch(i), mb)
                whole_grads.append({k: lay.whole(k, g).numpy()
                                    for k, g in grads.items()})
                model.zero_grad(set_to_none=True)
            model, state, m = step(model, state, batch(i))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        tree = _np_tree(convert.lm_train_tree(model, state))
    return {"losses": torch.stack(losses), "grad_norms": torch.stack(norms),
            "grads": whole_grads, "params": tree[0], "state": tree[1],
            "param_bytes": _local_bytes(params.values()),
            "moment_bytes": _local_bytes([*state.mu.values(),
                                          *state.nu.values()])}


def _tp_checkpoint(mesh, case: dict, tmp: str) -> dict:
    """The case's steps in the (2, 2) training layout, a save by the
    world (rank 0 writes), then ranks 0 and 1 restore it on a (2, 1)
    mesh through ``fault.restore_on_mesh``: their parameter and moment
    slices."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding
    from repro_torch.models.model import shard_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train import optimizer as opt_lib

    cfg = lm_config(case["arch"])
    ocfg = opt_lib.OptConfig(**case["opt"])
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    rank = dist.get_rank()
    with sharding.set_mesh(mesh):
        shard_model(model, mesh, train=True, fsdp=True)
        state = opt_lib.init(ocfg, dict(model.named_parameters()),
                             model.train_layout)
        step = dryrun.build_train_step(cfg, ocfg)
        for b in case["batches"]:
            model, state, _ = step(model, state, {
                k: torch.from_numpy(v) for k, v in b.items()})
        tree = convert.lm_train_tree(model, state)
        if rank == 0:
            ckpt.save(f"{tmp}/tp", len(case["batches"]), tree)
        dist.barrier()
    # every rank takes part in making the (2, 1) mesh of ranks 0 and 1
    mesh21 = parallel.make_mesh((2, 1), ("data", "model"), CPU, ranks=[0, 1])
    out = {}
    if rank < 2:
        fresh = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
        rstate, rstep = fault.restore_on_mesh(f"{tmp}/tp", fresh, ocfg,
                                              mesh21, fsdp=True)
        out = {"step": rstep, "coord": tuple(mesh21.get_coordinate()),
               "params": {k: p.detach().clone()
                          for k, p in fresh.named_parameters()},
               "mu": {k: t.clone() for k, t in rstate.mu.items()}}
    dist.barrier()
    return out


def run_train_tp(dev, inputs: dict) -> dict:
    """Every tensor-parallel case on this rank of a (2, 2) ("data",
    "model") world, f32 compute; returns {name: output}."""
    from repro_torch.models import layers

    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh(TP_MESH, ("data", "model"), dev)
    out: dict = {"coord": tuple(mesh.get_coordinate())}
    for name, case in inputs["cases"].items():
        out[name] = _tp_case(mesh, case)
    out["checkpoint"] = _tp_checkpoint(mesh, inputs["checkpoint"],
                                       inputs["tmp"])
    out.update(_tp_layout_checks(mesh))
    # the uneven [z | x] exchange: every rank of the world on "model"
    mesh14 = parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                                dev)
    out["ssm_tp4"] = ssm_mixer_sliced(mesh14, inputs["ssm_tp4"])
    return out


# the leaves of a Mamba2 mixer split over "model" under param_specs, and
# the dim each splits on
SSM_SLICED = {"w_zx": 1, "conv_w_x": 1, "conv_b_x": 0, "w_out": 0}


def ssm_mixer_slice(tree: dict, tp: int, j: int) -> dict:
    """A Mamba2 mixer's numpy tree as model rank ``j`` of ``tp`` holds it:
    the leaves of ``SSM_SLICED`` in their j-th block (``w_zx``'s columns
    are [z | x], so the block is not a block of heads), the rest whole."""
    out = {}
    for k, v in tree.items():
        dim = SSM_SLICED.get(k)
        if dim is not None:
            n = v.shape[dim] // tp
            v = np.take(v, range(j * n, (j + 1) * n), axis=dim)
        out[k] = v
    return out


def ssm_mixer_sliced(mesh, case: dict) -> dict:
    """One head-sliced Mamba2 mixer (``ssm.ssm_train`` on a ``sliced``
    node holding this rank's blocks of ``case["tree"]``) on the model
    group of ``mesh``, forward and backward from ``case["x"]`` with the
    upstream gradient ``case["gy"]``: the output, its input's gradient,
    the node's gradients (of its blocks) and the collectives."""
    from repro_torch.models import sharding, ssm

    cfg = lm_config(case["arch"], case.get("overrides"))
    node = lm_params(ssm_mixer_slice(case["tree"], sharding.tp_extent(mesh),
                                     sharding.tp_index(mesh)))
    node.sliced, node.mesh = True, mesh
    x = torch.from_numpy(case["x"]).requires_grad_()
    sharding.reset_collective_stats()
    out = ssm.ssm_train(node, cfg, x)
    (out * torch.from_numpy(case["gy"])).sum().backward()
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
            "grads": {k: p.grad.numpy() for k, p in node.named_parameters()},
            "calls": sharding.collective_stats()}


def _raises(fn) -> str | None:
    """The name of the ``ValueError`` ``fn()`` raises (None: none)."""
    try:
        fn()
    except ValueError as e:
        return type(e).__name__
    return None


def _tp_layout_checks(mesh) -> dict:
    """In the (2, 2) mesh: whether a model drawn in its training layout
    (``Model(..., train_mesh=)``) holds bitwise the slices of the whole
    model drawn from the same seed, and what raises: a whole model's
    ``train_loss`` under the mesh, ``prefill`` and ``decode_step`` of a
    model in its training layout."""
    from repro_torch.models import sharding
    from repro_torch.models.model import Model, shard_model

    cfg = lm_config("granite-moe-1b-a400m")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    with sharding.set_mesh(mesh):
        drawn = Model(cfg, CPU, torch.Generator().manual_seed(5),
                      train_mesh=mesh, fsdp=True)
        whole = Model(cfg, CPU, torch.Generator().manual_seed(5))
        lay = drawn.train_layout
        bitwise = all(torch.equal(p, lay.local(k, dict(
            whole.named_parameters())[k])) for k, p in drawn.named_parameters())
        out = {"drawn_sliced_bitwise": bitwise,
               "whole_under_tp": _raises(lambda: whole.train_loss(
                   {"tokens": toks, "labels": toks}))}
        shard_model(whole, mesh, train=True, fsdp=True)
        out["prefill"] = _raises(lambda: whole.prefill({"tokens": toks}))
        out["decode_step"] = _raises(lambda: whole.decode_step(None, toks[:, :1]))
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_serve_tp.py): (2, 2) mesh
# ---------------------------------------------------------------------------

def _kv_bytes(state) -> tuple[int, int]:
    """(bytes, count) of the GQA caches of a ``ServeState`` (K, V and
    their int8 scales)."""
    from repro_torch.models import attention as attn

    caches = [c for c in [*state.caches, *(state.attn_caches or [])]
              if isinstance(c, attn.KVCache)]
    return _local_bytes([t for c in caches for t in (c.k, c.v, c.k_scale,
                                                     c.v_scale)
                         if t is not None]), len(caches)


def _mla_bytes(state) -> tuple[int, int]:
    """(bytes, count) of the MLA latent caches of a ``ServeState`` (c_kv
    and k_rope)."""
    from repro_torch.models import attention as attn

    caches = [c for c in state.caches if isinstance(c, attn.MLACache)]
    return _local_bytes([t for c in caches for t in (c.c_kv, c.k_rope)]), len(
        caches)


def _ssm_bytes(state) -> tuple[int, int]:
    """(bytes, count) of the SSM caches of a ``ServeState`` (the state
    and both conv windows)."""
    from repro_torch.models import ssm

    caches = [c for c in state.caches if isinstance(c, ssm.SSMCache)]
    return _local_bytes([t for c in caches
                         for t in (c.state, c.conv_x, c.conv_bc)]), len(caches)


def serve_cache_tensors(state) -> list[dict]:
    """Each cache of a ``ServeState`` (its layers', then the hybrid's
    shared block's) as {field: tensor}: every tensor it holds."""
    return [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)
             if isinstance(getattr(c, f.name), torch.Tensor)}
            for c in [*state.caches, *(state.attn_caches or [])]]


def _load_cache_shards(state, whole: list[dict], mesh) -> None:
    """Overwrite the rank's caches in ``state`` with its shards of the
    caches ``whole`` (``serve_cache_tensors`` of a run without a mesh on
    the rank's rows): each dim the rank holds a part of is a "model"
    split (KV positions, SSM heads and x channels), its block at the
    rank's "model" index."""
    from repro_torch.models import sharding

    j = sharding.tp_index(mesh)
    for cache, src in zip(serve_cache_tensors(state), whole):
        for name, t in cache.items():
            w = src[name]
            for d in range(t.dim()):
                if t.shape[d] != w.shape[d]:
                    w = w.narrow(d, j * t.shape[d], t.shape[d])
            t.copy_(w)


def _serve_case(mesh, case: dict) -> dict:
    """The case's model from its numpy tree in the mesh's serving layout
    (f32 at rest): whether each rank holds exactly its slice of every
    parameter, a prefill and ``fed``'s decode steps; the logits of each
    call, the collectives of the prefill and of the last step, the
    rank's parameter, GQA, MLA and SSM cache bytes, the cross K/V's
    heads.  With ``case["forced"]`` (per step, per dispatch group, the
    caches a run without a mesh decodes that step from), a second
    prefill and each step decoded from the rank's shards of those
    caches: ``forced_logits``."""
    from repro_torch import convert
    from repro_torch.models import sharding
    from repro_torch.models.model import shard_model

    cfg = lm_config(case["arch"], case.get("overrides"))
    whole = convert.lm_named_from_tree(case["tree"])
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with sharding.set_mesh(mesh):
        shard_model(model, mesh, train=True, fsdp=False,
                    dtype=torch.float32)
        lay = model.train_layout
        exact = all(torch.equal(p, lay.local(k, torch.from_numpy(
            np.array(whole[k], np.float32)))) for k, p in model.named_parameters())
        sharding.reset_collective_stats()
        logits, state = model.prefill(batch, max_seq=case["max_seq"])
        prefill_coll = sharding.collective_stats()
        seq = [logits]
        for tok in case["fed"]:
            sharding.reset_collective_stats()
            logits, state = model.decode_step(state, torch.from_numpy(tok))
            seq.append(logits)
        kv_bytes, kv_caches = _kv_bytes(state)
        mla_bytes, mla_caches = _mla_bytes(state)
        ssm_bytes, ssm_caches = _ssm_bytes(state)
        step_coll = sharding.collective_stats()
        forced = []
        if case.get("forced"):
            group = (sharding.dp_index(mesh) if sharding.batch_split(
                mesh, batch["tokens"].shape[0]) else 0)
            _, state = model.prefill(batch, max_seq=case["max_seq"])
            for tok, whole in zip(case["fed"], case["forced"]):
                _load_cache_shards(state, whole[group], mesh)
                logits, state = model.decode_step(state, torch.from_numpy(tok))
                forced.append(logits)
    return {"logits": torch.stack(seq), "slices_exact": exact,
            "forced_logits": torch.stack(forced) if forced else None,
            "prefill_collectives": prefill_coll,
            "step_collectives": step_coll,
            "param_bytes": _local_bytes(model.parameters()),
            "kv_bytes": kv_bytes, "kv_caches": kv_caches,
            "mla_bytes": mla_bytes, "mla_caches": mla_caches,
            "ssm_bytes": ssm_bytes, "ssm_caches": ssm_caches,
            "cross_heads": (None if state.cross_kv is None
                            else state.cross_kv[0][0].shape[2])}


def _serve_bytes(mesh, case: dict) -> dict:
    """The bf16 serving layout of the case's arch built on the meta device
    (``Model(..., train_mesh=, fsdp=False, dtype=torch.bfloat16)``): the
    rank's parameter bytes, GQA, MLA and SSM cache bytes beside
    ``dryrun.reckon``'s decode cell of the same batch and context."""
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    cfg = lm_config(case["arch"], case.get("overrides"))
    b, max_seq = case["batch"], case["max_seq"]
    with sharding.set_mesh(mesh):
        model = Model(cfg, "meta", train_mesh=mesh, fsdp=False,
                      dtype=torch.bfloat16)
        state = model.init_caches(b, max_seq)
        kv_bytes, kv_caches = _kv_bytes(state)
        mla_bytes, mla_caches = _mla_bytes(state)
        ssm_bytes, ssm_caches = _ssm_bytes(state)
        reck = dryrun.reckon(cfg, "decode", b, max_seq, mesh)
    return {"param_bytes": _local_bytes(model.parameters()),
            "dtypes": sorted({str(p.dtype) for p in model.parameters()}),
            "kv_bytes": kv_bytes, "kv_caches": kv_caches,
            "mla_bytes": mla_bytes, "mla_caches": mla_caches,
            "ssm_bytes": ssm_bytes, "ssm_caches": ssm_caches,
            "reckon_params": reck["params_bytes"],
            "reckon_cache": reck["cache_bytes"]}


def _serve_refusals(mesh) -> dict:
    """What raises: serving a model in the FSDP training layout, and a
    model in the serving layout outside its mesh."""
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    cfg = lm_config("qwen3-4b")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    with sharding.set_mesh(mesh):
        fsdp = Model(cfg, CPU, train_mesh=mesh, fsdp=True)
        served = Model(cfg, CPU, train_mesh=mesh, fsdp=False,
                       dtype=torch.float32)
        out = {"fsdp_prefill": _raises(lambda: fsdp.prefill({"tokens": toks})),
               "fsdp_decode": _raises(lambda: fsdp.decode_step(
                   None, toks[:, :1]))}
    out["no_mesh_prefill"] = _raises(lambda: served.prefill({"tokens": toks}))
    return out


def run_serve_tp(dev, inputs: dict) -> dict:
    """Every tensor-parallel serving case on this rank of a (2, 2)
    ("data", "model") world, f32 compute; returns {name: output}."""
    from repro_torch.models import layers

    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh(TP_MESH, ("data", "model"), dev)
    out: dict = {"coord": tuple(mesh.get_coordinate())}
    for name, case in inputs["model"].items():
        out[f"model/{name}"] = _serve_case(mesh, case)
    for name, case in inputs["bytes"].items():
        out[f"bytes/{name}"] = _serve_bytes(mesh, case)
    out["refusals"] = _serve_refusals(mesh)
    return out


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of this one process (file rendezvous in a temporary
    directory) and its (1, 1) ("data", "model") mesh, destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=(Path(tmp) / "init").as_uri(),
                                rank=0, world_size=1)
        try:
            yield model_mesh(torch.device(CPU), 1)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# card rank bodies (tests/test_torch_cuda.py): ranks on one card, gloo
# ---------------------------------------------------------------------------

def card_series(dev, edges, w, n: int, v, degree: int, scale: float):
    """The edge-sharded series operator (K1/K2 per shard) on ``v``."""
    mesh = parallel.default_edge_mesh(device=dev)
    g = lap.make_edge_list(edges, n, weights=w, device=dev)
    op = distributed.distributed_series_operator(
        mesh, g, limit_neg_exp(degree, scale=scale), backend="kernel")
    return op(torch.from_numpy(v).to(dev))


def card_tick(dev, graphs_np, n: int, capacity: int, cs, vs, lrs, chunks,
              degree: int, steps: int):
    """One edge-sharded kernel tick of a group of stores."""
    mesh = parallel.default_edge_mesh(device=dev)
    stores = [gs.from_edge_list(lap.make_edge_list(e, n, weights=w,
                                                   device=dev),
                                capacity=capacity) for e, w in graphs_np]
    prog = program.build_tick_program(
        program.StepSchedule(degree=degree, steps=steps, backend="kernel"),
        dev, mesh=mesh)
    vs, res = prog([gs.shard_edge_rows(st, mesh) for st in stores], cs,
                   torch.from_numpy(vs).to(dev), lrs, chunks)
    return vs, res, prog.captures


def card_model_tick(dev, graphs_np, n: int, capacity: int, cs, vs, lrs, chunks,
                    degree: int, steps: int, block_n: int):
    """One panel-sharded kernel tick of a group of stores: K2 on the
    rank's owned rows per factor, one fused rows + gram all_reduce per
    mu-EG step."""
    mesh = model_mesh(dev, dist.get_world_size())
    stores = [gs.from_edge_list(lap.make_edge_list(e, n, weights=w,
                                                   device=dev),
                                capacity=capacity) for e, w in graphs_np]
    prog = program.build_tick_program(
        program.StepSchedule(degree=degree, steps=steps, backend="kernel"),
        dev, mesh=mesh, model_axes=MODEL_AXES)
    with program.count_psums() as stats:
        vs, res = prog([gs.model_shard_rows(st, mesh, MODEL_AXES,
                                            block_n=block_n)
                        for st in stores], cs,
                       torch.from_numpy(vs).to(dev), lrs, chunks)
    return vs, res, prog.captures, (stats.plain, stats.fused)


def card_cp_decode(dev, tree: dict, tokens, max_seq: int, steps: int):
    """qwen3's smoke model from ``tree`` in f32 compute on a (1, S)
    ("data", "model") mesh of this world: a prefill of ``tokens`` and
    ``steps`` decode steps fed its argmax, the caches context parallel;
    returns the logits of each call."""
    from repro_torch import convert
    from repro_torch.models import layers, sharding

    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                              dev)
    cfg = lm_config("qwen3-4b")
    model = convert.lm_params_from_numpy(cfg, tree, device=dev)
    with sharding.set_mesh(mesh):
        logits, state = model.prefill({"tokens": torch.from_numpy(tokens).to(dev)},
                                      max_seq=max_seq)
        seq = [logits]
        for _ in range(steps):
            logits, state = model.decode_step(
                state, seq[-1].argmax(-1, keepdim=True).int())
            seq.append(logits)
    assert state.caches[0].shard is not None
    return torch.stack(seq)


def card_mla_decode(dev, tree: dict, tokens, fed: list, max_seq: int):
    """deepseek's smoke model from ``tree`` in f32 compute, in the serving
    layout of the (1, world) ("data", "model") mesh of this world, on the
    card and on the CPU: a prefill of ``tokens`` and a decode step per
    entry of ``fed``, each MLA latent cache split over the sequence.
    Returns per device the logits of each call, the rank's MLA cache
    bytes and positions, and the last step's collectives."""
    from repro_torch import convert
    from repro_torch.models import layers, sharding
    from repro_torch.models.model import shard_model

    layers.COMPUTE_DTYPE = torch.float32
    mesh = parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                              dev)
    cfg = lm_config("deepseek-v2-236b")
    out = {}
    with sharding.set_mesh(mesh):
        for where in (dev, torch.device(CPU)):
            model = convert.lm_params_from_numpy(cfg, tree, device=where)
            shard_model(model, mesh, train=True, fsdp=False,
                        dtype=torch.float32)
            logits, state = model.prefill(
                {"tokens": torch.from_numpy(tokens).to(where)}, max_seq=max_seq)
            seq = [logits]
            for tok in fed:
                sharding.reset_collective_stats()
                logits, state = model.decode_step(
                    state, torch.from_numpy(tok).to(where))
                seq.append(logits)
            cache_bytes, _ = _mla_bytes(state)
            out[where.type] = {"logits": torch.stack(seq).cpu(),
                               "cache_bytes": cache_bytes,
                               "positions": state.caches[0].c_kv.shape[1],
                               "split": state.caches[0].shard is not None,
                               "calls": sharding.collective_stats()}
    return out


def card_train_dp(dev, tree: dict, batches: list, opt_fields: dict):
    """granite's smoke model from ``tree`` in f32 compute on the (world,
    1) mesh of this world: ``dryrun.build_train_step``'s data-parallel
    steps with ZeRO-1 moments on ``batches``; returns the losses and the
    parameters."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers, sharding
    from repro_torch.train import optimizer as opt_lib

    layers.COMPUTE_DTYPE = torch.float32
    cfg = lm_config("granite-moe-1b-a400m")
    model = convert.lm_params_from_numpy(cfg, tree, device=dev)
    ocfg = opt_lib.OptConfig(**opt_fields)
    losses = []
    with sharding.set_mesh(make_local_mesh(dev)):
        state = opt_lib.init(ocfg, dict(model.named_parameters()))
        step = dryrun.build_train_step(cfg, ocfg)
        for batch in batches:
            model, state, m = step(model, state, {
                k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            losses.append(m["loss"])
    return torch.stack(losses), {k: p.detach()
                                 for k, p in model.named_parameters()}


def card_train_tp(dev, arch: str, tree: dict, batches: list,
                  opt_fields: dict):
    """``arch``'s smoke model from ``tree`` in f32 compute, in the (2, 2)
    mesh's training layout with fsdp=True: ``dryrun.build_train_step``'s
    steps on ``batches``; returns the losses and the parameters gathered
    whole (by name)."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, sharding
    from repro_torch.models.model import shard_model
    from repro_torch.train import optimizer as opt_lib

    layers.COMPUTE_DTYPE = torch.float32
    cfg = lm_config(arch)
    mesh = parallel.make_mesh(TP_MESH, ("data", "model"), dev)
    model = convert.lm_params_from_numpy(cfg, tree, device=dev)
    ocfg = opt_lib.OptConfig(**opt_fields)
    losses = []
    with sharding.set_mesh(mesh):
        shard_model(model, mesh, train=True, fsdp=True)
        state = opt_lib.init(ocfg, dict(model.named_parameters()),
                             model.train_layout)
        step = dryrun.build_train_step(cfg, ocfg)
        for batch in batches:
            model, state, m = step(model, state, {
                k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            losses.append(m["loss"])
        whole = convert.lm_named_from_tree(convert.lm_params_to_numpy(model))
    return torch.stack(losses), whole


def card_heads_exchange(dev, max_seq: int, dtype: str):
    """The serving prefill's heads -> positions exchange
    (``attention.prefill_cache``) of a head-sliced node on the (1, world)
    ("data", "model") mesh of this world, from the same K/V in ``dtype``
    (the rank's KV heads of a seeded whole K/V) on the card and on the
    CPU: one all_to_all into a context-parallel cache, one all_gather
    into a whole one (``max_seq`` that does not divide); returns each
    bf16 cache's K and V as f32."""
    from repro_torch.models import attention as attn
    from repro_torch.models import sharding
    from repro_torch.models.layers import Params

    cfg = lm_config("qwen3-4b")
    mesh = parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                              dev)
    node = Params()
    node.sliced, node.mesh = True, mesh
    b, s = 2, 13
    whole = torch.randn((2, b, s, cfg.num_kv_heads, cfg.head_dim),
                        generator=torch.Generator().manual_seed(11)
                        ).to(getattr(torch, dtype))
    n = cfg.num_kv_heads // sharding.tp_extent(mesh)
    j = sharding.tp_index(mesh)
    k, v = whole[:, :, :, j * n:(j + 1) * n]
    out = {}
    with sharding.set_mesh(mesh):
        for where in (dev, torch.device(CPU)):
            sharding.reset_collective_stats()
            rows, seq, shard = attn.kv_layout(b, max_seq)
            cache = attn.init_kv_cache(cfg, rows, seq, cfg.num_kv_heads,
                                       cfg.head_dim, where, shard)
            attn.prefill_cache(node, cache, k.to(where), v.to(where))
            out[where.type] = {"k": cache.k.float().cpu(),
                               "v": cache.v.float().cpu(),
                               "length": cache.length,
                               "calls": sharding.collective_stats()}
    return out


def card_ssm_exchange(dev, dtype: str):
    """The head-sliced Mamba2 mixer's collectives on the (1, world)
    ("data", "model") mesh of this world, from the same inputs in
    ``dtype`` on the card and on the CPU: the [z | x] exchange of the
    rank's column block of a seeded whole projection (``ssm._zx_heads``)
    with its backward (the inverse exchange of a seeded upstream
    gradient), and the norm's statistic summed over "model"
    (``sharding.model_psum``) with its backward.  Returns each result as
    f32 on the CPU, and the calls."""
    from repro_torch.models import sharding, ssm
    from repro_torch.models.layers import Params

    mesh = parallel.make_mesh((1, dist.get_world_size()), ("data", "model"),
                              dev)
    node = Params()
    node.sliced, node.mesh = True, mesh
    tp, j = sharding.tp_extent(mesh), sharding.tp_index(mesh)
    gen = torch.Generator().manual_seed(13)
    dt = getattr(torch, dtype)
    b, s, d_in = 2, 5, 96
    whole = torch.randn((b, s, 2 * d_in), generator=gen).to(dt)
    up = torch.randn((2, b, s, d_in // tp), generator=gen).to(dt)
    stat = torch.randn((tp, b, s, 1), generator=gen).to(dt)
    w = 2 * d_in // tp
    out = {}
    for where in (dev, torch.device(CPU)):
        sharding.reset_collective_stats()
        zx = whole[..., j * w:(j + 1) * w].to(where).requires_grad_()
        z, x = ssm._zx_heads(node, zx)
        (z * up[0].to(where) + x * up[1].to(where)).sum().backward()
        ss = stat[j].to(where).requires_grad_()
        total = sharding.model_psum(ss, mesh)
        (total * (j + 1)).sum().backward()
        out[where.type] = {"z": z.detach().float().cpu(),
                           "x": x.detach().float().cpu(),
                           "dzx": zx.grad.float().cpu(),
                           "total": total.detach().float().cpu(),
                           "dss": ss.grad.float().cpu(),
                           "calls": sharding.collective_stats()}
    return out


def card_dryrun_sped(dev, edges: dict, v, variant: str):
    """One step of ``launch.dryrun_sped``'s ``variant`` on this rank's
    edge slice of the (world, 1) mesh, on the card."""
    from repro_torch.launch import dryrun_sped

    mesh = parallel.default_edge_mesh(device=dev)
    step = dryrun_sped.build_step(variant, mesh, SPED_EDGE_AXES)
    return step(torch.from_numpy(v).to(dev),
                {k: torch.from_numpy(a).to(dev) for k, a in edges.items()})
