"""End-to-end training launcher.

Two modes share one fault-tolerant loop (checkpoint, resume, retry):

  * ``--mode lm``   - train a configuration of the registry (``--smoke``
    cuts it to ``smoke_config`` size) on the deterministic token
    pipeline: ``dryrun.build_train_step`` (backward under the config's
    remat policy, AdamW), checkpointing ``(params, opt_state)`` as the
    JAX package's tree.
  * ``--mode sped`` - the paper's workload: train the eigenvector panel V
    with the stochastic mu-EigenGame on an edge stream (SPED's training
    loop: the panel is the model, the edge minibatch is the batch; on
    the card every drawn factor is one K1 launch).

Usage (CPU-sized):

  PYTHONPATH=src python -m repro_torch.launch.train --mode sped \\
      --steps 600 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch qwen3-4b --smoke --steps 20 --device cpu

Runs on the CUDA card unless --device names another device; without a
card and without --device it exits with code 2 and the device rule's
message.  Step i draws its batch from a generator seeded from (seed,
step), so a resumed run replays nothing.

``--mode lm`` is data parallel, as the JAX package's ``train_lm`` is
under ``make_local_mesh()``: started by torchrun (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment),
``main`` joins that world over gloo and each rank runs its rows of
every global batch on a
(world, 1) ("data", "model") mesh, with ZeRO-1 moments and the model in
its training layout (FSDP of the parameters where the JAX package's
threshold puts it); otherwise it runs a world of one, which computes
what no mesh computes.  Only rank 0 prints and writes checkpoints.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --mode lm \
      --arch qwen3-4b --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import (graphs, laplacian_dense, limit_neg_exp, metrics,
                              operators, solvers,
                              spectral_radius_upper_bound)
from repro_torch.core.kmeans import cluster_agreement, kmeans
from repro_torch.data.pipeline import TokenPipeline, mixed_seed
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import build_train_step
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.frontends import synthetic_frontend
from repro_torch.models import sharding
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as opt_lib

log = logging.getLogger("train")


@dataclasses.dataclass
class LMRun:
    losses: list  # one float a step run here (from the resumed step on)
    grad_norms: list
    step_s: list  # host seconds a step, through the loss read back
    start: int  # the step resumed from (0 without a checkpoint)
    model: Model
    opt_state: opt_lib.OptState


@dataclasses.dataclass
class SpedRun:
    error: float  # subspace error against dense eigh
    accuracy: float  # k-means cluster agreement with the planted cliques
    v: torch.Tensor  # the final (n, k) panel
    steps: int  # steps run here (from the resumed step on)
    seconds: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_lm(args, device: torch.device) -> LMRun:
    """The LM loop, on the (world, 1) mesh of the initialized world (no
    mesh where none is): every rank feeds the global batch, runs its
    rows and holds its parameter slices (the training layout at
    ``fsdp=None``, drawn block by block) and its ZeRO-1 moment slices;
    rank 0 alone prints and saves (a save gathers the tree on every rank
    first)."""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
        batch_size, seq = 4, 64
    else:
        batch_size, seq = args.batch, args.seq
    world = dist.is_initialized()
    lead = not world or dist.get_rank() == 0
    opt_cfg = opt_lib.OptConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps,
                                compress_grads=args.compress_grads)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=batch_size,
                         seq_len=seq, seed=args.seed)

    def save(step, model, opt_state, **kw):
        tree = convert.lm_train_tree(model, opt_state)  # every rank gathers
        if lead:
            fault.retrying(ckpt.save)(args.ckpt_dir, step, tree, **kw)

    mesh = make_local_mesh(device) if world else None
    with sharding.set_mesh(mesh):
        model = Model(cfg, device,
                      torch.Generator(device=device).manual_seed(args.seed),
                      train_mesh=mesh)
        opt_state = opt_lib.init(opt_cfg, dict(model.named_parameters()),
                                 model.train_layout)
        start = 0
        if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
            tree, _, start = ckpt.restore_with_fallback(
                args.ckpt_dir, convert.lm_train_like(model, opt_state))
            opt_state = convert.load_lm_train_tree(model, opt_state, tree)
            log.info("resumed from step %d", start)

        train_step = build_train_step(cfg, opt_cfg)
        run = LMRun([], [], [], start, model, opt_state)
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = pipe.batch_at(step, device)
            fe_gen = torch.Generator(device=device).manual_seed(
                mixed_seed(args.seed + 1, step))
            batch.update(synthetic_frontend(fe_gen, cfg, batch_size))
            model, opt_state, m = train_step(model, opt_state, batch)
            loss = float(m["loss"])
            run.step_s.append(time.perf_counter() - t0)
            run.losses.append(loss)
            run.grad_norms.append(float(m["grad_norm"]))
            if lead and step % args.log_every == 0:
                print(f"step {step} loss {loss:.4f} gnorm "
                      f"{run.grad_norms[-1]:.3f} lr {float(m['lr']):.2e}",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1, model, opt_state, extra={"loss": loss})
        if args.ckpt_dir:
            save(args.steps, model, opt_state)
    if not np.isfinite(run.losses).all():
        raise FloatingPointError("training diverged")
    if lead and run.losses:
        print(f"final loss {run.losses[-1]:.4f} (start {run.losses[0]:.4f})")
    run.opt_state = opt_state
    return run


@contextlib.contextmanager
def _world(device: torch.device):
    """The world ``train_lm`` runs in: torchrun's, where it launched this
    process (gloo, which lets several ranks share one card; rank r takes
    card r % cards), else a gloo world of this one process; yields the
    rank's device."""
    if dist.is_torchelastic_launched():
        dist.init_process_group("gloo", init_method="env://")
        if device.type == "cuda":
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        try:
            yield device
        finally:
            dist.destroy_process_group()
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=(Path(tmp) / "init").as_uri())
        try:
            yield device
        finally:
            dist.destroy_process_group()


def sped_problem(args, device: torch.device, backend: str = "auto"):
    """(graph, planted labels, minibatch operator) of ``train_sped``: the
    clique graph and the limit series scaled by tau / rho (rho the
    Gershgorin bound); ``backend`` as in ``operators.minibatch_operator``."""
    g, truth = graphs.clique_graph(args.nodes, args.clusters, seed=args.seed,
                                   device=device)
    rho = float(spectral_radius_upper_bound(g))
    series = limit_neg_exp(args.degree, scale=args.tau / rho)
    return g, truth, operators.minibatch_operator(
        g, series, batch_edges=args.batch_edges, backend=backend)


def sped_step(op, state: solvers.SolverState, step: int, args,
              sel: torch.Tensor | None = None) -> solvers.SolverState:
    """Step ``step`` of ``train_sped``: the minibatch operator's draw from
    a generator seeded from (seed + 7, step) (or the injected ``sel``,
    see ``operators.minibatch_operator``), then one mu-EG update."""
    gen = torch.Generator(device=state.v.device).manual_seed(
        mixed_seed(args.seed + 7, step))
    return solvers.mu_eg_step(state, op(gen, state.v, sel), args.lr)


def train_sped(args, device: torch.device) -> SpedRun:
    """The paper's end-to-end training loop: the stochastic bottom-k
    eigensolver on a clique graph with the limit-series dilation,
    checkpointed."""
    g, truth, op = sped_problem(args, device)
    k = args.clusters + 1
    state = solvers.init_state(
        torch.Generator(device=device).manual_seed(args.seed), g.num_nodes, k)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (v,), _, start = ckpt.restore_with_fallback(args.ckpt_dir, (state.v,))
        state = solvers.SolverState(v=v, step=torch.tensor(
            start, dtype=torch.int32, device=device))
        log.info("resumed from step %d", start)

    _sync(device)
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        state = sped_step(op, state, step, args)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            fault.retrying(ckpt.save)(args.ckpt_dir, step + 1, (state.v,))
    _sync(device)
    dur = time.perf_counter() - t0

    _, v_star = metrics.ground_truth_bottom_k(laplacian_dense(g), k)
    err = float(metrics.subspace_error(state.v, v_star))
    emb = state.v[:, 1: 1 + args.clusters]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    labels = kmeans(torch.Generator(device=device).manual_seed(1), emb,
                    args.clusters).labels
    acc = float(cluster_agreement(labels, truth, args.clusters))
    steps = args.steps - start
    print(f"steps {steps} in {dur:.1f}s ({steps / max(dur, 1e-9):.1f} steps/s)")
    print(f"subspace_error {err:.4f} cluster_accuracy {acc:.3f}")
    return SpedRun(error=err, accuracy=acc, v=state.v, steps=steps,
                   seconds=dur)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--mode", choices=["lm", "sped"], default="sped")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    # sped
    ap.add_argument("--nodes", type=int, default=200)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--degree", type=int, default=51)
    ap.add_argument("--tau", type=float, default=8.0)
    ap.add_argument("--batch-edges", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.lr is None:
        args.lr = 3e-4 if args.mode == "lm" else 0.1
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"python -m repro_torch.launch.train: {e}", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    if args.mode == "lm":
        with _world(device) as device:
            train_lm(args, device)
    else:
        train_sped(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
