"""The JAX package's dry-run, for the port: the training step it compiles
for a train cell (``build_train_step``), the serving steps
(``build_prefill``, ``build_decode_step``), and the cell report of every
(arch x shape x mesh) cell (``run_cell``, ``main``).

A cell's report is what one rank of the production mesh holds as the
step's arguments, reckoned from meta tensors (nothing is allocated; a
whole deepseek-v2-236b is 943 GB in f32) under the partition rules of
``launch.shardings``:
  * train: the f32 parameters under ``param_specs`` (FSDP decided by the
    rules), the ``OptState`` (moments under ``moment_specs``, the
    compression residuals under the parameter specs, the int32 step)
    and the batch under ``batch_specs``;
  * prefill: the parameters in bf16 under ``param_specs(fsdp=False)``
    and the batch without labels;
  * decode: the same bf16 parameters, the ``ServeState`` under
    ``cache_specs`` and the (b, 1) tokens.
The JAX package reads ``memory_analysis().argument_size_in_bytes`` of the
compiled step; the compiler's other fields (flops, bytes accessed,
collectives, temp bytes, the CPU dot upcasts) have no counterpart here
and are None.  ``fits`` holds the argument bytes to the card's memory
(or the ``budget_bytes`` a caller passes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape decode_32k --mesh both --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as shr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding
from repro_torch.models.frontends import frontend_spec
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_lib

SKIP_REASON = "full-attention arch at 524k context (DESIGN.md Sec. 4)"


# --------------------------------------------------------------------------
# Meta stand-ins for every input
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def meta_model(cfg: ArchConfig) -> Model:
    """The model of ``cfg`` on the meta device (shapes, no values)."""
    return Model(cfg, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shapes(cfg: ArchConfig, kind: str, batch: int, seq: int) -> dict:
    """The step's batch as meta tensors: tokens and labels (b, s) int32
    and the stub frontends for a train step, the same without labels
    for a prefill, the (b, 1) tokens for a decode step."""
    if kind == "decode":
        return {"tokens": _meta((batch, 1), torch.int32)}
    out = {"tokens": _meta((batch, seq), torch.int32),
           "labels": _meta((batch, seq), torch.int32)}
    for name, (shape, dtype) in frontend_spec(cfg, batch).items():
        out[name] = _meta(shape, dtype)
    if kind == "prefill":
        out.pop("labels")
    return out


def input_specs(cfg: ArchConfig, shape_name: str):
    """(batch of meta tensors, kind) of a registry shape."""
    sh = SHAPES[shape_name]
    return (batch_shapes(cfg, sh["kind"], sh["global_batch"], sh["seq_len"]),
            sh["kind"])


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int):
    """The ``ServeState`` of ``Model.init_caches`` in meta tensors, whole
    (no mesh)."""
    with sharding.set_mesh(None):
        return meta_model(cfg).init_caches(batch, max_seq)


# --------------------------------------------------------------------------
# Programs
# --------------------------------------------------------------------------

def train_grads(model: Model, batch: dict, microbatches: int = 1):
    """(gradients by parameter name, {"loss", "xent", "aux"}) of one step
    of ``build_train_step`` on ``batch``: what the step hands to
    ``optimizer.apply``.  The parameters' ``.grad`` are left set.

    With ``microbatches`` > 1 the batch splits into that many sequential
    slices along its first axis, which shrinks the live activations by
    the same factor: each slice's gradients add into the parameters'
    ``.grad`` (f32), and the sum is divided by ``microbatches``.  The
    loss and the metrics are the slices' means, 0-dim tensors.

    Under a ``DeviceMesh`` (``sharding.set_mesh``) it takes the global
    batch on every rank and runs the rank's rows (its block of the data
    axes; every row where the batch does not divide by their extent),
    its microbatches being slices of those rows.  The gradients are
    averaged over the data group in flat f32 buckets
    (``sharding.mean_buckets``), but for the parameters that the
    model's training layout splits over the data axes (FSDP): their
    gather's backward already took that mean.  The loss and xent
    reported are the data group's means (aux already is one)."""
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    mesh = sharding.current_mesh()
    rows = next(iter(batch.values())).shape[0]
    split = mesh is not None and sharding.batch_split(mesh, rows)
    if split:
        batch = {k: sharding.own_rows(mesh, v) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    size = rows // microbatches
    slices = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
              for i in range(microbatches)]
    losses, xents, auxs = [], [], []
    with sharding.model_rows(split):  # no mesh: nothing reads it
        for piece in slices:
            loss, metrics = model.train_loss(piece)
            loss.backward()
            losses.append(loss.detach())
            xents.append(metrics["xent"].detach())
            auxs.append(metrics["aux"].detach())
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items()}
    if microbatches > 1:
        for g in grads.values():
            g.div_(microbatches)
    lay = model.train_layout
    if split:
        sharding.mean_buckets([g for k, g in grads.items()
                               if lay is None or lay.splits[k].data is None],
                              mesh)

    def mean(xs):
        return torch.stack(xs).mean()

    loss, xent = mean(losses), mean(xents)
    if split:
        both = torch.stack([loss, xent])
        sharding.mean_buckets([both], mesh)
        loss, xent = both[0], both[1]
    return grads, {"xent": xent, "aux": mean(auxs), "loss": loss}


def build_train_step(cfg: ArchConfig, opt_cfg: opt_lib.OptConfig,
                     microbatches: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)`` for a ``Model`` of ``cfg``: the gradients of
    :func:`train_grads` (``microbatches`` as there), then
    ``optimizer.apply`` once.  The parameters and the state update in
    place; the gradients are freed after the step.  Metrics are 0-dim
    tensors on the model's device: "loss", "xent", "aux", "grad_norm",
    "lr".

    Under a ``DeviceMesh`` the step runs the rank's rows and averages the
    gradients over the data group (:func:`train_grads`), and
    ``optimizer.apply`` updates the parameters under ZeRO-1.  A model in
    its training layout (``model.shard_model(..., train=True)``) holds
    and updates the rank's slices; its layers gather what they need and
    compute on "model" slices where they can.  With one rank the step is
    the step without a mesh.
    """

    def train_step(model: Model, opt_state: opt_lib.OptState, batch: dict):
        _check(model, cfg)
        sliced = (model.train_layout is not None
                  and model.train_layout.holds_slices)
        if (opt_state.shards is None) == sliced:
            raise ValueError("the optimizer state was not made for the "
                             "model's training layout (optimizer.init(..., "
                             "shards=model.train_layout))")
        grads, metrics = train_grads(model, batch, microbatches)
        _, opt_state, om = opt_lib.apply(opt_cfg, opt_state,
                                         dict(model.named_parameters()), grads)
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"xent": metrics["xent"],
                                  "aux": metrics["aux"], **om,
                                  "loss": metrics["loss"]}

    return train_step


def _check(model: Model, cfg: ArchConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model "
                         f"is a {model.cfg.name}")


def build_decode_step(cfg: ArchConfig):
    """``serve_step(model, state, tokens) -> (logits, state)``."""

    def serve_step(model: Model, state, tokens):
        _check(model, cfg)
        return model.decode_step(state, tokens)

    return serve_step


def build_prefill(cfg: ArchConfig, max_seq: int):
    """``prefill_step(model, batch) -> (logits, state)`` with caches of
    ``max_seq`` positions."""

    def prefill_step(model: Model, batch: dict):
        _check(model, cfg)
        return model.prefill(batch, max_seq=max_seq)

    return prefill_step


# --------------------------------------------------------------------------
# The reckoning
# --------------------------------------------------------------------------

def reckon(cfg: ArchConfig, kind: str, batch: int, seq: int, mesh,
           opt_cfg: opt_lib.OptConfig | None = None) -> dict:
    """The bytes one rank of ``mesh`` holds as a ``kind`` step's
    arguments at ``batch`` x ``seq`` (a decode step: caches of ``seq``
    positions), split into params, optimizer, caches and batch, with
    their sum ``argument_bytes``."""
    model = meta_model(cfg)
    serving = kind != "train"
    params = shr.stacked_param_shapes(model,
                                      torch.bfloat16 if serving else None)
    p_specs = shr.param_specs(cfg, params, mesh,
                              fsdp=False if serving else None)
    inputs = batch_shapes(cfg, kind, batch, seq)
    out = {"params_bytes": shr.tree_bytes(params, p_specs, mesh),
           "optimizer_bytes": 0, "cache_bytes": 0,
           "batch_bytes": shr.tree_bytes(
               inputs, shr.batch_specs(mesh, inputs), mesh)}
    if kind == "train":
        opt_cfg = opt_cfg or opt_lib.OptConfig()
        moments = shr.stacked_param_shapes(
            model, getattr(torch, opt_cfg.moment_dtype))
        m_bytes = shr.tree_bytes(moments,
                                 shr.moment_specs(p_specs, params, mesh), mesh)
        out["optimizer_bytes"] = (4 + 2 * m_bytes  # step, mu, nu
                                  + (out["params_bytes"]
                                     if opt_cfg.compress_grads else 0))
    elif kind == "decode":
        caches = shr.stacked_cache_shapes(cache_shapes(cfg, batch, seq))
        out["cache_bytes"] = shr.tree_bytes(
            caches, shr.cache_specs(cfg, mesh, caches), mesh)
    out["argument_bytes"] = (out["params_bytes"] + out["optimizer_bytes"]
                             + out["cache_bytes"] + out["batch_bytes"])
    return out


def card_budget() -> int | None:
    """The card's memory in bytes, None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


# --------------------------------------------------------------------------
# One cell
# --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_overrides: dict | None = None, remat: str | None = None,
             microbatches: int = 1, budget_bytes: int | None = None) -> dict:
    """The cell's record, with the JAX package's keys where the port has
    them.  ``microbatches`` moves only the step's temporaries, which are
    not reckoned; ``budget_bytes`` (the card's memory when None and a
    card is present) decides ``fits``."""
    cfg = get_arch(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    mesh_name = "multipod" if multi_pod else "pod"
    if not shape_applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIP_REASON}
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    mem = reckon(cfg, kind, sh["global_batch"], sh["seq_len"], mesh,
                 opt_lib.OptConfig(**(opt_overrides or {})))
    budget = card_budget() if budget_bytes is None else budget_bytes
    mem.update(budget_bytes=budget,
               fits=None if budget is None else mem["argument_bytes"] <= budget,
               output_bytes=None, temp_bytes=None, generated_code_bytes=None,
               cpu_dot_upcast_bytes=None)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "kind": kind,
        "devices": mesh.size,
        "seconds": round(time.time() - t0, 1),
        "flops": None,
        "bytes_accessed": None,
        "memory": mem,
        "collectives": None,
        "remat": cfg.remat_policy,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def _gb(x: int) -> str:
    return f"{x / 1e9:.3f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--save-hlo", default=None)
    ap.add_argument("--remat", default=None, choices=["full", "dots", "none"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="memory a rank has (default: the card's)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        print("dryrun: --save-hlo has no counterpart here (no compiler HLO); "
              "the report reckons argument bytes only", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multipod"]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
                try:
                    res = run_cell(
                        arch, shape, mp, remat=args.remat,
                        microbatches=args.microbatch,
                        budget_bytes=args.budget_bytes,
                        opt_overrides={"moment_dtype": args.moment_dtype}
                        if args.moment_dtype != "float32" else None)
                except Exception as e:
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multipod" if mp else "pod",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if res["status"] == "ok":
                    m = res["memory"]
                    extra = (f" args={_gb(m['argument_bytes'])}GB"
                             f" params={_gb(m['params_bytes'])}"
                             f" opt={_gb(m['optimizer_bytes'])}"
                             f" caches={_gb(m['cache_bytes'])}"
                             f" batch={_gb(m['batch_bytes'])}"
                             f" fits={m['fits']} t={res['seconds']}s")
                print(f"[dryrun] {tag}: {res['status']}{extra}", flush=True)
    if failures:
        print(f"[dryrun] {failures} FAILURES", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
