"""AdamW with the JAX package's trimmings, no external dependencies:

  * global-norm gradient clipping;
  * a cosine schedule with linear warmup;
  * ZeRO-1 (``zero1``): under a ``DeviceMesh`` whose data axes hold
    several ranks (``models.sharding.set_mesh``), each rank holds only
    its slice of each moment, laid out by the JAX package's
    ``moment_specs`` (``launch.shardings.zero1_layout``), updates its
    slice of each parameter from it and all_gathers the parameters;
    without a mesh, or with one data rank, the moments stay whole;
  * optional gradient COMPRESSION with error feedback (int8 quantization
    of the data-parallel all-reduce payload; the residual carries to the
    next step);
  * ``moment_dtype="bfloat16"`` stores the moments in bf16 (the math
    stays f32), halving their bytes.

Parameters, gradients and moments are dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``); under ZeRO-1 the
moment dicts hold the rank's slices, and no entry for a layer another
rank owns.  For a model in its training layout (``shards``, the model's
``train_layout``) the parameters and gradients are the rank's slices
too: the clip norm and the int8 scale of compression are then those of
the whole tensors, reduced over the mesh, and ZeRO-1 slices each
parameter slice further (an FSDP slice is its own moments' slice).  ``apply`` updates
the parameters, the moments and the residuals IN PLACE, as torch.optim
does, and returns them; the schedule, the bias corrections and the
clipping scale are f32 tensors on the parameters' device, computed as
the JAX package computes them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch import shardings
from repro_torch.models import sharding


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 + error feedback on the DP payload
    zero1: bool = True  # shard moments over "dp" (whole without a mesh)
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: dict  # first moments
    nu: dict  # second moments
    error: dict | None  # compression residuals, None without compression
    # the ZeRO-1 layout the moments were made for (None: whole), chosen
    # once by ``init``; not a tensor, so no checkpoint leaf
    layout: shardings.Zero1Layout | None = None
    # the model's training layout the parameters are sliced by (None:
    # whole); not a checkpoint leaf either
    shards: shardings.TrainLayout | None = None


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int32 tensor), f32."""
    step = torch.as_tensor(step, dtype=torch.int32).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def _parts(lay, params: dict) -> dict:
    """The rank's part of each parameter (all of it without a layout)."""
    if lay is None:
        return params
    parts = {k: lay.part(k, p) for k, p in params.items()}
    return {k: p for k, p in parts.items() if p is not None}


def init(cfg: OptConfig, params: dict,
         shards: shardings.TrainLayout | None = None) -> OptState:
    """Zero moments and, with compression, zero residuals of the
    parameters' shapes.  With ``zero1`` under a ``DeviceMesh``
    (``sharding.set_mesh``) whose data axes hold several ranks, the
    moments are the rank's slices of ``launch.shardings.zero1_layout``,
    which the state carries.  ``shards``: the training layout the
    parameters are sliced by (the model's ``train_layout``)."""
    mdt = _moment_dtype(cfg)
    first = next(iter(params.values()))
    mesh = sharding.current_mesh()
    if shards is not None and mesh != shards.mesh:
        raise ValueError("the training layout's mesh is not the mesh in "
                         "context")
    lay = (shardings.zero1_layout(params, mesh, shards=shards)
           if cfg.zero1 and getattr(mesh, "mesh_dim_names", None) is not None
           else None)
    parts = _parts(lay, params)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in parts.items()},
        nu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in parts.items()},
        error=({k: torch.zeros_like(p) for k, p in params.items()}
               if cfg.compress_grads else None),
        layout=lay,
        shards=shards if shards is not None and shards.holds_slices else None)


def whole_moments(state: OptState, params: dict):
    """(mu, nu) of the parameters' shapes (the rank's parameter slices
    under a training layout), on their device: the state's own dicts
    where they hold that, else every rank's ZeRO-1 slices gathered over
    the data group of the state's layout (a collective)."""
    lay = state.layout
    if lay is None:
        return state.mu, state.nu
    out = []
    for local in (state.mu, state.nu):
        dtype = next(iter(local.values())).dtype
        whole = {k: torch.empty(p.shape, dtype=dtype, device=p.device)
                 for k, p in params.items()}
        for k, sp in lay.splits.items():
            if sp.owner is None and sp.dim is None:
                whole[k].copy_(local[k])
        lay.gather(local, whole)
        out.append(whole)
    return tuple(out)


def load_moments(state: OptState, mu: dict, nu: dict) -> None:
    """Copy whole moments ``mu``, ``nu`` (by name) into the state's, in
    place: the rank's slices where the state holds slices."""
    lay, shards = state.layout, state.shards
    with torch.no_grad():
        for local, whole in ((state.mu, mu), (state.nu, nu)):
            for k, t in local.items():
                w = whole[k] if shards is None else shards.local(k, whole[k])
                t.copy_(w if lay is None else lay.part(k, w))


def _quantize_int8(g: torch.Tensor, amax: torch.Tensor | None = None):
    """int8 codes of g and their scale, from ``amax`` (default: max|g|;
    a slice's caller passes the whole tensor's)."""
    amax = torch.max(torch.abs(g)) if amax is None else amax
    scale = amax / 127.0 + 1e-30
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        amax: torch.Tensor | None = None):
    """Error-feedback int8 round trip: (g_hat, new_err), where g_hat is
    what the compressed all-reduce would deliver and new_err carries the
    quantization residual to the next step; ``amax`` as in
    ``_quantize_int8``, of g + err."""
    target = g + err
    q, scale = _quantize_int8(target, amax)
    g_hat = q.to(g.dtype) * scale
    return g_hat, target - g_hat


def _mesh_reduce(x: torch.Tensor, op, mesh) -> torch.Tensor:
    """``x`` reduced by ``op`` over every rank of ``mesh``: over its data
    group, then its model group."""
    x = sharding.all_reduce(x, op, sharding.data_group(mesh))
    return sharding.all_reduce(x, op, sharding.model_group(mesh))


def _whole_amax(targets: dict, mesh) -> dict:
    """Each tensor's max|.| over the whole tensor of which the rank holds
    a slice: one vector of the slices' maxima, reduced by MAX over the
    mesh (a leaf's unsplit dims hold the same values on every rank)."""
    names = list(targets)
    amax = _mesh_reduce(torch.stack([torch.max(torch.abs(targets[k]))
                                     for k in names]),
                        dist.ReduceOp.MAX, mesh)
    return dict(zip(names, amax))


@torch.no_grad()
def apply(cfg: OptConfig, state: OptState, params: dict, grads: dict):
    """One AdamW step, in place.  Returns (params, new state, metrics
    {"grad_norm", "lr"} as 0-dim f32 tensors).

    ``grads`` are whole (under a mesh: already averaged over the data
    group, the same on every rank), so the clip norm is global.  Under
    ZeRO-1 each rank updates its part of each parameter from its moment
    slices, and one all_gather of the data group re-assembles the
    parameters: they stay bitwise equal on every rank.

    Under a training layout (``state.shards``) ``grads`` are the rank's
    slices, averaged: each rank sums the squares of its slices, each
    leaf's sum divided by the ranks that hold that same slice, and the
    sum over the mesh is the whole gradients' norm; compression scales
    each slice by its whole leaf's max|g|.  The ZeRO-1 gather then
    re-assembles only the parameters that FSDP does not split."""
    lay, shards = state.layout, state.shards
    if cfg.compress_grads:
        targets = {k: g + state.error[k] for k, g in grads.items()}
        amax = (_whole_amax(targets, shards.mesh) if shards is not None
                else dict.fromkeys(grads))
        hat = {}
        for k, g in grads.items():
            hat[k], new_err = compress_decompress(g, state.error[k], amax[k])
            state.error[k].copy_(new_err)
        grads = hat

    if shards is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
    else:
        gnorm = torch.sqrt(_mesh_reduce(
            sum(torch.sum(torch.square(g.float())) / shards.replicas(k)
                for k, g in grads.items()), dist.ReduceOp.SUM,
            shards.mesh))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step).to(gnorm.device)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    parts = _parts(lay, params)
    for k, p in parts.items():
        g = grads[k] if lay is None else lay.part(k, grads[k])
        g = g.float() * scale
        m = cfg.b1 * state.mu[k].float() + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[k].float() + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p.copy_(p - lr * (upd + cfg.weight_decay * p))
        state.mu[k].copy_(m)
        state.nu[k].copy_(v)
    if lay is not None:
        lay.gather(parts, params)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
