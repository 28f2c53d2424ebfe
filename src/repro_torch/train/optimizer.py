"""AdamW with the JAX package's trimmings, no external dependencies:

  * global-norm gradient clipping;
  * a cosine schedule with linear warmup;
  * ZeRO-1's field (moments sharded over the data axis): without a mesh
    the moments stay whole, as the JAX package's are without one;
  * optional gradient COMPRESSION with error feedback (int8 quantization
    of the data-parallel all-reduce payload; the residual carries to the
    next step);
  * ``moment_dtype="bfloat16"`` stores the moments in bf16 (the math
    stays f32), halving their bytes.

Parameters, gradients and moments are dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``).  ``apply`` updates
the parameters, the moments and the residuals IN PLACE, as torch.optim
does, and returns them; the schedule, the bias corrections and the
clipping scale are f32 tensors on the parameters' device, computed as
the JAX package computes them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


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


def init(cfg: OptConfig, params: dict) -> OptState:
    mdt = _moment_dtype(cfg)
    first = next(iter(params.values()))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in params.items()},
        error=({k: torch.zeros_like(p) for k, p in params.items()}
               if cfg.compress_grads else None))


def _quantize_int8(g: torch.Tensor):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-30
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 round trip: (g_hat, new_err), where g_hat is
    what the compressed all-reduce would deliver and new_err carries the
    quantization residual to the next step."""
    target = g + err
    q, scale = _quantize_int8(target)
    g_hat = q.to(g.dtype) * scale
    return g_hat, target - g_hat


@torch.no_grad()
def apply(cfg: OptConfig, state: OptState, params: dict, grads: dict):
    """One AdamW step, in place.  Returns (params, new state, metrics
    {"grad_norm", "lr"} as 0-dim f32 tensors)."""
    if cfg.compress_grads:
        hat = {}
        for k, g in grads.items():
            hat[k], new_err = compress_decompress(g, state.error[k])
            state.error[k].copy_(new_err)
        grads = hat

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step).to(gnorm.device)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    for k, p in params.items():
        g = grads[k].float() * scale
        m = cfg.b1 * state.mu[k].float() + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[k].float() + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p.copy_(p - lr * (upd + cfg.weight_decay * p))
        state.mu[k].copy_(m)
        state.nu[k].copy_(v)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
