"""Fault tolerance and elasticity utilities.

The mitigations and where they live:

  * checkpoint/restart     - train/checkpoint.py (atomic, verified,
                             fallback to older steps); launch/train.py
                             saves every N steps and resumes from the
                             newest valid step.
  * deterministic data     - data/pipeline.py keys batches by (seed,
                             step): a restart replays nothing.
  * elastic re-mesh        - `elastic_mesh` below rebuilds the largest
                             usable (pod, data, model) mesh from the
                             surviving ranks; checkpoints are numpy on
                             disk and carry no sharding, so the
                             survivors restore and re-slice their
                             ZeRO-1 moments for the smaller mesh
                             (`restore_on_mesh`).
  * straggler mitigation   - SPED's walker estimates are unbiased for
                             any subset of walkers, so a deadline-based
                             sum of what arrived, scaled by the live
                             fraction, stays unbiased: `straggler_scale`.
  * retry with backoff     - `retrying` wraps flaky host-side steps
                             (I/O).
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import convert, parallel
from repro_torch.models import sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib

log = logging.getLogger(__name__)

AXES = ("pod", "data", "model")


def elastic_mesh(ranks: Sequence[int] | None = None, model_axis: int = 16,
                 pod_size: int = 256, device=None) -> tuple[DeviceMesh, list]:
    """The largest (pod, data, model) mesh of the surviving ``ranks``
    (default: every rank of the initialized world).

    Keeps the model axis fixed (parameter sharding must divide it) and
    absorbs losses into the data axis: losing hosts shrinks the global
    batch, not the model.  Returns (mesh, dropped ranks)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    model = math.gcd(model_axis, n)
    usable_pods = max(1, n // pod_size)
    per_pod = (n // usable_pods // model) * model
    usable = usable_pods * per_pod
    mesh = parallel.make_mesh((usable_pods, per_pod // model, model), AXES,
                              device, ranks=ranks[:usable])
    return mesh, ranks[usable:]


def restore_on_mesh(ckpt_dir: str, model, opt_cfg: opt_lib.OptConfig,
                    mesh, fsdp: bool | None = None
                    ) -> tuple[opt_lib.OptState, int]:
    """The survivors' restore after :func:`elastic_mesh`: under ``mesh``
    (this rank must be in it), the whole ``model`` put in the mesh's
    training layout (``shard_model(..., train=True, fsdp=fsdp)``; None:
    FSDP by the threshold) and a fresh optimizer state laid out for it
    (ZeRO-1 slices of its data extent), then the model's parameter
    slices and that state filled from the newest valid checkpoint in
    ``ckpt_dir``, whatever mesh wrote it.  Returns (state, step)."""
    from repro_torch.models.model import shard_model

    with sharding.set_mesh(mesh):
        shard_model(model, mesh, train=True, fsdp=fsdp)
        state = opt_lib.init(opt_cfg, dict(model.named_parameters()),
                             model.train_layout)
        tree, _, step = ckpt.restore_with_fallback(
            ckpt_dir, convert.lm_train_like(model, state))
        state = convert.load_lm_train_tree(model, state, tree)
    return state, step


def straggler_scale(contributions_arrived, total_workers: int) -> torch.Tensor:
    """The f32 factor total / arrived (arrived at least 1) that keeps a
    sum of partial contributions unbiased when stragglers are dropped at
    the deadline."""
    arrived = torch.clamp(torch.as_tensor(contributions_arrived), min=1)
    return torch.tensor(total_workers, dtype=torch.float32) / arrived


def retrying(fn: Callable, attempts: int = 3, base_delay: float = 0.5,
             retry_on: tuple = (IOError, OSError, ValueError)):
    """Host-side retry wrapper with exponential backoff."""

    def wrapped(*args, **kwargs):
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                if i == attempts - 1:
                    raise
                delay = base_delay * (2 ** i)
                log.warning("attempt %d/%d failed (%s); retrying in %.1fs",
                            i + 1, attempts, e, delay)
                time.sleep(delay)

    return wrapped


class HeartbeatMonitor:
    """Per-host step timestamps; hosts silent past ``timeout_s`` are
    declared dead, which triggers ``elastic_mesh`` and a restore in the
    training loop.  The liveness transport is deployment-specific; this
    class holds the policy."""

    def __init__(self, num_hosts: int, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last_seen = {h: time.time() for h in range(num_hosts)}

    def beat(self, host: int):
        self.last_seen[host] = time.time()

    def dead_hosts(self) -> list[int]:
        now = time.time()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]
