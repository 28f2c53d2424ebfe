"""The training step of the JAX package's dry-run, for one device.

``build_train_step`` is the program ``repro.launch.dryrun`` compiles for
a train cell: the forward and backward pass of ``Model.train_loss``
(under the config's remat policy), optionally accumulated over
microbatches, then one AdamW step.  The dry-run's cell report (memory
and cost analyses of every arch x shape x mesh) is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_lib


def build_train_step(cfg: ArchConfig, opt_cfg: opt_lib.OptConfig,
                     microbatches: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)`` for a ``Model`` of ``cfg``.

    With ``microbatches`` > 1 the batch splits into that many sequential
    slices along its first axis, which shrinks the live activations by
    the same factor: each slice's gradients add into the parameters'
    ``.grad`` (f32), the sum is divided by ``microbatches``, and the
    optimizer applies once.  The loss and the metrics are the slices'
    means.  The parameters and the state update in place
    (``optimizer.apply``); the gradients are freed after the step.
    Metrics are 0-dim tensors on the model's device: "loss", "xent",
    "aux", "grad_norm", "lr".
    """

    def train_step(model: Model, opt_state: opt_lib.OptState, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"the step was built for {cfg.name}, the model "
                             f"is a {model.cfg.name}")
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        size = rows // microbatches
        slices = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                  for i in range(microbatches)]
        losses, xents, auxs = [], [], []
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
        _, opt_state, om = opt_lib.apply(opt_cfg, opt_state, params, grads)
        model.zero_grad(set_to_none=True)

        def mean(xs):
            return torch.stack(xs).mean()

        return model, opt_state, {"xent": mean(xents), "aux": mean(auxs),
                                  **om, "loss": mean(losses)}

    return train_step
