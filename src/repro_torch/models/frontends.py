"""Modality frontend stubs: the audio and vlm configurations specify the
transformer backbone only, and the stub tensors stand in for
precomputed frame or patch embeddings.

These helpers give the stub tensors' shapes and dtypes and a
deterministic synthetic generator for smoke runs and examples.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def frontend_spec(cfg: ArchConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of the stub tensors."""
    if cfg.family == "encdec":
        return {"frames": ((batch, cfg.encoder_seq, cfg.d_model),
                           torch.bfloat16)}
    if cfg.family == "vlm":
        return {"patches": ((batch, cfg.num_patch_tokens, cfg.d_model),
                            torch.bfloat16)}
    return {}


def synthetic_frontend(gen: torch.Generator, cfg: ArchConfig,
                       batch: int) -> dict:
    """N(0, 0.02^2) stub tensors drawn on the generator's device."""
    return {name: (torch.randn(shape, generator=gen, device=gen.device)
                   * 0.02).to(dtype)
            for name, (shape, dtype) in frontend_spec(cfg, batch).items()}
