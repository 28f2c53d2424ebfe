"""Decoder stacks of the dense block family: a loop over an
``nn.ModuleList`` of ``Block``s, which hold their own parameters (the
JAX package stacks them on a leading axis and scans).

MoE, SSM, hybrid and cross-attention blocks are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm


class Block(nn.Module):
    """One dense residual block: pre_norm -> attention, post_norm -> MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.pre_norm = init_rmsnorm(cfg.d_model, gen.device)
        self.attn = attn.init_attention(gen, cfg)
        self.post_norm = init_rmsnorm(cfg.d_model, gen.device)
        self.mlp = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp)

    def block_train(self, x):
        """The block over a whole sequence; returns (x, (k, v)), the
        layer's K/V for a cache."""
        cfg = self.cfg
        a, kv = attn.gqa_train(self.attn, cfg, rmsnorm(self.pre_norm, x,
                                                       cfg.rms_eps))
        x = x + a
        return x + mlp(self.mlp, rmsnorm(self.post_norm, x, cfg.rms_eps)), kv

    def block_decode(self, x, cache: attn.KVCache):
        """One token per sequence against the layer's cache, which
        advances in place."""
        cfg = self.cfg
        a, _ = attn.gqa_decode(self.attn, cfg,
                               rmsnorm(self.pre_norm, x, cfg.rms_eps), cache)
        x = x + a
        return x + mlp(self.mlp, rmsnorm(self.post_norm, x, cfg.rms_eps))


def stack_train(layers: nn.ModuleList, x):
    for block in layers:
        x, _ = block.block_train(x)
    return x


def stack_decode(layers: nn.ModuleList, x, caches: list):
    """Step one token through the layers; each cache advances in place."""
    for block, cache in zip(layers, caches, strict=True):
        x = block.block_decode(x, cache)
    return x
