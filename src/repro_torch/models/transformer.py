"""Decoder stacks of the dense and MoE block families: a loop over an
``nn.ModuleList`` of ``Block``s, which hold their own parameters (the
JAX package stacks them on a leading axis and scans).  Attention is GQA,
or MLA where the config says ``use_mla``.

SSM, hybrid and cross-attention blocks are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm


class Block(nn.Module):
    """One residual block: pre_norm -> attention, post_norm -> the MLP
    (kind "dense") or the MoE FFN (kind "moe")."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 kind: str = "dense"):
        super().__init__()
        self.cfg = cfg
        self.pre_norm = init_rmsnorm(cfg.d_model, gen.device)
        self.attn = attn.init_attention(gen, cfg)
        self.post_norm = init_rmsnorm(cfg.d_model, gen.device)
        if kind == "moe":
            self.moe = moe_mod.init_moe(gen, cfg)
        else:
            self.mlp = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        # the last MoE call's moe.MoEStats (routing, drops), kept on the
        # device; None for a dense block
        self.moe_stats = None

    def _ffn(self, h):
        """(out, aux loss) of the MLP or the MoE FFN."""
        if "moe" in self._modules:
            out, self.moe_stats = moe_mod.moe_ffn(self.moe, self.cfg, h)
            return out, self.moe_stats.aux
        return mlp(self.mlp, h), torch.zeros((), device=h.device)

    def block_train(self, x):
        """The block over a whole sequence; returns (x, cache entries,
        aux): the layer's (k, v), or (c_kv, k_rope) under MLA."""
        cfg = self.cfg
        h = rmsnorm(self.pre_norm, x, cfg.rms_eps)
        if cfg.use_mla:
            a, entries = attn.mla_train(self.attn, cfg, h)
        else:
            a, entries = attn.gqa_train(self.attn, cfg, h)
        x = x + a
        f, aux = self._ffn(rmsnorm(self.post_norm, x, cfg.rms_eps))
        return x + f, entries, aux

    def block_decode(self, x, cache):
        """One token per sequence against the layer's cache (a KVCache,
        or an MLACache under MLA), which advances in place."""
        cfg = self.cfg
        h = rmsnorm(self.pre_norm, x, cfg.rms_eps)
        decode = attn.mla_decode if cfg.use_mla else attn.gqa_decode
        a, _ = decode(self.attn, cfg, h, cache)
        x = x + a
        f, _ = self._ffn(rmsnorm(self.post_norm, x, cfg.rms_eps))
        return x + f


def stack_train(layers: nn.ModuleList, x):
    """(x, the aux losses summed over the layers)."""
    auxs = []
    for block in layers:
        x, _, aux = block.block_train(x)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def stack_decode(layers: nn.ModuleList, x, caches: list):
    """Step one token through the layers; each cache advances in place."""
    for block, cache in zip(layers, caches, strict=True):
        x = block.block_decode(x, cache)
    return x
