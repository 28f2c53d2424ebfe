"""Residual blocks of every family: dense and MoE (attention, then the MLP or
the MoE FFN), SSM (Mamba2) and the whisper decoder layer with cross
attention.  A ``Block`` holds its own parameters; the model runs an
``nn.ModuleList`` of them in a loop (the JAX package stacks them on a
leading axis and scans).  Attention is GQA, or MLA where the config says
``use_mla``.

Cross attention is non-causal over the encoder's output, whose K/V
(``precompute_cross_kv``) are formed once per layer in the compute dtype
and read by every decoder position, at training, prefill and decode
alike.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, dense_init, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm)


class Block(nn.Module):
    """One residual block.  Kind "dense": pre_norm -> attention, post_norm
    -> the MLP; "moe": the same with the MoE FFN; "cross" (whisper's
    decoder layer): the dense block with cross_norm -> cross attention
    between its attention and its MLP; "ssm": pre_norm -> the Mamba2
    mixer, with no MLP."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 kind: str = "dense"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.pre_norm = init_rmsnorm(cfg.d_model, gen.device)
        # the last MoE call's moe.MoEStats (routing, drops), kept on the
        # device; None for any other block
        self.moe_stats = None
        if kind == "ssm":
            self.ssm = ssm_mod.init_ssm(gen, cfg)
            return
        self.attn = attn.init_attention(gen, cfg)
        self.post_norm = init_rmsnorm(cfg.d_model, gen.device)
        if kind == "moe":
            self.moe = moe_mod.init_moe(gen, cfg)
        else:
            self.mlp = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        if kind == "cross":
            self.cross = init_cross_attention(gen, cfg)
            self.cross_norm = init_rmsnorm(cfg.d_model, gen.device)

    def _ffn(self, h):
        """(out, aux loss) of the MLP or the MoE FFN."""
        if "moe" in self._modules:
            out, self.moe_stats = moe_mod.moe_ffn(self.moe, self.cfg, h)
            return out, self.moe_stats.aux
        return mlp(self.mlp, h), torch.zeros((), device=h.device)

    def _cross(self, x, cross_kv):
        if cross_kv is None:
            return x
        h = rmsnorm(self.cross_norm, x, self.cfg.rms_eps)
        return x + _cross_attention_cached(self.cross, self.cfg, h, cross_kv)

    def block_train(self, x, cross_kv=None):
        """The block over a whole sequence; returns (x, cache entries,
        aux): the layer's (k, v), or (c_kv, k_rope) under MLA, None for
        an SSM block.  ``cross_kv``: the encoder's (k, v) for a "cross"
        block."""
        cfg = self.cfg
        h = rmsnorm(self.pre_norm, x, cfg.rms_eps)
        if self.kind == "ssm":
            return (x + ssm_mod.ssm_train(self.ssm, cfg, h), None,
                    torch.zeros((), device=x.device))
        if cfg.use_mla:
            a, entries = attn.mla_train(self.attn, cfg, h)
        else:
            a, entries = attn.gqa_train(self.attn, cfg, h)
        x = self._cross(x + a, cross_kv)
        f, aux = self._ffn(rmsnorm(self.post_norm, x, cfg.rms_eps))
        return x + f, entries, aux

    def block_prefill(self, x, cache, cross_kv=None):
        """The block over a prompt, writing its cache (a KVCache, an
        MLACache under MLA, an SSMCache for an SSM block) in place."""
        cfg = self.cfg
        if self.kind == "ssm":
            h = rmsnorm(self.pre_norm, x, cfg.rms_eps)
            y, _ = ssm_mod.ssm_prefill(self.ssm, cfg, h, cache)
            return x + y
        x, entries, _ = self.block_train(x, cross_kv)
        if cfg.use_mla:
            attn.mla_cache_update(cache, *entries, 0)
        else:
            attn.prefill_cache(self.attn, cache, *entries)
        return x

    def block_decode(self, x, cache, cross_kv=None):
        """One token per sequence against the layer's cache, which
        advances in place."""
        cfg = self.cfg
        h = rmsnorm(self.pre_norm, x, cfg.rms_eps)
        if self.kind == "ssm":
            o, _ = ssm_mod.ssm_decode(self.ssm, cfg, h, cache)
            return x + o
        decode = attn.mla_decode if cfg.use_mla else attn.gqa_decode
        a, _ = decode(self.attn, cfg, h, cache)
        x = self._cross(x + a, cross_kv)
        f, _ = self._ffn(rmsnorm(self.post_norm, x, cfg.rms_eps))
        return x + f


# --------------------------------------------------------------------------
# Cross attention (whisper enc-dec)
# --------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return Params(wq=dense_init(gen, (d, h * hd)),
                  wk=dense_init(gen, (d, h * hd)),
                  wv=dense_init(gen, (d, h * hd)),
                  wo=dense_init(gen, (h * hd, d)))


def precompute_cross_kv(p: Params, cfg: ArchConfig, enc_out):
    """The encoder output's (k, v), each (b, se, h, hd) in its dtype, over
    the heads the node holds (the rank's under a ``sliced`` node, which
    the encoder output enters)."""
    dt = enc_out.dtype
    b, se, _ = enc_out.shape
    hd = cfg.head_dim
    if p.sliced:
        enc_out = sharding.model_enter(enc_out, p.mesh)
    k = enc_out @ p["wk"].to(dt)
    v = enc_out @ p["wv"].to(dt)
    h = k.shape[-1] // hd
    return k.reshape(b, se, h, hd), v.reshape(b, se, h, hd)


def _cross_attention_cached(p: Params, cfg: ArchConfig, x, cross_kv):
    """Non-causal attention of x's positions over the encoder's (k, v);
    a ``sliced`` node's partial output summed over the model group."""
    k, v = cross_kv
    dt = x.dtype
    b, s, _ = x.shape
    hd = cfg.head_dim
    if p.sliced:
        x = sharding.model_enter(x, p.mesh)
    q = x @ p["wq"].to(dt)
    h = q.shape[-1] // hd
    out = attn._dense_attention(q.reshape(b, s, h, hd), k.to(dt), v.to(dt),
                                causal=False, q_offset=0)
    out = out.reshape(b, s, h * hd) @ p["wo"].to(dt)
    return sharding.model_sum(out, p.mesh) if p.sliced else out
