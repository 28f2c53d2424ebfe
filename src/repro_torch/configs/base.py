"""Architecture config schema for the assigned-architecture pool.

One frozen dataclass describes every family (dense / moe / ssm / hybrid /
encdec-audio / vlm); family-specific fields default to "off".  Exact
dimension values live in the per-arch files of this package.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    capacity_factor: float = 1.25
    # dense d_ff is used for shared experts / first dense layers if any
    moe_first_dense_layers: int = 0

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    v_head_dim: int = 0  # 0 -> head_dim

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): one weight-SHARED attention block applied
    # every `attn_every` layers, interleaved with SSM blocks
    attn_every: int = 0

    # encoder-decoder (whisper): encoder consumes stub frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0  # e.g. 1500 mel frames

    # vlm stub frontend: first `num_patch_tokens` positions are replaced
    # by precomputed patch embeddings from input_specs()
    num_patch_tokens: int = 0

    # serving
    kv_cache_dtype: str = "bfloat16"  # or "int8" for memory-tight decode

    # does the arch support O(seq) long-context decode? (SSM/hybrid yes)
    sub_quadratic: bool = False

    # MLP style: SwiGLU (gated, 3 mats) vs classic 2-mat GELU MLP
    gated_mlp: bool = True

    # activation checkpointing: "full" (recompute everything, min memory),
    # "dots" (save matmul outputs, recompute elementwise only — removes
    # the remat re-forward, compute factor 8/6 -> 6/6), "none"
    remat_policy: str = "full" 

    # norm
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.use_mla and not self.v_head_dim:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder_cache(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), used for the
        roofline MODEL_FLOPS = 6 N D term."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # unembed
        L = self.num_layers
        if self.family in ("dense", "moe", "vlm"):
            n += L * self._attn_params()
            if self.family == "moe":
                n += L * (self.num_experts * 3 * d * self.moe_d_ff
                          + self.num_shared_experts * 3 * d * self.moe_d_ff
                          + d * self.num_experts)
            else:
                mats = 3 if self.gated_mlp else 2
                n += L * mats * d * self.d_ff
        elif self.family == "ssm":
            n += L * self._ssm_params()
        elif self.family == "hybrid":
            n_attn_blocks = 1  # weight-shared
            n += L * self._ssm_params() + n_attn_blocks * (
                self._attn_params() + 3 * d * self.d_ff)
        elif self.family == "encdec":
            mats = 3 if self.gated_mlp else 2
            n += self.encoder_layers * (self._attn_params() + mats * d * self.d_ff)
            n += L * (2 * self._attn_params() + mats * d * self.d_ff)
        n += L * 2 * d  # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        L = self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += L * self._attn_params()
        n += L * (self.moe_top_k + self.num_shared_experts) * 3 * d * self.moe_d_ff
        n += L * d * self.num_experts  # router
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            hd = self.head_dim  # nope dim per head
            rd = self.qk_rope_head_dim
            r = self.kv_lora_rank
            return (d * self.num_heads * (hd + rd)  # q proj
                    + d * (r + rd)  # kv down + k_rope
                    + r * self.num_heads * (hd + self.v_head_dim)  # kv up
                    + self.num_heads * self.v_head_dim * d)  # out
        hd = self.head_dim
        return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)

    def _ssm_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        nh = di // self.ssm_headdim
        return (d * (2 * di + 2 * self.ssm_state + nh)  # in_proj (z,x,B,C,dt)
                + di * self.ssm_conv + di * d + nh + nh)  # conv, out, A, D
