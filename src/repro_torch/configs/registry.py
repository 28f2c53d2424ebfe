"""Registry of the 10 assigned architectures (+ reduced smoke variants).

Exact dimensions from the assignment block; sources noted per entry.
Selectable via --arch <id> in launch/ and benchmarks/.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.qwen15_32b import CONFIG as _qwen15_32b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.minitron_8b import CONFIG as _minitron_8b
from repro_torch.configs.whisper_small import CONFIG as _whisper_small
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2_1p2b
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2_236b
from repro_torch.configs.granite_moe_1b import CONFIG as _granite_moe_1b
from repro_torch.configs.mamba2_2p7b import CONFIG as _mamba2_2p7b
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        _qwen15_32b, _qwen3_4b, _starcoder2_15b, _minitron_8b,
        _whisper_small, _zamba2_1p2b, _deepseek_v2_236b, _granite_moe_1b,
        _mamba2_2p7b, _llava,
    ]
}

# Input-shape set shared by the LM pool (assignment block).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def shape_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (full attention at 524k is
    not deployable — skip noted in DESIGN.md Sec. 4)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small layers/width/experts/vocab, runs a
    forward/train step on CPU."""
    repl: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.num_heads:
        repl["num_heads"] = 4
        repl["num_kv_heads"] = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads \
            < cfg.num_heads else 4
    if cfg.family == "moe":
        # capacity_factor 4.0 makes the smoke capacity non-binding (worst
        # case: every token routes its top-k to one expert), so the
        # prefill==decode round-trip tests compare the same computation;
        # production capacity behavior is exercised by the dry-run.
        repl.update(num_experts=8, moe_top_k=2, moe_d_ff=64,
                    num_shared_experts=min(cfg.num_shared_experts, 1),
                    capacity_factor=4.0)
    if cfg.use_mla:
        repl.update(kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm_state:
        repl.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        repl.update(num_layers=5, attn_every=3)
    if cfg.family == "encdec":
        repl.update(encoder_layers=2, encoder_seq=16)
    if cfg.family == "vlm":
        repl.update(num_patch_tokens=8)
    return dataclasses.replace(cfg, **repl)
