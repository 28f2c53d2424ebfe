"""qwen1.5-32b [dense] — QKV bias, near-MHA GQA.  [hf:Qwen/Qwen1.5-0.5B
family scaled per assignment; hf-verified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    # 64L near-MHA cache at 128 x 32k decode is the pool's largest KV
    # footprint: int8 cache (per-vector scales) keeps it on-chip (see
    # EXPERIMENTS.md #Dry-run memory table)
    kv_cache_dtype="int8",
)
