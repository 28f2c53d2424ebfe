"""zamba2-1.2b [hybrid] — Mamba2 blocks + one weight-SHARED attention
block applied every 6 layers.  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    sub_quadratic=True,  # SSM backbone => long_500k applicable
)
