"""starcoder2-15b [dense] — GQA kv=4, RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100_000.0,
    gated_mlp=False,  # classic 2-matrix GELU MLP
)
