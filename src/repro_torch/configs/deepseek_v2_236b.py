"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed
experts top-6.  [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: logical heads; cache is the 512-d latent
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,  # qk_nope / v head dim
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    num_experts=160,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    capacity_factor=1.25,
)
