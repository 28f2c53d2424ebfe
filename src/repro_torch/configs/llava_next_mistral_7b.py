"""llava-next-mistral-7b [vlm] — Mistral-7B backbone; anyres tiling
frontend STUBBED (input_specs provides 576 patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    num_patch_tokens=576,
)
