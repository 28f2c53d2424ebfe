"""whisper-small [audio] — enc-dec; conv frontend STUBBED (input_specs
provides 1500 precomputed frame embeddings).  [arXiv:2212.04356;
unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_seq=1500,
    gated_mlp=False,
)
