"""The LM substrate's models, every family of the registry: dense and vlm
(GQA with optional QKV bias and qk-norm, bf16 or int8 KV cache, chunked
attention), MoE (MLA with a latent cache and weight-absorbed decode; the
sort-dispatched MoE FFN with shared experts), ssm (the Mamba2 SSD scan
with an O(1)-state decode), hybrid (SSM groups around one weight-shared
attention block) and encdec (whisper's encoder and cross attention)."""
from repro_torch.models.model import Model, ServeState  # noqa: F401
