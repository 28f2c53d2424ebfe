"""The LM substrate's models: the dense, vlm and MoE block families (GQA
with optional QKV bias and qk-norm, bf16 or int8 KV cache, chunked
attention; MLA with a latent cache and weight-absorbed decode; the
sort-dispatched MoE FFN with shared experts)."""
from repro_torch.models.model import Model, ServeState  # noqa: F401
