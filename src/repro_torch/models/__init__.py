"""The LM substrate's models: the dense and vlm block families (GQA with
optional QKV bias and qk-norm, bf16 or int8 KV cache, chunked attention)."""
from repro_torch.models.model import Model, ServeState  # noqa: F401
