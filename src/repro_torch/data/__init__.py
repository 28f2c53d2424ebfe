"""Data pipelines of the port: the TOKEN stream of the LM substrate and
the EDGE stream of SPED."""
from repro_torch.data.pipeline import EdgePipeline, TokenPipeline  # noqa: F401
