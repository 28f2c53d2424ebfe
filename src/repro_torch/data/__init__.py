"""Data pipelines of the port: the EDGE stream of SPED."""
from repro_torch.data.pipeline import EdgePipeline  # noqa: F401
