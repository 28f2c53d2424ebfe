"""The LM architecture configurations: the port's own copy of the JAX
package's registry (plain data; every name is known, though the model code
builds only the families ported so far)."""
from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, shape_applicable, smoke_config  # noqa: F401
