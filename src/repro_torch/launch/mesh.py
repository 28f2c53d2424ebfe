"""Production meshes and the local mesh.

Single pod: 16 x 16 = 256 chips, axes ("data", "model").  Multi-pod:
2 x 16 x 16 = 512 chips, axes ("pod", "data", "model"); the "pod" axis
carries only data parallelism.  No host runs 256 ranks, so a production
mesh is an :class:`AbstractMesh`: its axis names and sizes, all that the
partition rules (``launch.shardings``, ``models.sharding``) read.
:func:`make_local_mesh` is a real ``DeviceMesh`` over the initialized
world, on which the sharded serving path runs.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from repro_torch import parallel


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh described by its axes only (no ranks, no devices)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_local_mesh(device=None):
    """The world's ranks as a (world, 1) ("data", "model") mesh;
    ``device`` (None = the card) names its device type."""
    return parallel.make_mesh((dist.get_world_size(), 1), ("data", "model"),
                              device)
