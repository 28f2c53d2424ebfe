"""Sharded serving: the mesh policies of ``ServiceConfig(mesh=...)``.

Every rank of the mesh runs the same ``StreamingService`` on the same
inputs (one rank is one shard, :mod:`repro_torch.parallel`): the host
logic, the stores and the panels are replicated, and each group tick is
one edge-sharded :class:`~repro_torch.core.program.TickProgram` over the
rank's shard of every member (``graph_store.shard_edge_rows``), one
all_reduce of the stacked panel per dilation factor.  The tick builders
live in :mod:`repro_torch.core.program` and are re-exported here.

Decomposition contract: shard s computes ``deg_s v - A_s v`` from ITS
contiguous slice of the capacity-padded edge buffer only, so the
all_reduce gives ``L v`` with no diagonal counted twice; a shard whose
slice is all padding contributes exact zeros.  Admission and growth
round edge capacities up to a multiple of the shard count
(:func:`balanced_capacity`), so every shard owns ``capacity / S`` slots.
The kernel-epilogue AXPY of a one-device tick is traded for the
collective: the factor ``u - c L u`` applies after the all_reduce.

PANEL sharding (``ServiceConfig(model_axes=...)``) is the second mesh
policy: the (n, k) panel itself splits by row range.  Shard s owns rows
``[s R, (s + 1) R)`` and every half-edge destined there
(``graph_store.model_shard_rows``), so its rows of each dilation factor
are final (the AXPY stays in K2's epilogue), the collectives only
assemble disjoint rows, and a mu-EG step ships its row assembly and
2k x 2k gram in ONE fused all_reduce (``build_tick_model_sharded``).
There is no edge-balance contract to keep: the layout re-buckets edges
by destination, so any capacity works on any shard count.
"""
from __future__ import annotations

from repro_torch.core.program import (  # noqa: F401  (re-exported tick builders)
    build_tick_model_sharded,
    build_tick_sharded_pallas,
    build_tick_sharded_segment,
    num_model_shards,
)
from repro_torch.parallel import num_edge_shards  # noqa: F401


def balanced_capacity(capacity: int, num_shards: int) -> int:
    """Smallest capacity >= ``capacity`` that divides evenly into the
    shards.  Capacity classes are powers of two and meshes usually too,
    so this is almost always the identity; it makes the balance invariant
    explicit at admission and growth."""
    return capacity + (-capacity) % max(num_shards, 1)


__all__ = [
    "balanced_capacity",
    "build_tick_model_sharded",
    "build_tick_sharded_pallas",
    "build_tick_sharded_segment",
    "num_edge_shards",
    "num_model_shards",
]
