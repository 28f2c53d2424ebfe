"""Carry the JAX package's state across to the port.

Values arrive as numpy arrays (``np.asarray`` of the JAX arrays) and
configurations as plain dicts (``dataclasses.asdict``), so this module
imports nothing of the JAX package.  The JAX backend name ``"pallas"``
maps to the port's ``"kernel"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clustering import ClusteringConfig
from repro_torch.core.laplacian import EdgeList
from repro_torch.core.solvers import SolverConfig, SolverState
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import ops as es_ops

_BACKEND_NAMES = {"pallas": "kernel"}


def _tensor(a, dtype, device) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a, dtype)).to(device)


def edge_list_from_numpy(src, dst, weight, num_nodes: int,
                         device=None) -> EdgeList:
    """An EdgeList from canonical (src <= dst) numpy edge arrays."""
    dev = resolve_device(device)
    return EdgeList(
        src=_tensor(src, np.int32, dev),
        dst=_tensor(dst, np.int32, dev),
        weight=_tensor(weight, np.float32, dev),
        num_nodes=int(num_nodes))


def node_blocking_from_numpy(u_local, other, weight, chunk_block, deg,
                             *, block_n: int, block_e: int, num_chunks: int,
                             num_nodes: int, device=None) -> es_ops.NodeBlocking:
    """A NodeBlocking from the JAX package's layout arrays.

    The real chunk offsets are recovered from the layout itself: block b's
    live half-edges fill the start of its chunk run, so its real chunk
    count is ceil(live_b / block_e), at least 1.
    """
    dev = resolve_device(device)
    weight = np.asarray(weight, np.float32)
    chunk_block = np.asarray(chunk_block, np.int32)
    nb = np.asarray(deg).shape[0] // block_n
    slot_block = np.repeat(chunk_block[:num_chunks], block_e)
    live = np.bincount(slot_block[weight != 0.0], minlength=nb)
    return es_ops.NodeBlocking(
        u_local=_tensor(u_local, np.int32, dev),
        other=_tensor(other, np.int32, dev),
        weight=_tensor(weight, np.float32, dev),
        chunk_block=_tensor(chunk_block, np.int32, dev),
        deg=_tensor(deg, np.float32, dev),
        block_n=int(block_n), block_e=int(block_e),
        num_chunks=int(num_chunks), num_nodes=int(num_nodes),
        block_chunks=_tensor(es_ops.block_chunk_offsets(live, block_e),
                             np.int32, dev))


def solver_state_from_numpy(v, step, device=None) -> SolverState:
    dev = resolve_device(device)
    return SolverState(
        v=_tensor(v, np.float32, dev), step=_tensor(step, np.int32, dev))


def solver_config_from_dict(fields: dict) -> SolverConfig:
    fields = dict(fields)
    fields["backend"] = _BACKEND_NAMES.get(fields.get("backend", "auto"),
                                           fields.get("backend", "auto"))
    return SolverConfig(**fields)


def clustering_config_from_dict(fields: dict) -> ClusteringConfig:
    """A ClusteringConfig from ``dataclasses.asdict`` of the JAX one
    (the nested solver config included)."""
    fields = dict(fields)
    solver = fields.get("solver", {})
    if not dataclasses.is_dataclass(solver):
        fields["solver"] = solver_config_from_dict(solver)
    fields["backend"] = _BACKEND_NAMES.get(fields.get("backend", "auto"),
                                           fields.get("backend", "auto"))
    return ClusteringConfig(**fields)
