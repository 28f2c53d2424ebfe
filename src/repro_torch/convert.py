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
from repro_torch.core.laplacian import EdgeIncidence, EdgeList
from repro_torch.core.solvers import SolverConfig, SolverState
from repro_torch.core.walks import WalkBatch
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.spectral.probes import ProbeResult
from repro_torch.stream.graph_store import EdgeBatch, GraphStore
from repro_torch.stream.updates import EigenEstimate

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


def edge_incidence_from_numpy(nbrs, deg, ip, deg_star_inc: int,
                              device=None) -> EdgeIncidence:
    """An EdgeIncidence from the JAX package's arrays."""
    dev = resolve_device(device)
    return EdgeIncidence(
        nbrs=_tensor(nbrs, np.int32, dev), deg=_tensor(deg, np.int32, dev),
        ip=_tensor(ip, np.float32, dev), deg_star_inc=int(deg_star_inc))


def walk_batch_from_numpy(first_edge, edge_at, alpha, logp,
                          device=None) -> WalkBatch:
    """A WalkBatch from the JAX package's arrays, so that the port's
    estimators can read the JAX draw."""
    dev = resolve_device(device)
    return WalkBatch(
        first_edge=_tensor(first_edge, np.int32, dev),
        edge_at=_tensor(edge_at, np.int32, dev),
        alpha=_tensor(alpha, np.float32, dev),
        logp=_tensor(logp, np.float32, dev))


def node_blocking_from_numpy(u_local, other, weight, chunk_block, deg,
                             *, block_n: int, block_e: int, num_chunks: int,
                             num_nodes: int, device=None) -> es_ops.NodeBlocking:
    """A NodeBlocking from the JAX package's layout arrays.

    The real chunk offsets are recovered from the layout itself: block b's
    live half-edges fill the start of its chunk run, so its real chunk
    count is ceil(live_b / block_e), at least 1.  The kernels' row CSR is
    built from the result on its device (``es_ops.blocking_rows``).
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


def probe_result_from_numpy(ritz, weights, lambda_max, trace, n,
                            num_matvecs, device=None) -> ProbeResult:
    """A ProbeResult from the fields of the JAX package's (``np.asarray``
    of each), so the port's planner can read the JAX probe."""
    dev = resolve_device(device)
    return ProbeResult(
        ritz=_tensor(ritz, np.float32, dev),
        weights=_tensor(weights, np.float32, dev),
        lambda_max=_tensor(lambda_max, np.float32, dev),
        trace=_tensor(trace, np.float32, dev),
        n=_tensor(n, np.float32, dev),
        num_matvecs=_tensor(num_matvecs, np.int32, dev))


def graph_store_from_numpy(src, dst, weight, deg, deg_dirty, num_nodes: int,
                           device=None) -> GraphStore:
    """A GraphStore from the JAX package's buffers (``deg_dirty`` its
    0-dim bool); the row-CSR cache starts empty."""
    dev = resolve_device(device)
    return GraphStore(
        src=_tensor(src, np.int32, dev), dst=_tensor(dst, np.int32, dev),
        weight=_tensor(weight, np.float32, dev),
        deg=_tensor(deg, np.float32, dev), deg_dirty=bool(np.asarray(deg_dirty)),
        num_nodes=int(num_nodes))


def edge_batch_from_numpy(src, dst, weight, device=None) -> EdgeBatch:
    """An EdgeBatch from the JAX package's (canonical, padded) arrays."""
    dev = resolve_device(device)
    return EdgeBatch(src=_tensor(src, np.int32, dev),
                     dst=_tensor(dst, np.int32, dev),
                     weight=_tensor(weight, np.float32, dev))


def eigen_estimate_from_numpy(lam, v, drift, device=None) -> EigenEstimate:
    """An EigenEstimate from the JAX package's (lam, v, drift)."""
    dev = resolve_device(device)
    return EigenEstimate(lam=_tensor(lam, np.float32, dev),
                         v=_tensor(v, np.float32, dev),
                         drift=_tensor(drift, np.float32, dev))


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
