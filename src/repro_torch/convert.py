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

from repro_torch.configs.base import ArchConfig
from repro_torch.core.clustering import ClusteringConfig
from repro_torch.core.laplacian import EdgeIncidence, EdgeList
from repro_torch.core.solvers import SolverConfig, SolverState
from repro_torch.core.walks import WalkBatch
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.models.model import Model
from repro_torch.spectral.probes import ProbeResult
from repro_torch.stream.graph_store import EdgeBatch, GraphStore
from repro_torch.stream.updates import EigenEstimate
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptState

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


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_tree(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


# the layer stacks of the JAX package's LM tree (vmapped init, axis 0)
_STACKED = ("layers", "ssm_layers", "enc_layers")


def lm_named_from_tree(tree: dict) -> dict:
    """The JAX package's LM tree (nested dicts; each of ``_STACKED``
    stacked on axis 0) as leaves keyed by the port's parameter names,
    each stacked leaf split into ``<stack>.<i>.<rest>``.  Holds for any
    tree of that shape: the parameters, the moments, the residuals."""
    named = {}
    for name, arr in _flat_tree(tree).items():
        stack, _, rest = name.partition(".")
        if stack in _STACKED:
            for i in range(arr.shape[0]):
                named[f"{stack}.{i}.{rest}"] = arr[i]
        else:
            named[name] = arr
    return named


def lm_tree_from_named(named: dict) -> dict:
    """``lm_named_from_tree``'s inverse: tensors keyed by the port's
    parameter names -> the JAX package's nested tree, each of
    ``_STACKED`` stacked on axis 0 (``torch.stack``, on the tensors'
    device)."""
    flat: dict = {}
    for name, t in named.items():
        stack, _, rest = name.partition(".")
        if stack in _STACKED:
            i, _, rest = rest.partition(".")
            flat.setdefault(f"{stack}.{rest}", {})[int(i)] = t
        else:
            flat[name] = t
    tree: dict = {}
    for name, t in flat.items():
        if isinstance(t, dict):
            t = torch.stack([t[i] for i in range(len(t))])
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def lm_params_from_numpy(cfg: ArchConfig, params: dict, device=None) -> Model:
    """A ``models.Model`` of ``cfg`` holding the JAX package's parameter
    tree ``params`` (nested dicts of numpy leaves; the vmapped init
    stacks each of ``_STACKED`` on axis 0, unstacked here into
    ``<stack>.<i>``; the hybrid's ``shared_attn`` is one block in both).
    Raises on a missing or extra key and on any shape mismatch."""
    flat = {name: np.asarray(a) for name, a in lm_named_from_tree(params).items()}
    model = Model(cfg, device=device)
    own = dict(model.named_parameters())
    if own.keys() != flat.keys():
        raise KeyError(f"parameter tree differs from {cfg.name}'s: missing "
                       f"{sorted(own.keys() - flat.keys())}, extra "
                       f"{sorted(flat.keys() - own.keys())}")
    with torch.no_grad():
        for name, param in own.items():
            if tuple(param.shape) != flat[name].shape:
                raise ValueError(f"{name}: shape {flat[name].shape}, the "
                                 f"model's {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
    return model


def _whole_named(model: Model, named: dict) -> dict:
    """``named`` (tensors of the parameters' shapes, by name) whole on the
    CPU: a model in its training layout holds slices, gathered one by one
    (a collective of every rank of its mesh)."""
    lay = model.train_layout
    return {k: (t if lay is None else lay.whole(k, t)).detach().cpu()
            for k, t in named.items()}


def lm_params_to_numpy(model: Model) -> dict:
    """The model's parameters as the JAX package's tree: nested dicts of
    numpy arrays, each of ``_STACKED`` stacked on axis 0; whole, gathered
    where the model is in its training layout."""
    tree = lm_tree_from_named(_whole_named(model,
                                           dict(model.named_parameters())))
    return _map_dict(lambda t: t.numpy(), tree)


def _map_dict(fn, tree: dict) -> dict:
    return {k: _map_dict(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def lm_train_tree(model: Model, opt_state: OptState) -> tuple:
    """(params, opt_state) as the JAX package's training tree, on the
    CPU: ``(params, OptState(step, mu, nu, error))``, each of the dicts
    stacked as ``lm_tree_from_named`` stacks it (``error`` None without
    compression).  ``train.checkpoint`` saves it in ``repro``'s leaf
    order.  ZeRO-1 moment slices are gathered first
    (``optimizer.whole_moments``, a collective of the data group of the
    state's layout), then, for a model in its training layout, every
    parameter, moment and residual slice over both groups
    (``TrainLayout.whole``), so every rank's tree is the one a single
    process holding the same state makes."""

    def tree(named):
        return lm_tree_from_named(_whole_named(model, named))

    params = dict(model.named_parameters())
    mu, nu = opt_lib.whole_moments(opt_state, params)
    return (tree(params), OptState(
        step=opt_state.step.cpu(), mu=tree(mu), nu=tree(nu),
        error=None if opt_state.error is None else tree(opt_state.error)))


def lm_train_like(model: Model, opt_state: OptState) -> tuple:
    """A tree of ``lm_train_tree``'s form, shapes and dtypes, of
    uninitialized CPU tensors (no collective): what
    ``train.checkpoint.restore`` restores into."""
    params = dict(model.named_parameters())
    mdt = next(iter(opt_state.mu.values())).dtype
    lay = model.train_layout

    def tree(named, dtype=None):
        return lm_tree_from_named({
            k: torch.empty(t.shape if lay is None else lay.splits[k].shape,
                           dtype=dtype or t.dtype)
            for k, t in named.items()})

    return (tree(params), OptState(
        step=torch.empty((), dtype=torch.int32), mu=tree(params, mdt),
        nu=tree(params, mdt),
        error=None if opt_state.error is None else tree(opt_state.error)))


def load_lm_train_tree(model: Model, opt_state: OptState, tree) -> OptState:
    """Copy a tree of ``lm_train_tree``'s form into the model's
    parameters and ``opt_state``'s moments and residuals, in place;
    returns the state with the tree's step.  A model in its training
    layout takes its slice of each parameter and residual; where the
    state holds ZeRO-1 slices, each moment is sliced for this rank of the
    state's layout (``optimizer.load_moments``), whatever mesh wrote the
    tree."""
    params, state = tree
    lay = model.train_layout
    pairs = [(dict(model.named_parameters()), params)]
    if opt_state.error is not None:
        pairs.append((opt_state.error, state.error))
    with torch.no_grad():
        for dst, src in pairs:
            src = lm_named_from_tree(src)
            for name, t in dst.items():
                t.copy_(src[name] if lay is None else lay.local(name, src[name]))
    opt_lib.load_moments(opt_state, lm_named_from_tree(state.mu),
                         lm_named_from_tree(state.nu))
    return opt_state._replace(step=state.step.to(opt_state.step.device))
