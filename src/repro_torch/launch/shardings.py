"""Partitioning rules: map every parameter, optimizer, batch and cache
tensor to a spec for a mesh (a ``launch.mesh.AbstractMesh`` or a
``DeviceMesh``), as the JAX package's rules do.

Policy:
  * TP ("model"): attention heads, FFN hidden, MoE experts (EP), Mamba2
    heads, the vocabulary dim of the embedding tables.
  * DP ("pod", "data"): batch dims of activations and caches; FSDP of the
    parameters and moments of archs whose parameters a TP shard exceed
    ``FSDP_THRESHOLD`` bytes (counted at 4 bytes a parameter, whatever the
    dtype).
  * ZeRO-1 moments: also sharded over DP on the first free, divisible
    dim.
  * every rule falls back to replication where the dim does not divide
    by the mesh extent.

A spec is a tuple of per-dim entries (an axis name, a tuple of names or
None; ``models.sharding``).  The rules run on the STACKED trees the JAX
package decides on: nested dicts keyed like its parameter tree, each
layer stack one (L, ...) leaf (:func:`stacked_param_shapes`, made from
the port's per-layer parameters as meta tensors, with no copies), and a
``ServeState`` whose caches are each one stacked cache
(:func:`stacked_cache_shapes`).  :func:`train_layout` maps the
parameter specs back onto the port's per-layer tensors (the training
layout: each rank's slice of every parameter), and :func:`zero1_layout`
the moment specs, for the step's ZeRO-1 optimizer state.  The rules align a parameter's rule to
its rightmost dims, so the layer axis of a parameter is never split; a
moment's may be (``moment_specs`` takes the first free divisible dim,
often the layer axis), and then a rank holds whole layers.
:func:`local_shape` is the shape one rank holds of a leaf.  The JAX
package's ``to_named`` (a ``NamedSharding`` per spec) has no
counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.model import ServeState
from repro_torch.models.sharding import dp_axes, tp_axis
from repro_torch.models.sharding import extent as _extent

# parameters bigger than this a TP shard get FSDP over the dp axes
FSDP_THRESHOLD = 3 * 2 ** 30


def mesh_axes(mesh):
    """(dp axes present, "model" or None)."""
    return dp_axes(mesh), tp_axis(mesh)


# --------------------------------------------------------------------------
# Trees: nested dicts (parameters, batches) and serving states
# --------------------------------------------------------------------------

def _map_dict(fn, tree: dict, path: tuple = ()) -> dict:
    return {k: _map_dict(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _leaf_pairs(shapes, specs):
    """(shape leaf, spec) pairs of a shape tree and its spec tree: nested
    dicts, ``ServeState`` s, caches, tuples and lists, walked in step;
    None nodes hold nothing."""
    if shapes is None:
        return
    if isinstance(shapes, torch.Tensor):
        yield shapes, specs
    elif isinstance(shapes, dict):
        for k, v in shapes.items():
            yield from _leaf_pairs(v, specs[k])
    elif dataclasses.is_dataclass(shapes):
        for f in dataclasses.fields(shapes):
            yield from _leaf_pairs(getattr(shapes, f.name),
                                  getattr(specs, f.name))
    elif isinstance(shapes, (tuple, list)):
        for v, s in zip(shapes, specs):
            yield from _leaf_pairs(v, s)
    else:
        raise TypeError(f"unknown tree node {type(shapes)}")


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape one rank holds of a tensor of ``shape`` under ``spec``."""
    shape = tuple(int(s) for s in shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, spec):
        ext = _extent(mesh, entry)
        if size % ext:
            raise ValueError(f"dim {size} does not divide over {entry} ({ext})")
        out.append(size // ext)
    return tuple(out)


def tree_bytes(shapes, specs, mesh) -> int:
    """Bytes one rank holds of the tree: each leaf's local shape times
    its element size."""
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in _leaf_pairs(shapes, specs))


def stacked_param_shapes(model, dtype=None) -> dict:
    """The model's parameters as the JAX package's stacked tree of meta
    tensors (``dtype`` where given, else each parameter's): the mapping
    of ``convert.lm_params_to_numpy``, without a copy."""
    from repro_torch import convert

    return convert.lm_tree_from_named({
        name: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")
        for name, p in model.named_parameters()})


def _stack(tensors):
    if tensors[0] is None:
        return None
    return torch.empty((len(tensors),) + tuple(tensors[0].shape),
                       dtype=tensors[0].dtype, device="meta")


def _stack_caches(caches: list):
    if not caches:
        return None
    first = caches[0]
    fields = {f.name: _stack([getattr(c, f.name) for c in caches])
              for f in dataclasses.fields(first)
              if f.name not in ("length", "shard")}
    # the JAX package stacks each layer's 0-dim int32 length as well
    return type(first)(**fields, length=torch.empty(
        (len(caches),), dtype=torch.int32, device="meta"))


def stacked_cache_shapes(state: ServeState) -> ServeState:
    """A ``ServeState`` of per-layer caches as the JAX package's stacked
    one, in meta tensors: each list of caches one cache whose tensors
    lead with the layer axis (``length`` an (L,) int32), ``cross_kv`` a
    stacked (k, v)."""
    cross = None
    if state.cross_kv is not None:
        cross = tuple(_stack([kv[i] for kv in state.cross_kv]) for i in (0, 1))
    return ServeState(caches=_stack_caches(state.caches), cross_kv=cross,
                      attn_caches=_stack_caches(state.attn_caches or []))


# --------------------------------------------------------------------------
# Parameter rules
# --------------------------------------------------------------------------

def _param_rule(names: tuple[str, ...]) -> tuple[str | None, ...]:
    """Per-dim logical axes of the UNSTACKED tensor, rightmost dims
    aligned ('tp' on the dim noted)."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if name == "table":  # embed/unembed (vocab, d)
        return ("tp", "fsdp")
    if name in ("wq", "wk", "wv", "w_kv_up"):
        return ("fsdp", "tp")
    if name == "wo":
        return ("tp", "fsdp")
    if name in ("bq", "bk", "bv"):
        return ("tp",)
    if name in ("w_gate", "w_up"):
        if parent == "moe":
            return ("tp", "fsdp", None)
        return ("fsdp", "tp")
    if name == "w_down":
        if parent == "moe":
            return ("tp", "fsdp", None)
        return ("tp", "fsdp")
    if name == "router":
        return (None, None)
    if name in ("w_kv_down", "w_k_rope"):
        return ("fsdp", None)
    if name == "w_zx":
        return ("fsdp", "tp")
    if name == "w_bcdt":
        return ("fsdp", None)
    if name == "conv_w_x":
        return (None, "tp")
    if name == "conv_b_x":
        return ("tp",)
    if name == "w_out":  # ssm out proj (d_in, d)
        return ("tp", "fsdp")
    return ()  # scalars and vectors: replicated


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def fsdp_default(params_shapes: dict, mesh) -> bool:
    """FSDP where the parameters' f32 bytes a TP shard exceed
    ``FSDP_THRESHOLD``: ``param_specs``' choice for ``fsdp`` None."""
    tp_ext = _extent(mesh, tp_axis(mesh))
    total_bytes = sum(math.prod(l.shape) * 4 for l in _leaves(params_shapes))
    return total_bytes / max(tp_ext, 1) > FSDP_THRESHOLD


def param_specs(cfg: ArchConfig, params_shapes: dict, mesh,
                fsdp: bool | None = None) -> dict:
    """The spec tree of ``params_shapes`` (a stacked tree); ``fsdp`` None
    decides FSDP by the parameters' f32 bytes a TP shard."""
    dp, tp = mesh_axes(mesh)
    if fsdp is None:
        fsdp = fsdp_default(params_shapes, mesh)

    def one(names, leaf):
        shape = leaf.shape
        # moe expert tensors (E, d, f): the expert dim EP-sharded
        if "moe" in names and names[-1] in ("w_gate", "w_up", "w_down") \
                and "shared" not in names:
            base = ("tp", "fsdp", None)
        else:
            base = _param_rule(names)
        # align base to the rightmost dims (stacked layer axes lead)
        spec: list = [None] * len(shape)
        for i, ax in enumerate(base):
            di = len(shape) - len(base) + i
            if di < 0:
                continue
            if ax == "tp" and tp and shape[di] % _extent(mesh, tp) == 0:
                spec[di] = tp
            elif ax == "fsdp" and fsdp and dp and \
                    shape[di] % _extent(mesh, dp) == 0:
                spec[di] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    return _map_dict(one, params_shapes)


def moment_specs(param_spec_tree: dict, params_shapes: dict, mesh) -> dict:
    """ZeRO-1: a moment's spec is its parameter's plus dp on the first
    free, divisible dim (unless the parameter is already dp-sharded)."""
    dp, _ = mesh_axes(mesh)
    dp_ext = _extent(mesh, dp)

    def one(spec, leaf):
        if not dp or dp_ext == 1:
            return spec
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = set()
        for e in entries:
            if e is None:
                continue
            used.update(e if isinstance(e, tuple) else (e,))
        if any(a in used for a in dp):
            return spec  # already dp-sharded (fsdp)
        for i, e in enumerate(entries):
            if e is None and leaf.shape[i] % dp_ext == 0 and leaf.shape[i] > 0:
                entries[i] = dp if len(dp) > 1 else dp[0]
                return tuple(entries)
        return spec

    def walk(specs, shapes):
        return {k: walk(specs[k], v) if isinstance(v, dict)
                else one(specs[k], v) for k, v in shapes.items()}

    return walk(param_spec_tree, params_shapes)


# --------------------------------------------------------------------------
# Batch and cache rules
# --------------------------------------------------------------------------

def batch_specs(mesh, batch_shapes: dict) -> dict:
    """tokens / labels (b, s) and the stub frontends (b, s, d): the batch
    over dp."""
    dp, _ = mesh_axes(mesh)

    def one(_, leaf):
        spec = [None] * len(leaf.shape)
        if dp and leaf.shape[0] % _extent(mesh, dp) == 0:
            spec[0] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    return _map_dict(one, batch_shapes)


def cache_specs(cfg: ArchConfig, mesh, cache_shapes: ServeState) -> ServeState:
    """Serving-state specs of a stacked ``ServeState``
    (:func:`stacked_cache_shapes`).  The layer axis leads, then batch and
    sequence:
      KV k/v (L, b, s, kv, hd):   b -> dp, s -> model (context parallel)
      MLA c_kv (L, b, s, r):      b -> dp, s -> model
      SSM state (L, b, h, p, n):  b -> dp, h -> model
      cross_kv (L, b, se, h, hd): b -> dp, h -> model
    A dim that does not divide by the mesh extent is replicated; each
    ``length`` is replicated."""
    dp, tp = mesh_axes(mesh)
    dp_ax = (dp if len(dp) > 1 else dp[0]) if dp else None
    tp_ext = _extent(mesh, tp)
    dp_ext = _extent(mesh, dp)

    def dim(shape, i, logical):
        if i >= len(shape):
            return None
        if logical == "dp" and dp and shape[i] % dp_ext == 0:
            return dp_ax
        if logical == "tp" and tp and shape[i] % tp_ext == 0:
            return tp
        return None

    def mk(leaf, logicals):
        if leaf is None:
            return None
        shape = leaf.shape
        spec = [dim(shape, i, l) if l else None
                for i, l in enumerate(logicals[:len(shape)])]
        spec += [None] * (len(shape) - len(spec))
        return tuple(spec)

    def dispatch(c):
        if c is None:
            return None
        if isinstance(c, attn.KVCache):
            sp = (None, "dp", "tp", None, None)
            return attn.KVCache(k=mk(c.k, sp), v=mk(c.v, sp),
                                k_scale=mk(c.k_scale, sp),
                                v_scale=mk(c.v_scale, sp), length=())
        if isinstance(c, attn.MLACache):
            sp = (None, "dp", "tp", None)
            return attn.MLACache(c_kv=mk(c.c_kv, sp), k_rope=mk(c.k_rope, sp),
                                 length=())
        if isinstance(c, ssm_mod.SSMCache):
            return ssm_mod.SSMCache(
                state=mk(c.state, (None, "dp", "tp", None, None)),
                conv_x=mk(c.conv_x, (None, "dp", None, "tp")),
                conv_bc=mk(c.conv_bc, (None, "dp", None, None)), length=())
        if isinstance(c, tuple):  # whisper cross_kv: (k, v) (L, b, se, h, hd)
            return tuple(mk(x, (None, "dp", None, "tp", None)) for x in c)
        raise TypeError(f"unknown cache node {type(c)}")

    if not isinstance(cache_shapes, ServeState):
        raise TypeError("cache_specs takes a ServeState")
    return ServeState(caches=dispatch(cache_shapes.caches),
                      cross_kv=dispatch(cache_shapes.cross_kv),
                      attn_caches=dispatch(cache_shapes.attn_caches))


# --------------------------------------------------------------------------
# The training layout: the parameter specs on the port's per-layer tensors
# --------------------------------------------------------------------------

def _meta_tree(shapes: dict) -> dict:
    """The stacked tree of meta tensors of ``shapes`` (port name ->
    shape)."""
    from repro_torch.convert import lm_tree_from_named

    return lm_tree_from_named({k: torch.empty(v, device="meta")
                               for k, v in shapes.items()})


def _named_entry(name: str, specs: dict, shapes: dict):
    """(spec, stacked leaf, layer or None) of the port's parameter
    ``name`` in a stacked spec tree and its shape tree; a stacked
    leaf's spec leads with its layer axis."""
    from repro_torch.convert import _STACKED

    stack, _, rest = name.partition(".")
    layer = None
    if stack in _STACKED:
        i, _, rest = rest.partition(".")
        layer, path = int(i), [stack] + rest.split(".")
    else:
        path = name.split(".")
    node, leaf = specs, shapes
    for key in path:
        node, leaf = node[key], leaf[key]
    return tuple(node), leaf, layer


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """The training layout on ``mesh``: ``splits`` maps each of the port's
    parameter names to its ``sharding.ParamSplit`` under the JAX
    package's ``param_specs(cfg, stacked shapes, mesh, fsdp)`` (an
    axis of extent 1 splits nothing); ``index`` is the (data, model)
    coordinate whose slices the rank holds."""

    splits: dict
    mesh: object
    fsdp: bool
    index: tuple

    def bounds(self, name: str, index: tuple | None = None) -> tuple:
        """(start, size) along each dim of the slice coordinate ``index``
        (default: this rank's) holds of parameter ``name``."""
        sp = self.splits[name]
        di, ti = self.index if index is None else index
        out = []
        for d, size in enumerate(sp.shape):
            if d == sp.data:
                n = size // _extent(self.mesh, dp_axes(self.mesh))
                out.append((di * n, n))
            elif d == sp.model:
                n = size // _extent(self.mesh, tp_axis(self.mesh))
                out.append((ti * n, n))
            else:
                out.append((0, size))
        return tuple(out)

    def local(self, name: str, t: torch.Tensor, index: tuple | None = None):
        """The slice ``index`` (default: this rank's) of ``t``, a whole
        tensor of parameter ``name``'s shape: a view."""
        for d, (start, size) in enumerate(self.bounds(name, index)):
            if size != t.shape[d]:
                t = t.narrow(d, start, size)
        return t

    def replicas(self, name: str) -> int:
        """How many ranks of the mesh hold the same slice of ``name``."""
        sp = self.splits[name]
        dp_ext = _extent(self.mesh, dp_axes(self.mesh))
        tp_ext = _extent(self.mesh, tp_axis(self.mesh))
        return (1 if sp.data is not None else dp_ext) * (
            1 if sp.model is not None else tp_ext)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` (parameter ``name``'s shape) is
        this rank's slice: a collective of every rank of the mesh."""
        return sharding.gather_whole(t, self.splits[name], self.mesh)

    @property
    def holds_slices(self) -> bool:
        """Whether any parameter is split (else every rank holds the
        whole model)."""
        return any(sp.data is not None or sp.model is not None
                   for sp in self.splits.values())


def train_layout(cfg: ArchConfig, mesh, fsdp: bool | None = None,
                 index: tuple | None = None) -> TrainLayout:
    """The training layout of ``cfg``'s model on ``mesh`` (a
    ``DeviceMesh``, or an ``AbstractMesh`` with the (data, model)
    ``index`` to hold): ``param_specs(cfg, shapes, mesh, fsdp)`` of the
    stacked tree (``fsdp`` None: by the threshold), each leaf's spec
    mapped onto each layer's tensor (a parameter's layer axis is never
    split), with ``models.model.computes_sliced`` for its "model" dim."""
    from repro_torch.models.model import Model, computes_sliced

    named = {k: tuple(p.shape)
             for k, p in Model(cfg, device="meta").named_parameters()}
    shapes = _meta_tree(named)
    if fsdp is None:
        fsdp = fsdp_default(shapes, mesh)
    specs = param_specs(cfg, shapes, mesh, fsdp=fsdp)
    dp, tp = mesh_axes(mesh)
    dp_ext, tp_ext = _extent(mesh, dp), _extent(mesh, tp)
    dp_entry = (dp if len(dp) > 1 else dp[0]) if dp else None
    splits = {}
    for name, shape in named.items():
        spec, _, layer = _named_entry(name, specs, shapes)
        if layer is not None:
            spec = spec[1:]
        spec = list(spec) + [None] * (len(shape) - len(spec))
        data = spec.index(dp_entry) if dp_ext > 1 and dp_entry in spec else None
        model = spec.index(tp) if tp_ext > 1 and tp in spec else None
        splits[name] = sharding.ParamSplit(
            shape, data, model,
            model is not None and computes_sliced(cfg, name, tp_ext))
    if index is None:
        index = (sharding.dp_index(mesh), sharding.tp_index(mesh))
    return TrainLayout(splits, mesh, bool(fsdp), tuple(index))


# --------------------------------------------------------------------------
# ZeRO-1: the moment specs on the port's per-layer parameters
# --------------------------------------------------------------------------

class MomentSplit(NamedTuple):
    """How one parameter's moments split over the data axes.  ``owner``
    set: the stacked tree's layer axis splits, so this layer's tensor is
    held whole by data rank ``owner`` only; else ``dim`` None: whole on
    every rank, or the tensor's ``dim`` splits into equal blocks, data
    rank r holding block r."""
    dim: int | None
    owner: int | None


@dataclasses.dataclass(frozen=True)
class Zero1Layout:
    """Where the moments of the port's parameters (``layers.<i>.…``
    names) live on the data ranks of ``mesh``: ``splits`` by name, ``dp``
    the data extent, ``index`` this rank's data index."""

    splits: dict
    dp: int
    index: int
    mesh: object

    def part(self, name: str, t: torch.Tensor, index: int | None = None):
        """Data rank ``index``'s (default: this rank's) part of ``t``, a
        tensor of the parameter's shape: a view, or None where that rank
        holds none of it."""
        index = self.index if index is None else index
        sp = self.splits[name]
        if sp.owner is not None:
            return t if sp.owner == index else None
        if sp.dim is None:
            return t
        n = t.shape[sp.dim] // self.dp
        return t.narrow(sp.dim, index * n, n)

    def held(self, index: int | None = None) -> list[str]:
        """The split parameters data rank ``index`` holds a part of, in
        the parameters' order (the parameters whole on every rank are
        left out)."""
        index = self.index if index is None else index
        return [k for k, sp in self.splits.items()
                if (sp.owner == index) or (sp.owner is None
                                           and sp.dim is not None)]

    def gather(self, local: dict, dest: dict) -> None:
        """Write every data rank's parts into ``dest`` (whole tensors by
        name), this rank's from ``local`` (its parts by name, of one
        dtype): each rank's parts go flat through ONE all_gather of the
        data group (as bytes), then into their places.  Every rank holds
        1/dp of every split tensor, so the flat buffers are equal."""
        from repro_torch.models.sharding import all_gather_flat, data_group

        names = [self.held(r) for r in range(self.dp)]
        if not names[self.index]:
            return
        mine = torch.cat([local[k].reshape(-1) for k in names[self.index]])
        dtype = mine.dtype
        parts = all_gather_flat(mine.view(torch.uint8),
                                data_group(self.mesh))
        for r, flat in enumerate(parts):
            flat, off = flat.view(dtype), 0
            for k in names[r]:
                view = self.part(k, dest[k], r)
                view.copy_(flat[off:off + view.numel()].view(view.shape))
                off += view.numel()
            if off != flat.numel():
                raise RuntimeError(f"data rank {r}'s parts hold {off} of "
                                   f"{flat.numel()} gathered elements")


def zero1_layout(named: dict, mesh, index: int | None = None,
                 shards: TrainLayout | None = None) -> Zero1Layout | None:
    """The ZeRO-1 layout of the parameters ``named`` (tensors, or meta
    tensors, keyed by the port's names) on ``mesh``: the JAX package's
    ``moment_specs(param_specs(cfg, shapes, mesh), shapes, mesh)`` on the
    stacked tree, mapped onto each layer's tensor.  A split on a stacked
    layer axis gives data rank r layers [r L/dp, (r+1) L/dp) whole; a
    split on another axis slices each layer's tensor on that axis; an
    unsplit leaf stays whole on every rank.  None where the data extent
    is 1.  ``index`` is the data rank the layout is for (default: this
    rank of the ``DeviceMesh``; an ``AbstractMesh`` needs one).

    With ``shards`` (the model's training layout) ``named`` holds the
    rank's slices: the specs come from the whole shapes under
    ``param_specs(..., shards.fsdp)``, a moment slices the rank's
    parameter slice (the free dims it splits are whole there), and an
    FSDP leaf's moment is its parameter's slice, unsplit further."""
    from repro_torch.models.sharding import dp_index

    dp, _ = mesh_axes(mesh)
    dp_ext = _extent(mesh, dp)
    if dp_ext == 1:
        return None
    whole = ({k: shards.splits[k].shape for k in named} if shards is not None
             else {k: tuple(t.shape) for k, t in named.items()})
    shapes = _meta_tree(whole)
    # the rules read the names and shapes only, not the config
    p_specs = param_specs(None, shapes, mesh,
                          fsdp=None if shards is None else shards.fsdp)
    specs = moment_specs(p_specs, shapes, mesh)
    dp_entry = dp if len(dp) > 1 else dp[0]
    splits = {}
    for name in named:
        entries, leaf, layer = _named_entry(name, specs, shapes)
        j = entries.index(dp_entry) if dp_entry in entries else None
        if j is None or (shards is not None
                         and shards.splits[name].data is not None):
            splits[name] = MomentSplit(None, None)
        elif layer is None:
            splits[name] = MomentSplit(j, None)
        elif j == 0:
            splits[name] = MomentSplit(None, layer // (leaf.shape[0] // dp_ext))
        else:
            splits[name] = MomentSplit(j - 1, None)
    return Zero1Layout(splits, dp_ext,
                       dp_index(mesh) if index is None else index, mesh)
