"""Mesh-aware sharding helpers of the LM path.

Model code names LOGICAL axes ("dp" the batch axes, "tp" the tensor and
expert axis, "sp" the cache's sequence axis under context-parallel
decode); :func:`resolve_spec` maps them onto whatever mesh is in context
(none: no axis; the 16 x 16 pod: "data" / "model"; the 2 x 16 x 16
multi-pod: ("pod", "data") / "model").  A spec is a tuple with one entry
per dim, each an axis name, a tuple of names or None: a
``PartitionSpec``'s entries.

:func:`set_mesh` puts a mesh in context and :func:`current_mesh` reads it.
The mesh is a ``torch.distributed`` ``DeviceMesh`` (ranks that run the
sharded serving path: one rank is one shard) or a
``launch.mesh.AbstractMesh`` (the production meshes, which only the
partition rules read); :func:`mesh_shape` reads the axis sizes of either.

Inside a sharded ``Model`` call the activations hold this rank's batch
rows: the model enters :func:`model_rows`, and :func:`rows_split` tells
the blocks whether those rows are the rank's block of the data axes or
the whole batch (a batch that does not divide by the data extent).  A
function called outside a model (an entry point) takes the global batch.

A collective that a training forward pass reaches is autograd-aware
(:func:`mean_over`): its backward reduces the upstream gradients over
the same group, as the JAX package's ``psum`` transposes.  The data
parallel step averages its gradients with :func:`mean_buckets`.

In the training and serving layouts (``model.shard_model(...,
train=True)``, the serving layout at ``fsdp=False``) each rank holds its
slice of every parameter (a :class:`ParamSplit` says which) and reads it
through :func:`read_param`: the dim split over the data axes (FSDP) is
all-gathered on use, and so is the dim split over "model" where the
layer computes whole (the gather form).  The two
backwards differ: the data ranks ran different rows, so the gathered
gradient is reduce-scattered with the MEAN over the data group; the
model ranks ran the same rows on the same input, so it is only narrowed
to the rank's slice.  A layer that computes on its "model" slices
(Megatron style) enters that region with :func:`model_enter` (identity
forward, a SUM over the model group backward) and leaves it with
:func:`model_sum` (a SUM forward, identity backward).  A statistic that
every model rank needs whole inside the region (the Mamba2 mixer's norm
over all of d_inner) is :func:`model_psum` (a SUM both ways).  Served,
the head-sliced attention trades heads for cache positions with
:func:`all_to_all`; the Mamba2 mixer trades its [z | x] column blocks
for head-aligned blocks with :func:`exchange` (the inverse exchange
backward).

The JAX package also has ``maybe_shard``, a layout hint to its compiler
with no numeric effect; here each rank already holds only its slice, so
there is nothing to hint.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

# logical -> candidate mesh axis names (those present in the mesh win)
LOGICAL = {
    "dp": ("pod", "data"),  # batch-parallel axes
    "tp": ("model",),  # tensor / expert-parallel axis
    "sp": ("model",),  # cache sequence axis under context-parallel decode
}

_MESHES: list = []
_ROWS: list = []
# collectives of the sharded LM path: calls and their host seconds, in all
# and by kind
_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_STATS: dict = {}
# the data-parallel step's gradients go over the data group in flat f32
# buckets of at most this many bytes (a larger tensor is one bucket)
BUCKET_BYTES = 256 * 2 ** 20


@contextlib.contextmanager
def set_mesh(mesh):
    """Put ``mesh`` in context for the block (``None`` is no mesh)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The mesh in context, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    return dict(mesh.shape)


def resolve_spec(*logical_axes) -> tuple:
    """Map logical axis names to a spec for the mesh in context (``()``
    without one)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    present = mesh_shape(mesh)
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        names = tuple(n for n in LOGICAL.get(ax, (ax,)) if n in present)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return tuple(out)


def shardable(dim: int, logical: str) -> bool:
    """True if ``dim`` divides evenly over the mesh extent of the logical
    axis (False without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return False
    present = mesh_shape(mesh)
    ext = 1
    for n in LOGICAL.get(logical, (logical,)):
        if n in present:
            ext *= present[n]
    return ext > 0 and dim % ext == 0


# ---------------------------------------------------------------------------
# The rank's place on a DeviceMesh
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, outermost first."""
    present = mesh_shape(mesh)
    return tuple(a for a in LOGICAL["dp"] if a in present)


def tp_axis(mesh) -> str | None:
    return "model" if "model" in mesh_shape(mesh) else None


def extent(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name, a tuple, or None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in axes)


def batch_split(mesh, batch: int) -> bool:
    """Whether ``batch`` rows split over the data axes: the axes exist and
    the batch divides by their extent (else every rank holds them all)."""
    dp = dp_axes(mesh)
    return bool(dp) and batch % extent(mesh, dp) == 0


def _index(mesh, axes) -> int:
    """This rank's coordinate along ``axes``, row-major."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        d = names.index(a)
        idx = idx * mesh.size(d) + coord[d]
    return idx


def dp_index(mesh) -> int:
    return _index(mesh, dp_axes(mesh))


def tp_index(mesh) -> int:
    ax = tp_axis(mesh)
    return _index(mesh, (ax,)) if ax else 0


def _group(mesh, axes):
    from repro_torch.parallel import edge_group

    return edge_group(mesh, axes)


def tp_extent(mesh) -> int:
    return extent(mesh, tp_axis(mesh))


def data_group(mesh):
    """The ranks that differ from this one only along the data axes."""
    return _group(mesh, dp_axes(mesh))


def model_group(mesh):
    """The ranks that differ from this one only along "model"."""
    return _group(mesh, (tp_axis(mesh),))


def own_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x``'s rows (dim 0) over the data axes."""
    per = x.shape[0] // extent(mesh, dp_axes(mesh))
    i = dp_index(mesh)
    return x[i * per:(i + 1) * per]


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The data group's row blocks of ``x``, concatenated in rank order."""
    n = extent(mesh, dp_axes(mesh))
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x.contiguous(), group=data_group(mesh))
    _count("all_gather", t0)
    return torch.cat(parts, dim=0)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced by ``op`` over ``group`` (a contiguous copy where x
    is not contiguous); a group of one rank returns x."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    _count("all_reduce", t0)
    return x


class _SumOverGroup(torch.autograd.Function):
    """The SUM over a group; the backward sums the upstream gradients
    over the same group (each rank's loss is one term of the total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), dist.ReduceOp.SUM, ctx.group), None


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``, autograd-aware: where every rank
    adds the result into its loss and the data-parallel step then
    averages the gradients, each rank's ``x`` gets the gradient the mean
    has in the global loss.  A group of one rank returns x."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    return _SumOverGroup.apply(x, group) / n


def mean_buckets(tensors: list, mesh) -> None:
    """Average ``tensors`` (f32, the same names and shapes in the same
    order on every rank) over the data group of ``mesh``, in place: they
    are packed in order into flat buckets of at most ``BUCKET_BYTES``,
    each bucket is one all_reduce (SUM), then divided by the data
    extent."""
    group = data_group(mesh)
    n = dist.get_world_size(group)
    if n == 1:
        return
    limit = BUCKET_BYTES // 4
    start = 0
    while start < len(tensors):
        stop, size = start, 0
        while stop < len(tensors) and (stop == start
                                       or size + tensors[stop].numel() <= limit):
            size += tensors[stop].numel()
            stop += 1
        part = tensors[start:stop]
        flat = all_reduce(torch.cat([t.reshape(-1) for t in part]),
                          dist.ReduceOp.SUM, group)
        flat.div_(n)
        off = 0
        for t in part:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        start = stop


def all_gather_flat(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (1-D, the same length on every rank) in rank
    order of ``group``: one all_gather."""
    n = dist.get_world_size(group)
    if n == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x.contiguous(), group=group)
    _count("all_gather", t0)
    return parts


def all_to_all(x: torch.Tensor, group, send: list | None = None,
               recv: list | None = None) -> torch.Tensor:
    """Block r of ``x`` (dim 0, one block a rank of ``group`` in rank
    order) sent to group rank r; returns the blocks received, block r
    from group rank r: one ``all_to_all_single``.  The blocks are equal
    by default; ``send[r]`` / ``recv[r]`` give the rows of dim 0 sent
    to / received from group rank r (0 for none)."""
    x = x.contiguous()
    rows = x.shape[0] if recv is None else sum(recv)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    t0 = time.perf_counter()
    dist.all_to_all_single(out, x, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    _count("all_to_all", t0)
    return out


class _Exchange(torch.autograd.Function):
    """``all_to_all`` with ``send`` / ``recv`` rows; backward, the
    inverse exchange of the gradients (``recv`` rows sent back to each
    rank, ``send`` rows received)."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group, ctx.recv, ctx.send), None, None, None


def exchange(x: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """``all_to_all(x, group, send, recv)``, autograd-aware: each row's
    gradient goes back to the rank that sent it."""
    return _Exchange.apply(x, list(send), list(recv), group)


def _count(kind: str, t0: float) -> None:
    """One collective of ``kind`` that started at ``t0`` (host clock)."""
    sec = time.perf_counter() - t0
    _STATS[kind] += 1
    _STATS["seconds"] += sec
    _STATS[f"{kind}_seconds"] += sec


def collective_stats() -> dict:
    """All_reduce, all_gather, reduce_scatter and all_to_all calls of the
    sharded LM path since the last reset, and their host seconds (each
    call timed on the host clock around the blocking collective): in all
    (``seconds``) and by kind (``<kind>_seconds``)."""
    return dict(_STATS)


def reset_collective_stats() -> None:
    _STATS.update({k: 0 for k in _KINDS}, seconds=0.0,
                  **{f"{k}_seconds": 0.0 for k in _KINDS})


reset_collective_stats()


# ---------------------------------------------------------------------------
# The training layout: parameter slices, gathered on use
# ---------------------------------------------------------------------------

class ParamSplit(NamedTuple):
    """How the training layout holds one parameter: ``shape`` is the
    whole tensor's; ``data`` its dim split over the data axes (FSDP),
    ``model`` its dim split over "model" (None: not split); ``sliced``
    whether its layer computes on the rank's "model" slice (else that
    dim is gathered when the parameter is read)."""
    shape: tuple
    data: int | None
    model: int | None
    sliced: bool

    @property
    def gathers(self) -> bool:
        """Whether a read all-gathers anything."""
        return self.data is not None or (self.model is not None
                                         and not self.sliced)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` joined along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    _count("all_gather", t0)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_mean(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's mean of ``g``: one
    reduce_scatter (SUM) of g with ``dim`` moved first, then / n."""
    n = dist.get_world_size(group)
    if n == 1:
        return g
    whole = g.movedim(dim, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // n,) + tuple(whole.shape[1:]))
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, whole, op=dist.ReduceOp.SUM, group=group)
    _count("reduce_scatter", t0)
    return out.div_(n).movedim(0, dim)


class _GatherParam(torch.autograd.Function):
    """A parameter slice gathered for its layer: the data dim over the
    data group, then, in the gather form, the model dim over the model
    group.  Backward: narrow the model dim to the rank's slice (every
    model rank computed the same gradient), then reduce-scatter the data
    dim with the mean over the data group (each rank's rows are one term
    of the mean)."""

    @staticmethod
    def forward(ctx, t, split: ParamSplit, mesh):
        ctx.split, ctx.mesh = split, mesh
        if split.data is not None:
            t = all_gather_dim(t, split.data, data_group(mesh))
        if split.model is not None and not split.sliced:
            t = all_gather_dim(t, split.model, model_group(mesh))
        return t

    @staticmethod
    def backward(ctx, grad):
        split, mesh = ctx.split, ctx.mesh
        if split.model is not None and not split.sliced:
            n = grad.shape[split.model] // tp_extent(mesh)
            grad = grad.narrow(split.model, tp_index(mesh) * n, n)
        if split.data is not None:
            grad = _reduce_scatter_mean(grad, split.data, data_group(mesh))
        return grad, None, None


def read_param(t: torch.Tensor, split: ParamSplit, mesh) -> torch.Tensor:
    """The parameter slice ``t`` as its layer computes on it (see
    :class:`_GatherParam`); ``t`` itself where nothing is gathered."""
    if not split.gathers:
        return t
    return _GatherParam.apply(t, split, mesh)


@torch.no_grad()
def gather_whole(t: torch.Tensor, split: ParamSplit, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's slice (a
    parameter's, its gradient's or a moment's of the parameter's shape):
    the data dim gathered over the data group, then the model dim over
    the model group.  Every rank of the mesh calls it."""
    if split.data is not None:
        t = all_gather_dim(t, split.data, data_group(mesh))
    if split.model is not None:
        t = all_gather_dim(t, split.model, model_group(mesh))
    return t


class _Enter(torch.autograd.Function):
    """Identity forward; backward, the SUM over ``group``: the input of
    a layer computed on "model" slices, whose gradient each model rank
    holds one part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), dist.ReduceOp.SUM, ctx.group), None


class _Sum(torch.autograd.Function):
    """The SUM over ``group`` forward; identity backward: the partial
    outputs of a layer computed on "model" slices, whose sum every model
    rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` entering a layer that computes on "model" slices (Megatron's
    f): x itself forward, its gradient summed over the model group."""
    group = model_group(mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _Enter.apply(x, group)


def model_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's partial ``x`` summed, where each model rank then
    uses the sum for its own slice of a layer (the Mamba2 mixer's norm
    statistic over its heads): the SUM forward and, since each rank's
    upstream gradient is then one part of the whole, the SUM backward
    too."""
    group = model_group(mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _SumOverGroup.apply(x, group)


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's partial ``x`` summed (Megatron's g); the
    gradient passes unchanged to every rank's part."""
    group = model_group(mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _Sum.apply(x, group)


# ---------------------------------------------------------------------------
# Rows of a sharded model call
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def model_rows(split: bool):
    """Inside the block the activations hold this rank's rows: its block
    of the data axes (``split``) or the whole batch."""
    _ROWS.append(bool(split))
    try:
        yield
    finally:
        _ROWS.pop()


def rows_split() -> bool | None:
    """``model_rows``' ``split`` inside a sharded model call; None
    outside one (the caller passes the global batch)."""
    return _ROWS[-1] if _ROWS else None
