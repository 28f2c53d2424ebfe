"""Meshes, edge groups and rank worlds of the port's sharded paths.

The JAX package is single-controller: ``shard_map`` runs every shard of
a mesh inside one process.  ``torch.distributed`` is multi-process, so
here ONE RANK IS ONE SHARD.  Every sharded entry point keeps the JAX
package's signature: it takes the same GLOBAL arrays on every rank, each
rank keeps its contiguous slice ``[s E/S, (s+1) E/S)`` of the edge
buffer (the split a ``P(edge_axes)`` sharding makes) and returns the
replicated result.

* The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with
  the JAX axis names (``"data"``, ``"pod"``, ``"model"``), built by
  :func:`make_mesh` or :func:`default_edge_mesh` over an initialized
  world.
* A ``psum`` over the edge axes is ``dist.all_reduce(SUM)`` over
  :func:`edge_group`: the ranks that differ only along those axes.  A
  ``pmean`` is that sum over S (:func:`num_edge_shards`).
* A rank's shard index, :func:`shard_index`, is its coordinate along the
  edge axes read row-major, as the JAX package's tick programs compute
  ``sidx``.
* Panel (model-axis) sharding splits the (n, k) panel's ROWS over the
  ``"model"`` axes instead: :func:`num_model_shards` and
  :func:`model_shard_index` read them, and its collectives reduce in
  ``edge_group(mesh, model_axes)`` (the ranks that differ only along
  those axes).

:func:`run_ranks` spawns a world on this host, runs one function in
every rank and hands each rank's result and kernel launch counts back to
the caller: the tests run S = 2 and 4 CPU ranks over ``gloo``, and
``chip_smoke.py`` four ranks on one card (NCCL refuses two ranks on one
GPU, so several ranks on one card use ``gloo`` on CUDA tensors).
"""
from __future__ import annotations

import math
import multiprocessing
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
import weakref
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

# edge groups of meshes whose edge axes span several mesh dimensions,
# created once per (mesh, axes): creating a group is collective
_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, dict]" = weakref.WeakKeyDictionary()


def make_mesh(axis_shapes, axis_names, device=None, ranks=None) -> DeviceMesh:
    """A mesh of the world's ranks in row-major order, with named axes
    (``repro.compat.make_mesh``'s counterpart); ``device`` (``None`` =
    the card) names the mesh's device type.  The world must be
    initialized and hold ``prod(axis_shapes)`` ranks, or the
    ``prod(axis_shapes)`` ``ranks`` given (a subset of the world, laid
    out in their order)."""
    if ranks is None:
        ranks = range(math.prod(axis_shapes))
    layout = torch.tensor(list(ranks), dtype=torch.int64).reshape(tuple(axis_shapes))
    return DeviceMesh(resolve_device(device).type, layout,
                      mesh_dim_names=tuple(axis_names))


def default_edge_mesh(axis_names=("data", "model"), device=None) -> DeviceMesh:
    """The ("data", "model") edge-sharding mesh over every rank of the
    world: shape (world size, 1), edges sharded over "data"."""
    return make_mesh((dist.get_world_size(), 1), axis_names, device)


def num_edge_shards(mesh: DeviceMesh, edge_axes=("data",)) -> int:
    """Product of the mesh's edge-axis sizes: the shard count every edge
    buffer (and per-shard layout) must divide into."""
    names = mesh.mesh_dim_names
    missing = [a for a in edge_axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {missing} not in mesh axes {names}")
    return math.prod(mesh.size(names.index(a)) for a in edge_axes)


def shard_index(mesh: DeviceMesh, edge_axes=("data",)) -> int:
    """This rank's shard along the edge axes, row-major in the order
    ``edge_axes`` lists them."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    sidx = 0
    for a in edge_axes:
        d = names.index(a)
        sidx = sidx * mesh.size(d) + coord[d]
    return sidx


def num_model_shards(mesh: DeviceMesh, model_axes=("model",)) -> int:
    """Product of the mesh's panel-sharding (model) axis sizes: the number
    of row ranges the (n, k) panel splits into."""
    return num_edge_shards(mesh, model_axes)


def model_shard_index(mesh: DeviceMesh, model_axes=("model",)) -> int:
    """This rank's panel shard along the model axes: it owns rows
    ``[s R, (s + 1) R)``.  A psum over the model axes reduces in
    ``edge_group(mesh, model_axes)``."""
    return shard_index(mesh, model_axes)


def edge_group(mesh: DeviceMesh, edge_axes=("data",)):
    """The process group of the ranks that differ from this one only
    along ``edge_axes``: the group a psum over those axes reduces in.
    Every rank of the mesh must make the first call for a set of several
    axes (it creates the groups)."""
    edge_axes = tuple(edge_axes)
    if len(edge_axes) == 1:
        return mesh.get_group(edge_axes[0])
    groups = _GROUPS.setdefault(mesh, {})
    if edge_axes not in groups:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in edge_axes]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, num_edge_shards(mesh, edge_axes))
        groups[edge_axes], _ = dist.new_subgroups_by_enumeration(
            ranks.tolist())
    return groups[edge_axes]


def shard_bounds(total: int, mesh: DeviceMesh, edge_axes=("data",)
                 ) -> tuple[int, int]:
    """[start, stop) of this rank's contiguous slice of a buffer of
    ``total`` slots; ``total`` must divide by the shard count."""
    num_shards = num_edge_shards(mesh, edge_axes)
    if total % num_shards:
        raise ValueError(
            f"edge buffer ({total}) does not divide into {num_shards} shards;"
            " pad with distributed.pad_edges_for_mesh first")
    per = total // num_shards
    s = shard_index(mesh, edge_axes)
    return s * per, (s + 1) * per


class RankResult(NamedTuple):
    """What one rank of :func:`run_ranks` returned: ``fn``'s value (its
    tensors as numpy arrays) and the kernel launches made while ``fn``
    ran (``kernels.launch_counts()``)."""

    value: Any
    launches: dict


def _to_host(x):
    """Tensors in nested tuples, lists and dicts -> numpy arrays: results
    cross the process boundary by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank: int, world: int, init: str, backend: str, device: str,
               timeout: float, call: str, out) -> None:
    from repro_torch import kernels

    try:
        with open(call, "rb") as f:  # written by run_ranks
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        try:
            kernels.reset_launch_counts()
            value = _to_host(fn(dev, *args))
            launches = kernels.launch_counts()
        finally:
            dist.destroy_process_group()
        out.put((rank, RankResult(value, launches), None))
    except BaseException:  # the parent raises the traceback
        out.put((rank, None, traceback.format_exc()))
        raise


def run_ranks(world: int, fn: Callable, *args, backend: str = "gloo",
              device=None, timeout: float = 600.0) -> list[RankResult]:
    """Run ``fn(device, *args)`` in ``world`` spawned ranks on this host
    and return their :class:`RankResult` s in rank order.

    The ranks join one process group (``backend``, a ``file://`` init
    method in a temporary directory, so concurrent worlds never race for
    a port) and run on ``device`` (``None`` = the card; rank r takes card
    r % device count).  ``fn`` must be importable by module path and
    ``args`` picklable: the ranks start from a fresh interpreter with
    this process's ``sys.path``.  A rank that raises or dies fails the
    call: the others are terminated and the rank's traceback raised.
    ``timeout`` (seconds) bounds each collective and the whole world.
    """
    dev = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results: dict[int, RankResult] = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "init").as_uri()
        # the call goes through a file, not each rank's start-up pipe: a
        # pipe blocks the parent until the rank has read it, which a rank
        # does while it imports, so large arguments would start the ranks
        # one after another
        call = Path(tmp) / "call.pkl"
        with open(call, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, str(dev), timeout,
                                   str(call), out))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(results) < world:
                try:
                    rank, res, err = out.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in results]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} of {world} exited without a result "
                            f"(exit codes {[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world} ranks ran past {timeout} s")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
                results[rank] = res
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
    return [results[r] for r in range(world)]


def sum_launches(counts) -> dict[str, int]:
    """Kernel launch counts of several ranks (``RankResult.launches`` or
    a rank's own main-path counts), added per kernel."""
    total: dict[str, int] = {}
    for c in counts:
        for name, x in c.items():
            total[name] = total.get(name, 0) + x
    return total


def bitwise_equal(values) -> bool:
    """Whether every rank's array is bitwise the first rank's."""
    first = np.asarray(values[0])
    return all(np.array_equal(np.asarray(v), first) for v in values[1:])
