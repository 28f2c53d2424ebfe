"""Fault-tolerant checkpointing, in the JAX package's layout on disk.

Guarantees:
  * ATOMIC: the payload is written to a temporary directory and
    ``os.rename``d into place: a crash mid-save never corrupts the latest
    checkpoint.
  * VERIFIED: every array file carries a sha256 in the manifest; restore
    checks it before handing the tree back.
  * RESUMABLE: restore returns the step and the caller's ``extra``, so a
    preempted job replays nothing and skips nothing (the pipelines are
    keyed by (seed, step), see data/pipeline.py).
  * GC: the ``keep_last`` newest checkpoints are kept; older ones are
    deleted only after a newer one is in place.

Layout: ``<dir>/step_{step:09d}/{manifest.json, arr_00000.npy, ...}``.
The manifest holds ``step``, ``treedef`` (a text description of the
tree; restore does not read it), ``extra`` and, per array, its file,
sha256, shape and dtype name.  A tree is nested dicts, tuples, lists and
NamedTuples of tensors; its leaves are numbered in ``jax.tree.flatten``'s
order (dict keys sorted, sequences and NamedTuple fields in order, None
no leaf), so a directory written by either package restores in the
other.  numpy has no bfloat16 or float8: such a leaf is saved as its
bits (a uint16 or uint8 view) under its own dtype name.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

# dtype -> (manifest name, the unsigned integer dtype saved in its place)
_EXOTIC = {torch.bfloat16: ("bfloat16", torch.uint16),
           torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8)}
_EXOTIC_BY_NAME = {name: dtype for dtype, (name, _) in _EXOTIC.items()}
_CHUNK = 1 << 24


class _Leaf:
    def __repr__(self) -> str:
        return "*"


def map_leaves(fn, tree):
    """``tree`` with each tensor leaf replaced by ``fn(leaf)``, the leaves
    visited in ``jax.tree.flatten``'s order."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        out = {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, c) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, c) for c in tree)
    raise TypeError(f"checkpoint trees hold tensors, not {type(tree).__name__}")


def leaves(tree) -> list:
    out = []
    map_leaves(out.append, tree)
    return out


class _HashingWriter:
    """A write-only file that hashes what passes through it (numpy then
    writes the array in chunks instead of one ``tofile``)."""

    def __init__(self, f):
        self.f, self.sha = f, hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self.f.write(data)


def _file_sha256(path: str) -> str:
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            sha.update(chunk)
    return sha.hexdigest()


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype in _EXOTIC:
        name, bits = _EXOTIC[t.dtype]
        return t.view(bits).numpy(), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(_EXOTIC_BY_NAME[name]) if name in _EXOTIC_BY_NAME else t


def _step_dirs(ckpt_dir: str) -> list[str]:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save(ckpt_dir: str, step: int, tree, keep_last: int = 3,
         extra: dict | None = None) -> str:
    """Atomically persist ``tree`` at ``step``; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": int(step),
        "treedef": f"PyTreeDef({map_leaves(lambda _: _Leaf(), tree)!r})",
        "extra": extra or {},
        "arrays": [],
    }
    for i, leaf in enumerate(leaves(tree)):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            out = _HashingWriter(f)
            np.save(out, arr)
        manifest["arrays"].append({
            "file": fname, "sha256": out.sha.hexdigest(),
            "shape": list(arr.shape), "dtype": dtype_name,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    for d in _step_dirs(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_dirs(ckpt_dir)
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``: each leaf takes the
    dtype and device of its counterpart there.  Returns (tree, extra).

    Raises ``IOError`` on a hash mismatch (a corrupt checkpoint) and
    ``ValueError`` on a count or shape mismatch; the caller's fallback
    then tries the previous step directory.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = leaves(tree_like)
    if len(manifest["arrays"]) != len(like):
        raise ValueError(
            f"checkpoint has {len(manifest['arrays'])} arrays, expected "
            f"{len(like)}")
    loaded = []
    for i, (meta, want) in enumerate(zip(manifest["arrays"], like)):
        fpath = os.path.join(path, meta["file"])
        if _file_sha256(fpath) != meta["sha256"]:
            raise IOError(f"integrity failure in {fpath}")
        arr = np.load(fpath)
        if list(arr.shape) != list(want.shape):
            raise ValueError(f"array {i}: shape {arr.shape} != expected "
                             f"{tuple(want.shape)}")
        loaded.append(_from_numpy(arr, meta["dtype"]).to(
            device=want.device, dtype=want.dtype))
    it = iter(loaded)
    return map_leaves(lambda _: next(it), tree_like), manifest["extra"]


def restore_with_fallback(ckpt_dir: str, tree_like):
    """Try the newest, then older checkpoints until one validates (a node
    dying mid-save, or bit rot on one copy).  Returns (tree, extra,
    step)."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(ckpt_dir)
    steps = sorted((int(d.split("_")[1]) for d in _step_dirs(ckpt_dir)),
                   reverse=True)
    last_err: Exception | None = None
    for s in steps:
        try:
            tree, extra = restore(ckpt_dir, tree_like, step=s)
            return tree, extra, s
        except (IOError, ValueError) as e:  # corrupt: try an older one
            last_err = e
    raise IOError(f"no valid checkpoint in {ckpt_dir}: {last_err}")
