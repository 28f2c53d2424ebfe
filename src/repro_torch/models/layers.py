"""Shared model layers: norms, rotary embeddings, the MLP, embedding.

A node of the JAX package's parameter tree is a ``Params`` module here:
``p["w_up"]`` reads a leaf as ``params["w_up"]`` does there, and the
state-dict names follow the tree's paths.  Compute dtype is bf16 with
f32 accumulations and f32 norm statistics; parameters are stored f32
and cast at use.  ``COMPUTE_DTYPE`` is read when ``embed`` runs, and
every later op follows ``x.dtype``, so patching it to ``torch.float32``
runs a whole model in f32.

In the training layout a node holds its leaves' slices (``splits``) and
``p[name]`` gathers what its layer needs (``sharding.read_param``); a
node whose layer computes on its "model" slices (``sliced``: the MLP's
hidden dim, the embedding's vocabulary) closes that layer with a sum
over the model group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding

COMPUTE_DTYPE = torch.bfloat16


class Params(nn.Module):
    """One node of the parameter tree: tensors become parameters, modules
    sub-nodes; ``p[name]`` and ``name in p`` read either.

    The training form of ``model.shard_model`` sets ``splits`` (leaf name
    -> ``sharding.ParamSplit``) and ``mesh`` on a node whose leaves it
    slices, and ``sliced`` where the node's layer computes on its "model"
    slices; ``p[name]`` then reads a leaf through
    ``sharding.read_param``."""

    splits: dict = {}
    mesh = None
    sliced = False

    def __init__(self, **children):
        super().__init__()
        for name, value in children.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        value = getattr(self, name)
        split = self.splits.get(name)
        if split is None:
            return value
        return sharding.read_param(value, split, self.mesh)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class MetaGenerator:
    """Stands in for a ``torch.Generator`` when a model is built on the
    meta device: its parameters get shapes and dtypes, and nothing is
    drawn or allocated."""

    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """N(0, 1) draws from ``gen`` on its device (a ``MetaGenerator``:
    an empty meta tensor)."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """Normal draws scaled by 1/sqrt(fan_in), on the generator's device."""
    fan_in = shape[in_axis]
    return randn(gen, shape) / math.sqrt(max(fan_in, 1))


# --- RMSNorm ----------------------------------------------------------------

def init_rmsnorm(d: int, device) -> Params:
    return Params(scale=torch.ones(d, device=device))


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5,
            mean=None) -> torch.Tensor:
    """f32 statistics and scale, cast back to x's dtype after the scale.
    ``mean`` maps the f32 squares to their mean over the normalised
    channels (keepdim); by default those of the last dim."""
    xf = x.float()
    sq = xf * xf
    var = (torch.mean(sq, dim=-1, keepdim=True) if mean is None
           else mean(sq))
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# --- Rotary position embeddings ---------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The two
    halves of head_dim rotate together (split, not interleaved)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- MLP: SwiGLU or GELU ------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init(gen, (d_model, d_ff)),
         "w_down": dense_init(gen, (d_ff, d_model))}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff))
    return Params(**p)


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when 'w_gate' is present, the classic GELU MLP (tanh
    approximation, as jax.nn.gelu's default) otherwise.  A ``sliced``
    node holds the rank's columns of w_gate / w_up and rows of w_down:
    its partial output is summed over the model group."""
    dt = x.dtype
    if p.sliced:
        x = sharding.model_enter(x, p.mesh)
    u = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(dt)) * u
    else:
        h = F.gelu(u, approximate="tanh")
    out = h @ p["w_down"].to(dt)
    return sharding.model_sum(out, p.mesh) if p.sliced else out


# --- Embedding --------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> Params:
    return Params(table=randn(gen, (vocab, d_model)) * 0.01)


def vocab_range(p: Params) -> tuple[int, int]:
    """[lo, lo + n) of the vocabulary a ``sliced`` table node holds: the
    rank's block over "model"."""
    n = p.table.shape[0]
    return sharding.tp_index(p.mesh) * n, n


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # rows gathered, then cast: the same values as casting the table first
    table = p["table"]
    if not p.sliced:
        return table[tokens.long()].to(COMPUTE_DTYPE)
    # the rank's block of the vocabulary: its tokens' rows, zeros for the
    # others, summed over the model group (one nonzero term each: exact)
    lo, n = vocab_range(p)
    local = tokens.long() - lo
    held = (local >= 0) & (local < n)
    rows = torch.where(held[..., None], table[local.clamp(0, n - 1)], 0.0)
    return sharding.model_sum(rows, p.mesh).to(COMPUTE_DTYPE)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in x's dtype."""
    return x @ p["table"].to(x.dtype).T
