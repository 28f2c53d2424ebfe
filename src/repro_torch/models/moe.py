"""Mixture-of-Experts FFN with sort-based dispatch under a capacity.

No (tokens, experts, capacity) one-hot dispatch tensor:

  1. route: softmax in f32, top-k gates renormalised by their sum
  2. sort the token-expert pairs by expert id (stable) and find each
     pair's rank within its expert from a running max of segment starts
  3. truncate at the capacity: a pair of rank >= cap is dropped (it is
     written to a dump row ``e * cap``, which is then discarded)
  4. gather the tokens into an (experts, capacity, d) buffer
  5. the experts' SwiGLU as batched products over the expert axis
  6. combine: each token adds its kept pair outputs, weighted by their
     gates, in ascending expert order and in the compute dtype, one
     after the other (no atomics, so a run repeats bitwise)

Shared experts (DeepSeek-style) run densely on every token.  The JAX
package routes within dispatch groups, one per data-parallel shard of a
mesh, and one without a mesh; the port has no mesh here, so its tokens
form one group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import Params, dense_init


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """The router (d, e), the expert stacks (e, d, f) and (e, f, d) and,
    with shared experts, their dense SwiGLU of width f * shared.  The
    expert stacks' fan-in is axis 0, the expert count, as in the JAX
    package's draw."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (d, e)),
        "w_gate": dense_init(gen, (e, d, f)),
        "w_up": dense_init(gen, (e, d, f)),
        "w_down": dense_init(gen, (e, f, d)),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = Params(w_gate=dense_init(gen, (d, fs)),
                             w_up=dense_init(gen, (d, fs)),
                             w_down=dense_init(gen, (fs, d)))
    return Params(**p)


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: tokens * top_k * capacity_factor / experts,
    rounded up to a multiple of 8, at least 8."""
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def route(logits, k: int):
    """(probs, gates, expert ids) of f32 router logits (t, e): the top k
    of the softmax, the lower expert id first on ties, the gates divided
    by their sum (clamped at 1e-9)."""
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def dispatch(tokens, logits, cfg: ArchConfig, cap: int):
    """Sort-based dispatch of tokens (t, d) by router logits (t, e):
    the (e, cap, d) expert buffer, the pairs' (keep, slot, token, order,
    gate, expert id) and the Switch-style load-balancing loss."""
    e, k = cfg.num_experts, cfg.moe_top_k
    t, d = tokens.shape
    dev = tokens.device
    probs, gates, expert_ids = route(logits, k)

    me = probs.mean(dim=0)
    flat_expert = expert_ids.reshape(-1)  # (t*k,)
    ce = torch.zeros(e, device=dev).index_add_(
        0, flat_expert, torch.full((t * k,), 1.0 / (t * k), device=dev))
    aux = e * torch.sum(me * ce)

    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    idx = torch.arange(t * k, device=dev)
    is_start = torch.ones(t * k, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_expert[1:] != sorted_expert[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start

    keep = rank < cap
    slot = torch.where(keep, sorted_expert * cap + rank, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=tokens.dtype, device=dev)
    buf[slot] = tokens[flat_token[order]]
    info = (keep, slot, flat_token, order, gates.reshape(-1), expert_ids)
    return buf[:e * cap].reshape(e, cap, d), info, aux


def combine(out_buf, info, t: int, cap: int, cfg: ArchConfig):
    """(t, d): each token's kept pair outputs times their gates, added in
    the buffer's dtype in ascending expert order, the order of the JAX
    package's scatter-add over the sorted pairs."""
    e, k = cfg.num_experts, cfg.moe_top_k
    keep, slot, _, order, flat_gate, _ = info
    dt = out_buf.dtype
    out_flat = out_buf.reshape(e * cap, out_buf.shape[-1])
    pair_out = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, max=e * cap - 1)], 0.0)
    pair_out = pair_out * flat_gate[order][:, None].to(dt)
    # each pair's place in the sorted order; a token's experts are
    # distinct, so its places in ascending order are its experts ascending
    place = torch.empty_like(order)
    place[order] = torch.arange(order.numel(), device=order.device)
    place = torch.sort(place.reshape(t, k), dim=-1).values
    pairs = pair_out[place]  # (t, k, d)
    acc = pairs[:, 0]
    for j in range(1, k):
        acc = acc + pairs[:, j]
    return acc


def _expert_swiglu(p: Params, buf):
    """Every expert's SwiGLU over its (cap, d) slots, in buf's dtype."""
    dt = buf.dtype
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(dt))


class MoEStats(NamedTuple):
    """One MoE call's side results, tensors on the device (reading one
    synchronises)."""
    aux: torch.Tensor  # () f32 load-balancing loss
    dropped: torch.Tensor  # () pairs dropped at the capacity
    expert_ids: torch.Tensor  # (tokens, top_k) routed experts, best first


def moe_ffn(p: Params, cfg: ArchConfig, x):
    """x (b, s, d) -> (out (b, s, d), MoEStats): the JAX package's
    (out, aux) with aux as ``stats.aux``."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    cap = capacity(t, cfg)
    tokens = x.reshape(t, d)
    # routing in f32 for a stable softmax
    logits = tokens.float() @ p["router"].float()
    buf, info, aux = dispatch(tokens, logits, cfg, cap)
    out = combine(_expert_swiglu(p, buf), info, t, cap, cfg)
    if cfg.num_shared_experts:
        sp = p["shared"]
        h = F.silu(tokens @ sp["w_gate"].to(dt)) * (tokens @ sp["w_up"].to(dt))
        out = out + h @ sp["w_down"].to(dt)
    stats = MoEStats(aux=aux, dropped=torch.sum(~info[0]),
                     expert_ids=info[-1])
    return out.reshape(b, s, d), stats
