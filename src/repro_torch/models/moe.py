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

Shared experts (DeepSeek-style) run densely on every token.

Routing, ranking and the capacity are local to a dispatch group: one
without a mesh; under a mesh (``models.sharding``) one per data-parallel
block of rows.  There the rank at (data i, model j) routes group i's
tokens, runs only its ``E / tp`` experts (expert stacks sliced on the
expert dim, shared experts on the hidden dim) and adds its partial
combine to the other model ranks' with ONE all_reduce in the compute
dtype; the load-balancing loss is averaged over the data group
(``_moe_ffn_shard_map``) by ``sharding.mean_over``, whose backward
gives each group's aux the gradient it has in the global loss.  A batch that does not divide by the data
extent is one group held by every rank; experts (or a shared hidden
dim) that do not divide by the model extent take the grouped form, every
rank computing all experts of ``_num_groups`` groups.

The expert-sharded form is autograd-aware: the combine's sum over the
model group passes its gradient unchanged to each rank's part, and the
tokens and the gates enter the rank's experts with a backward sum over
the model group (each rank's combine sees only its own experts' pairs);
the router and aux run alike on every model rank, unsummed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding
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


def _aux_loss(probs, expert_ids, e: int):
    """Switch-style load balancing: e * sum(mean prob * routed share)."""
    t, k = expert_ids.shape
    me = probs.mean(dim=0)
    ce = torch.zeros(e, device=probs.device).index_add_(
        0, expert_ids.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=probs.device))
    return e * torch.sum(me * ce)


def _sorted_pairs(expert_ids):
    """The (token, expert) pairs sorted by expert (stable): (token of
    each pair, order, sorted expert ids, rank of each sorted pair within
    its expert)."""
    t, k = expert_ids.shape
    dev = expert_ids.device
    flat_expert = expert_ids.reshape(-1)  # (t*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    idx = torch.arange(t * k, device=dev)
    is_start = torch.ones(t * k, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_expert[1:] != sorted_expert[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return flat_token, order, sorted_expert, idx - seg_start


def _gather_slots(tokens, slot, flat_token, order, slots: int):
    """The (slots + 1, d) buffer with each pair's token at its slot (the
    last row takes the dropped pairs), cut to (slots, d)."""
    buf = torch.zeros((slots + 1, tokens.shape[1]), dtype=tokens.dtype,
                      device=tokens.device)
    buf[slot] = tokens[flat_token[order]]
    return buf[:slots]


def dispatch(tokens, logits, cfg: ArchConfig, cap: int):
    """Sort-based dispatch of tokens (t, d) by router logits (t, e):
    the (e, cap, d) expert buffer, the pairs' (keep, slot, token, order,
    gate, expert id) and the Switch-style load-balancing loss."""
    e, k = cfg.num_experts, cfg.moe_top_k
    d = tokens.shape[1]
    probs, gates, expert_ids = route(logits, k)
    aux = _aux_loss(probs, expert_ids, e)
    flat_token, order, sorted_expert, rank = _sorted_pairs(expert_ids)
    keep = rank < cap
    slot = torch.where(keep, sorted_expert * cap + rank, e * cap)
    buf = _gather_slots(tokens, slot, flat_token, order, e * cap)
    info = (keep, slot, flat_token, order, gates.reshape(-1), expert_ids)
    return buf.reshape(e, cap, d), info, aux


def combine(out_buf, info, t: int, cap: int, cfg: ArchConfig):
    """(t, d): each token's kept pair outputs times their gates, added in
    the buffer's dtype in ascending expert order, the order of the JAX
    package's scatter-add over the sorted pairs.  ``out_buf`` holds
    ``out_buf.shape[0]`` experts (all, or a rank's under a mesh, whose
    pairs ``keep`` then marks)."""
    e, k = out_buf.shape[0], cfg.moe_top_k
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


def _expert_swiglu(p, buf):
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


def _shared(sp: Params, tokens, hidden: slice | None = None):
    """The shared experts' SwiGLU of tokens (t, d); ``hidden`` a slice of
    their hidden dim (a partial sum) where the weights are whole."""
    dt = tokens.dtype
    wg, wu, wd = sp["w_gate"], sp["w_up"], sp["w_down"]
    if hidden is not None:
        wg, wu, wd = wg[:, hidden], wu[:, hidden], wd[hidden]
    h = F.silu(tokens @ wg.to(dt)) * (tokens @ wu.to(dt))
    return h @ wd.to(dt)


def _moe_groups(p: Params, cfg: ArchConfig, x, groups: int):
    """The grouped form: x's rows in ``groups`` dispatch groups, every
    expert here; aux is the groups' mean."""
    b, s, d = x.shape
    t = b * s
    tg = t // groups
    cap = capacity(tg, cfg)
    tokens = x.reshape(t, d)
    # routing in f32 for a stable softmax
    logits = tokens.float() @ p["router"].float()
    outs, auxs, dropped, ids = [], [], [], []
    for g in range(groups):
        rows = slice(g * tg, (g + 1) * tg)
        buf, info, aux = dispatch(tokens[rows], logits[rows], cfg, cap)
        outs.append(combine(_expert_swiglu(p, buf), info, tg, cap, cfg))
        auxs.append(aux)
        dropped.append(torch.sum(~info[0]))
        ids.append(info[-1])
    out = outs[0] if groups == 1 else torch.cat(outs)
    if cfg.num_shared_experts:
        out = out + _shared(p["shared"], tokens)
    aux = auxs[0] if groups == 1 else torch.stack(auxs).mean()
    stats = MoEStats(aux=aux, dropped=sum(dropped),
                     expert_ids=ids[0] if groups == 1 else torch.cat(ids))
    return out.reshape(b, s, d), stats


def _num_groups(batch: int, mesh) -> int:
    """Dispatch groups of the grouped form: the data-parallel extent,
    halved until it divides the batch (1 without a mesh)."""
    if mesh is None:
        return 1
    sizes = sharding.mesh_shape(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    while dp > 1 and batch % dp != 0:
        dp //= 2
    return max(dp, 1)


def expert_sharded(cfg: ArchConfig, tp_ext: int) -> bool:
    """Whether the experts (and the shared experts' hidden dim) divide by
    the model extent: the expert-sharded form, else the grouped one."""
    return cfg.num_experts % max(tp_ext, 1) == 0 and (
        not cfg.num_shared_experts
        or (cfg.moe_d_ff * cfg.num_shared_experts) % tp_ext == 0)


def _local_experts(w, e: int, lo: int, n: int):
    """Experts [lo, lo + n) of an expert stack: a slice of the whole
    stack, or the stack itself once sharded (``model.shard_model``)."""
    if w.shape[0] == e:
        return w[lo:lo + n]
    if w.shape[0] != n:
        raise ValueError(f"an expert stack of {w.shape[0]} experts, "
                         f"neither {e} nor this rank's {n}")
    return w


def _moe_ffn_shard_map(p: Params, cfg: ArchConfig, x, mesh, split: bool):
    """The expert-sharded form on this rank's rows x (b, s, d): its
    group's routing, its experts' outputs and partial combine, then one
    all_reduce (SUM) over the model group in the compute dtype; aux
    averaged over the data group where the rows are split (autograd
    sees the mean)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    tp = sharding.tp_axis(mesh)
    tp_ext = sharding.extent(mesh, tp)
    e_loc = e // tp_ext
    t = b * s  # the group's tokens, tg = (b / dp) * s of the global batch
    cap = capacity(t, cfg)
    tokens = x.reshape(t, d)
    logits = tokens.float() @ p["router"].float()
    probs, gates, expert_ids = route(logits, k)
    # the routing and aux run alike on every model rank; the tokens and
    # the gates enter the rank's experts, whose gradients are its parts
    mine_tokens = sharding.model_enter(tokens, mesh)
    gates = sharding.model_enter(gates, mesh)
    aux = _aux_loss(probs, expert_ids, e)
    dp_ext = sharding.extent(mesh, sharding.dp_axes(mesh))
    if split and dp_ext > 1:
        aux = sharding.mean_over(aux, sharding.data_group(mesh))
    flat_token, order, sorted_expert, rank = _sorted_pairs(expert_ids)
    keep = rank < cap

    j = sharding.tp_index(mesh)
    e_lo = j * e_loc
    mine = keep & (sorted_expert >= e_lo) & (sorted_expert < e_lo + e_loc)
    local_slot = torch.where(mine, (sorted_expert - e_lo) * cap + rank,
                             e_loc * cap)
    buf = _gather_slots(mine_tokens, local_slot, flat_token, order,
                        e_loc * cap)
    local = {name: _local_experts(p[name], e, e_lo, e_loc)
             for name in ("w_gate", "w_up", "w_down")}
    out_buf = _expert_swiglu(local, buf.reshape(e_loc, cap, d))
    info = (mine, local_slot, flat_token, order, gates.reshape(-1), expert_ids)
    partial = combine(out_buf, info, t, cap, cfg)
    if cfg.num_shared_experts:
        sp = p["shared"]
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        f_loc = fs // tp_ext
        whole = sp.w_gate.shape[1] == fs  # the held shape: nothing gathered
        partial = partial + _shared(
            sp, mine_tokens,
            slice(j * f_loc, (j + 1) * f_loc) if whole else None)
    # every rank sums, also one that holds no routed pair; the backward
    # passes the combined gradient to each rank's part unchanged
    partial = sharding.model_sum(partial, mesh)
    stats = MoEStats(aux=aux, dropped=torch.sum(~keep), expert_ids=expert_ids)
    return partial.reshape(b, s, d), stats


def _moe_mesh(p: Params, cfg: ArchConfig, x, mesh, split: bool):
    """The MoE of this rank's rows x under ``mesh``; ``split``: whether x
    is the rank's block of the data axes (else the whole batch)."""
    tp_ext = sharding.extent(mesh, sharding.tp_axis(mesh))
    if expert_sharded(cfg, tp_ext):
        return _moe_ffn_shard_map(p, cfg, x, mesh, split)
    # the grouped form, computed whole on every rank: with split rows the
    # rank's rows are one of the dp groups
    dp_ext = sharding.extent(mesh, sharding.dp_axes(mesh))
    out, stats = _moe_groups(p, cfg, x,
                             1 if split else _num_groups(x.shape[0], mesh))
    if split and dp_ext > 1:
        stats = stats._replace(aux=sharding.mean_over(
            stats.aux, sharding.data_group(mesh)))
    return out, stats


def moe_ffn(p: Params, cfg: ArchConfig, x):
    """x (b, s, d) -> (out (b, s, d), MoEStats): the JAX package's
    (out, aux) with aux as ``stats.aux``.

    Under a mesh (``sharding.set_mesh``) it takes the global batch and
    returns the global output; inside a sharded model call x holds the
    rank's rows.  The stats are the rank's group's, with aux averaged
    over the groups."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _moe_groups(p, cfg, x, 1)
    split = sharding.rows_split()
    if split is not None:
        return _moe_mesh(p, cfg, x, mesh, split)
    # a batch that does not divide by the data extent drops dp: one group
    split = sharding.batch_split(mesh, x.shape[0])
    x_loc = sharding.own_rows(mesh, x) if split else x
    out, stats = _moe_mesh(p, cfg, x_loc, mesh, split)
    return (sharding.gather_rows(mesh, out) if split else out), stats
