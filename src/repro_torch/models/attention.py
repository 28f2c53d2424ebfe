"""Attention: GQA (optional QKV bias and qk-norm) and MLA (DeepSeek-V2),
with chunked (flash-style) attention for long prefills and KV-cache
decode.

The chunked attention walks KV chunks with a running (max, sum, acc)
triple, the flash-attention recurrence in plain tensor ops, so a long
prefill never holds an (S, S) score matrix.  The GQA cache is bf16 or
int8, quantized per (position, head) with f32 scales.  MLA caches the
compressed (kv_lora + rope) latents, always bf16, and decodes with
weight absorption: attention runs in the latent space and per-head K/V
is never expanded.  A cache is written in place (index assignment) and
its ``length`` is one Python int shared by the batch.

Under a mesh a GQA cache and an MLA latent cache are context parallel:
each rank holds its batch rows and one slice of the sequence
(``KVCache.shard`` / ``MLACache.shard``, a ``SeqShard``), positions are
written only where they are held, and the decode combines the ranks'
partial softmaxes with three all_reduces over the "model" group
(``_cp_softmax``).  A sequence that does not divide by the "model"
extent is held whole on every rank and decodes by the plain path, as in
the JAX package.

In the training and serving layouts a ``sliced`` attention node holds
the rank's heads (Megatron style): GQA's wq / wk / wv and their biases
by columns, MLA's wq and w_kv_up by columns, wo by rows; the head count
is read from the weights, and the partial output of wo is summed over
the model group.  That is the form where the heads divide by the model
extent; otherwise the node gathers its weights whole on use.  A GQA
cache holds every KV head whatever the layout, so serving a ``sliced``
node exchanges heads for positions: the prefill's K/V by one all_to_all
over the model group into a context-parallel cache (``prefill_cache``),
each decoded token's q, k and v by one all_gather, after which every
rank runs the context-parallel softmax over all heads and keeps its own
(``gqa_decode``), as the JAX package's decode takes q whole over heads.
An MLA latent cache is shared by the heads and its latents come from
weights replicated over "model", so every rank fills its slice from the
prompt it computes whole; a ``sliced`` node gathers each decoded token's
absorbed queries (q_eff, q_rope) of every head by one all_gather and
keeps its heads' share of the combined softmax (``mla_decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding
from repro_torch.models.layers import (Params, apply_rope, dense_init,
                                       init_rmsnorm, rmsnorm)

NEG_INF = -1e30


def _scale(head_dim: int) -> float:
    # 1 / sqrt(head_dim) rounded as the JAX package forms it: sqrt in f32,
    # then the reciprocal in f32
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    if cfg.use_mla:
        r, rd, vd = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.v_head_dim
        return Params(wq=dense_init(gen, (d, h * (hd + rd))),
                      w_kv_down=dense_init(gen, (d, r)),
                      w_k_rope=dense_init(gen, (d, rd)),
                      w_kv_up=dense_init(gen, (r, h * (hd + vd))),
                      wo=dense_init(gen, (h * vd, d)),
                      kv_norm=init_rmsnorm(r, dev))
    p = {
        "wq": dense_init(gen, (d, h * hd)),
        "wk": dense_init(gen, (d, kv * hd)),
        "wv": dense_init(gen, (d, kv * hd)),
        "wo": dense_init(gen, (h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, device=dev)
        p["bk"] = torch.zeros(kv * hd, device=dev)
        p["bv"] = torch.zeros(kv * hd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dev)
        p["k_norm"] = init_rmsnorm(hd, dev)
    return Params(**p)


# --------------------------------------------------------------------------
# Flash-style chunked core:  softmax(Q K^T + mask) V  without (S, S).
# --------------------------------------------------------------------------

def _chunked_attention(q, k, v, *, causal: bool, q_offset: int,
                       chunk: int = 1024):
    """q: (b, sq, h, dh), k/v: (b, sk, h, dh) (kv already broadcast to h).

    Walks KV chunks with the running-max/sum flash recurrence; the last
    chunk is zero-padded and its padding masked.  q_offset: absolute
    position of q[0] (for causal masking vs a cache).
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    dev = q.device
    qf = (q.float() * _scale(dh)).transpose(1, 2)  # b h sq dh
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)

    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    q_pos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, h, sq), NEG_INF, device=dev)
    s = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, dh), device=dev)
    for c0 in range(0, sk + pad, chunk):
        kc = kf[:, :, c0:c0 + chunk]
        vc = vf[:, :, c0:c0 + chunk]
        logits = qf @ kc.transpose(-1, -2)  # b h sq chunk
        k_pos = c0 + torch.arange(chunk, device=dev)
        keep = (k_pos < sk)[None, :]
        if causal:
            keep = keep & (k_pos[None, :] <= q_pos[:, None])
        logits = torch.where(keep, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vc
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # b sq h dh


def _dense_attention(q, k, v, *, causal: bool, q_offset: int):
    """Plain attention with the whole score matrix, for short sequences."""
    sq, sk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * _scale(q.shape[-1]),
                          k.float())
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(sk, device=q.device)[None, :] <= q_pos[:, None]
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _broadcast_kv(k, h: int):
    """(b, s, kv, dh) -> (b, s, h, dh): each KV head serves h // kv
    consecutive query heads."""
    kv = k.shape[2]
    if kv == h:
        return k
    return torch.repeat_interleave(k, h // kv, dim=2)


# --------------------------------------------------------------------------
# KV cache (bf16 or int8-quantized)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A cache that holds positions [start, start + its length) of a
    sequence of ``total``; the ranks of ``group`` (the "model" group)
    hold the rest."""
    start: int
    total: int
    group: Any


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (b, max_s, kv, dh)  cache dtype
    v: torch.Tensor
    k_scale: torch.Tensor | None  # (b, max_s, kv, 1) f32 when int8
    v_scale: torch.Tensor | None
    length: int  # filled positions, shared by the batch
    shard: SeqShard | None = None  # the rank's sequence slice under a mesh


def kv_layout(batch: int, max_seq: int):
    """(rows, positions, SeqShard or None) a rank holds of a KV or MLA
    cache of ``batch`` x ``max_seq`` under the mesh in context: its block of rows
    where the batch divides by the data extent (else every row), and its
    slice of the sequence over "model" where ``max_seq`` divides by the
    model extent (else the whole sequence, decoded by the plain path).
    Without a mesh: (batch, max_seq, None)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return batch, max_seq, None
    if sharding.batch_split(mesh, batch):
        batch //= sharding.extent(mesh, sharding.dp_axes(mesh))
    tp = sharding.tp_axis(mesh)
    tp_ext = sharding.extent(mesh, tp)
    if not tp or max_seq % tp_ext:
        return batch, max_seq, None
    seq = max_seq // tp_ext
    return batch, seq, SeqShard(start=sharding.tp_index(mesh) * seq,
                                total=max_seq, group=sharding.model_group(mesh))


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, kv_heads: int,
                  head_dim: int, device, shard: SeqShard | None = None
                  ) -> KVCache:
    """An empty cache; int8 when ``cfg.kv_cache_dtype == "int8"``, else
    bf16, in any compute dtype.  With ``shard`` it holds ``max_seq``
    positions from ``shard.start``."""
    int8 = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if int8 else torch.bfloat16
    shape = (batch, max_seq, kv_heads, head_dim)

    def scales():
        return (torch.zeros((batch, max_seq, kv_heads, 1), device=device)
                if int8 else None)

    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   k_scale=scales(), v_scale=scales(), length=0, shard=shard)


def _quantize(x):
    """Per-(position, head) symmetric int8: the scale floor comes before
    the division, then x / scale * 127 rounds half to even."""
    scale = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x.float() / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale / 127.0


def _dequantize(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _held_window(shard: SeqShard | None, held: int, pos: int, end: int):
    """(cache slice, new values' slice) of the positions [pos, end) that a
    cache of ``held`` positions holds (from ``shard.start``, or the whole
    sequence without a shard), None where it holds none of them; raises
    ``ValueError`` past the sequence's end."""
    start = shard.start if shard is not None else 0
    total = shard.total if shard is not None else held
    if end > total:
        raise ValueError(f"cache of {total} positions cannot "
                         f"hold positions [{pos}, {end})")
    lo, hi = max(pos, start), min(end, start + held)
    if lo >= hi:
        return None
    return slice(lo - start, hi - start), slice(lo - pos, hi - pos)


def cache_update(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Write k/v at [pos : pos + s_new) in place; the cache's length
    becomes pos + s_new.  A sharded cache writes only the positions it
    holds; every rank advances its length."""
    end = pos + k_new.shape[1]
    window = _held_window(cache.shard, cache.k.shape[1], pos, end)
    if window is not None:
        dst, src = window
        if cache.k.dtype == torch.int8:
            kq, ks = _quantize(k_new[:, src])
            vq, vs = _quantize(v_new[:, src])
            cache.k[:, dst] = kq
            cache.v[:, dst] = vq
            cache.k_scale[:, dst] = ks
            cache.v_scale[:, dst] = vs
        else:
            cache.k[:, dst] = k_new[:, src].to(cache.k.dtype)
            cache.v[:, dst] = v_new[:, src].to(cache.v.dtype)
    cache.length = end
    return cache


def prefill_cache(p: Params, cache: KVCache, k, v) -> KVCache:
    """Write a prompt's k/v (b, s, the KV heads node ``p`` holds, hd)
    into ``cache`` from position 0, in place.  Under a ``sliced`` node
    they hold the rank's KV heads at every position, and a cache holds
    every KV head: a context-parallel cache takes its positions of every
    rank's heads by one all_to_all over the model group (K and V in one
    buffer, padded to the whole sequence), a whole cache every rank's
    heads at every position by one all_gather.  An int8 cache quantises
    after the exchange, from the values it would quantise without a
    mesh."""
    if not p.sliced:
        return cache_update(cache, k, v, 0)
    group = sharding.model_group(p.mesh)
    kv = torch.stack([k, v])  # (2, b, s, kv_loc, hd)
    if cache.shard is None:
        kv = sharding.all_gather_dim(kv, 3, group)
        return cache_update(cache, kv[0], kv[1], 0)
    s, held, total = k.shape[1], cache.k.shape[1], cache.shard.total
    if s > total:
        raise ValueError(f"cache of {total} positions cannot hold "
                         f"positions [0, {s})")
    tp = dist.get_world_size(group)
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, total - s))
    # block r: rank r's positions of this rank's heads
    got = sharding.all_to_all(kv.unflatten(2, (tp, held)).movedim(2, 0),
                              group)
    # block r from rank r: its heads at this rank's positions
    kv = got.movedim(0, 3).flatten(3, 4)  # (2, b, held, kv, hd)
    start = cache.shard.start
    n = max(0, min(s - start, held))
    cache_update(cache, kv[0][:, :n], kv[1][:, :n], start)
    cache.length = s
    return cache


def cache_kv(cache: KVCache, dtype):
    """The whole cache's K and V in ``dtype``."""
    if cache.k.dtype == torch.int8:
        return (_dequantize(cache.k, cache.k_scale, dtype),
                _dequantize(cache.v, cache.v_scale, dtype))
    return cache.k.to(dtype), cache.v.to(dtype)


# --------------------------------------------------------------------------
# GQA forward
# --------------------------------------------------------------------------

def _norm_scale(p: Params, name: str):
    """The qk-norm node ``name``; under a ``sliced`` node its scale, which
    every head shares, enters the head-sliced region."""
    node = p[name]
    if not p.sliced:
        return node
    return {"scale": sharding.model_enter(node["scale"], p.mesh)}


def _project_qkv(p: Params, cfg: ArchConfig, x, positions):
    """(q, k, v) per head of the heads the node holds (all, or the rank's
    under a ``sliced`` node, whose x has entered the region)."""
    dt = x.dtype
    hd = cfg.head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, s, _ = x.shape
    q = q.reshape(b, s, q.shape[-1] // hd, hd)
    k = k.reshape(b, s, k.shape[-1] // hd, hd)
    v = v.reshape(b, s, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = rmsnorm(_norm_scale(p, "q_norm"), q, cfg.rms_eps)
        k = rmsnorm(_norm_scale(p, "k_norm"), k, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(p: Params, cfg: ArchConfig, x, *, causal: bool = True,
              chunk: int = 1024):
    """Full-sequence attention (training / prefill): the whole score
    matrix up to 2048 positions, the chunked recurrence above.  Returns
    (out, (k, v)) with k/v before the KV-head broadcast."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    xe = sharding.model_enter(x, p.mesh) if p.sliced else x
    q, k, v = _project_qkv(p, cfg, xe, positions)
    h = q.shape[2]
    kb = _broadcast_kv(k, h)
    vb = _broadcast_kv(v, h)
    if s <= 2048:
        out = _dense_attention(q, kb, vb, causal=causal, q_offset=0)
    else:
        out = _chunked_attention(q, kb, vb, causal=causal, q_offset=0,
                                 chunk=chunk)
    out = out.reshape(b, s, h * cfg.head_dim) @ p["wo"].to(x.dtype)
    return (sharding.model_sum(out, p.mesh) if p.sliced else out), (k, v)


def _cp_softmax(logits, weigh, cache):
    """One softmax over a sequence held context parallel: ``logits`` (b,
    h, q, k) f32 the rank's over the k positions its ``cache`` holds,
    ``weigh(p)`` the values of those positions weighted by p (b, h, q, k),
    as (b, q, h, e).  The ranks' parts are combined over the "model"
    group by an all_reduce of the maxima (MAX), then of the exp-sums and
    of the weighted values (SUM), and normalised with a 1e-30 floor; the
    values are never gathered.  The positions from ``cache.length`` on
    are masked, so a slice with no filled position adds
    exp(NEG_INF - max) = 0.  Returns (b, q, h, e) f32."""
    shard = cache.shard
    pos = shard.start + torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(pos < cache.length, logits, NEG_INF)
    m = sharding.all_reduce(logits.amax(dim=-1), dist.ReduceOp.MAX,
                            shard.group)  # (b, h, q)
    p_ = torch.exp(logits - m[..., None])
    s = sharding.all_reduce(p_.sum(dim=-1), dist.ReduceOp.SUM, shard.group)
    acc = sharding.all_reduce(weigh(p_), dist.ReduceOp.SUM, shard.group)
    return acc / torch.clamp(s, min=1e-30).transpose(1, 2)[..., None]


def _decode_attention_cp(q, cache: KVCache):
    """Context-parallel decode attention: the rank's partial softmax over
    its slice of the cache, in f32 (an int8 slice dequantised with its
    scales), combined over the "model" group (``_cp_softmax``)."""
    h, hd = q.shape[2], q.shape[3]
    if cache.k_scale is not None:
        k_f = cache.k.float() * cache.k_scale
        v_f = cache.v.float() * cache.v_scale
    else:
        k_f, v_f = cache.k.float(), cache.v.float()
    kb = _broadcast_kv(k_f, h)
    vb = _broadcast_kv(v_f, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * _scale(hd), kb)
    out = _cp_softmax(logits, lambda p_: torch.einsum("bhqk,bkhd->bqhd", p_,
                                                      vb), cache)
    return out.to(q.dtype)


def _decode_attention(q, k, v, length: int):
    """q (b, 1, h, hd) against a whole cache's k/v (b, s, kv, hd) in q's
    dtype, the positions from ``length`` on masked."""
    h, hd = q.shape[2], q.shape[3]
    kb = _broadcast_kv(k, h)
    vb = _broadcast_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * _scale(hd),
                          kb.float())
    filled = torch.arange(kb.shape[1], device=q.device) < length
    pr = torch.softmax(torch.where(filled, logits, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr, vb.float()).to(q.dtype)


def _gathered_heads(parts, b: int, hd: int):
    """(tp, b, n * hd) blocks, rank r's n heads each, -> (b, 1, tp * n,
    hd) in rank order."""
    return parts.reshape(parts.shape[0], b, 1, -1, hd).movedim(0, 2).flatten(
        2, 3)


def _decode_sliced(p: Params, q, k_new, v_new, cache: KVCache):
    """Decode attention of a ``sliced`` node: q / k_new / v_new hold the
    new token's rank's heads; returns the rank's partial output of wo.
    A context-parallel cache: every head's q, k and v by one all_gather
    over the model group, the new position written where it is held, the
    partial softmaxes combined over all heads, the rank's heads kept.  A
    whole cache: every KV head's k and v by one all_gather, and the
    rank's query heads attend over its KV heads."""
    group = sharding.model_group(p.mesh)
    b, _, h_loc, hd = q.shape
    kv_loc = k_new.shape[2]
    j = sharding.tp_index(p.mesh)
    if cache.shard is not None:
        packed = torch.cat([t.reshape(b, -1) for t in (q, k_new, v_new)], -1)
        parts = sharding.all_gather_dim(packed[None], 0, group)
        q_all, k_all, v_all = (_gathered_heads(t, b, hd) for t in parts.split(
            [h_loc * hd, kv_loc * hd, kv_loc * hd], dim=-1))
        cache_update(cache, k_all, v_all, cache.length)
        out = _decode_attention_cp(q_all, cache)[:, :, j * h_loc:(j + 1) * h_loc]
    else:
        kv = sharding.all_gather_dim(torch.stack([k_new, v_new]), 3, group)
        cache_update(cache, kv[0], kv[1], cache.length)
        k, v = cache_kv(cache, q.dtype)
        heads = slice(j * kv_loc, (j + 1) * kv_loc)
        out = _decode_attention(q, k[:, :, heads], v[:, :, heads],
                                cache.length)
    return out.reshape(b, 1, h_loc * hd) @ p["wo"].to(q.dtype)


def gqa_decode(p: Params, cfg: ArchConfig, x, cache: KVCache):
    """Single-step decode: x (b, 1, d) at position cache.length, against
    the whole cache with the unfilled positions masked.  A sharded cache
    (x then holds the cache's rows) decodes context-parallel; a
    ``sliced`` node (the rank's heads) by ``_decode_sliced``, its
    partial output summed over the model group."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache.length, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, pos)
    if p.sliced:
        out = _decode_sliced(p, q, k_new, v_new, cache)
        return sharding.model_sum(out, p.mesh), cache
    cache = cache_update(cache, k_new, v_new, cache.length)
    if cache.shard is not None:
        out = _decode_attention_cp(q, cache)
    else:
        k, v = cache_kv(cache, x.dtype)
        out = _decode_attention(q, k, v, cache.length)
    out = out.reshape(b, 1, q.shape[2] * q.shape[3])
    return out @ p["wo"].to(x.dtype), cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache of (kv_lora + rope) dims
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor  # (b, max_s, r) compressed latents, bf16
    k_rope: torch.Tensor  # (b, max_s, rd) bf16
    length: int  # filled positions, shared by the batch
    shard: SeqShard | None = None  # the rank's sequence slice under a mesh


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
                   shard: SeqShard | None = None) -> MLACache:
    """An empty latent cache: bf16 whatever ``cfg.kv_cache_dtype`` says,
    as in the JAX package.  With ``shard`` it holds ``max_seq`` positions
    from ``shard.start``."""
    def zeros(width):
        return torch.zeros((batch, max_seq, width), dtype=torch.bfloat16,
                           device=device)

    return MLACache(c_kv=zeros(cfg.kv_lora_rank),
                    k_rope=zeros(cfg.qk_rope_head_dim), length=0, shard=shard)


def mla_cache_update(cache: MLACache, c_kv, k_rope, pos: int) -> MLACache:
    """Write latents at [pos : pos + s_new) in place; the cache's length
    becomes pos + s_new.  A sharded cache writes only the positions it
    holds; every rank advances its length."""
    end = pos + c_kv.shape[1]
    window = _held_window(cache.shard, cache.c_kv.shape[1], pos, end)
    if window is not None:
        dst, src = window
        cache.c_kv[:, dst] = c_kv[:, src].to(cache.c_kv.dtype)
        cache.k_rope[:, dst] = k_rope[:, src].to(cache.k_rope.dtype)
    cache.length = end
    return cache


def _mla_qkv(p: Params, cfg: ArchConfig, x, positions):
    """(q_nope, q_rope) per head of the heads the node holds, the
    normalised latent c_kv and the roped k_rope shared by the heads."""
    dt = x.dtype
    hd, rd = cfg.head_dim, cfg.qk_rope_head_dim
    b, s, _ = x.shape
    xq = sharding.model_enter(x, p.mesh) if p.sliced else x
    q = xq @ p["wq"].to(dt)
    q = q.reshape(b, s, q.shape[-1] // (hd + rd), hd + rd)
    q_nope = q[..., :hd]
    q_rope = apply_rope(q[..., hd:], positions, cfg.rope_theta)
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_kv_down"].to(dt), cfg.rms_eps)
    k_rope = x @ p["w_k_rope"].to(dt)
    # roped through a singleton head axis
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p: Params, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope, *,
                causal: bool, q_offset: int):
    """Attention with c_kv expanded to per-head K_nope and V (training
    and prefill), over the heads of q; under a ``sliced`` node the
    partial output of wo, which the caller sums."""
    dt = q_nope.dtype
    hd, vd = cfg.head_dim, cfg.v_head_dim
    b, sk, _ = c_kv.shape
    sq, h = q_nope.shape[1], q_nope.shape[2]
    kv = (c_kv @ p["w_kv_up"].to(dt)).reshape(b, sk, h, hd + vd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
              ) * _scale(hd + cfg.qk_rope_head_dim)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=c_kv.device)
        mask = torch.arange(sk, device=c_kv.device)[None, :] <= q_pos[:, None]
        logits = torch.where(mask, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, v.float()).to(dt)
    return out.reshape(b, sq, h * vd) @ p["wo"].to(dt)


def mla_train(p: Params, cfg: ArchConfig, x, *, causal: bool = True):
    """Full-sequence MLA; returns (out, (c_kv, k_rope)) for a cache.

    Past 4096 positions the queries go in s // 1024 chunks of 1024, as in
    the JAX package, whose loop leaves the last s % 1024 positions' output
    at zero; so does this one (ROADMAP C)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    # the latents every head reads enter the head-sliced region
    ce, ke = ((sharding.model_enter(c_kv, p.mesh),
               sharding.model_enter(k_rope, p.mesh)) if p.sliced
              else (c_kv, k_rope))
    if s > 4096:
        qc = 1024
        out = torch.zeros((b, s, cfg.d_model), dtype=x.dtype, device=x.device)
        for i in range(s // qc):
            sl = slice(i * qc, (i + 1) * qc)
            out[:, sl] = _mla_attend(p, cfg, q_nope[:, sl], q_rope[:, sl],
                                     ce, ke, causal=causal, q_offset=i * qc)
    else:
        out = _mla_attend(p, cfg, q_nope, q_rope, ce, ke, causal=causal,
                          q_offset=0)
    return (sharding.model_sum(out, p.mesh) if p.sliced else out), (c_kv,
                                                                      k_rope)


def mla_decode(p: Params, cfg: ArchConfig, x, cache: MLACache):
    """Single-step decode with weight absorption: the k half of w_kv_up
    folds into the query and the v half applies after the softmax, so
    attention runs over the (kv_lora + rope) latents and the per-step
    transient is O(b * s * r), not O(b * s * h * (hd + vd)).

    The new position's latents are the same on every model rank (their
    weights are replicated over "model") and are written where they are
    held.  A context-parallel cache runs one softmax over the whole
    sequence from the ranks' slices (``_cp_softmax``: three all_reduces
    over the model group).  A ``sliced`` node holds its heads' columns of
    w_kv_up: against a context-parallel cache it gathers every head's
    absorbed query (q_eff and q_rope in one all_gather over the model
    group), combines the softmax over all heads and keeps its own; against
    a whole cache its heads attend alone.  Either way it applies its
    heads' v half and its rows of wo and sums the partial output over the
    model group."""
    b = x.shape[0]
    dt = x.dtype
    hd, rd, vd, r = (cfg.head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    pos = torch.full((b, 1), cache.length, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, cfg, x, pos)
    h = q_nope.shape[2]
    cache = mla_cache_update(cache, c_new, kr_new, cache.length)

    w_up = p["w_kv_up"].to(dt).reshape(r, h, hd + vd)
    w_up_k, w_up_v = w_up[..., :hd], w_up[..., hd:]
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope, w_up_k)  # (b, 1, h, r)
    if cache.shard is not None and p.sliced:
        packed = torch.cat([q_eff.reshape(b, -1), q_rope.reshape(b, -1)], -1)
        parts = sharding.all_gather_dim(packed[None], 0,
                                        sharding.model_group(p.mesh))
        qe_part, qr_part = parts.split([h * r, h * rd], dim=-1)
        j = sharding.tp_index(p.mesh)
        ctx = _mla_latent_context(cfg, _gathered_heads(qe_part, b, r),
                                  _gathered_heads(qr_part, b, rd), cache, dt)
        ctx = ctx[:, :, j * h:(j + 1) * h]
    else:
        ctx = _mla_latent_context(cfg, q_eff, q_rope, cache, dt)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_up_v.float())
    out = out.to(dt).reshape(b, 1, h * vd) @ p["wo"].to(dt)
    return (sharding.model_sum(out, p.mesh) if p.sliced else out), cache


def _mla_latent_context(cfg: ArchConfig, q_eff, q_rope, cache: MLACache, dt):
    """The softmax-weighted latents (b, 1, h, r) f32 of the absorbed
    queries q_eff (b, 1, h, r) and q_rope (b, 1, h, rd) over the cache,
    its latents read in ``dt``: over the whole sequence from the rank's
    slice of a context-parallel cache (``_cp_softmax``), else over the
    cache with the positions from its length on masked."""
    ckv = cache.c_kv.to(dt).float()
    krope = cache.k_rope.to(dt).float()
    logits = (torch.einsum("bqhr,bsr->bhqs", q_eff.float(), ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), krope)
              ) * _scale(cfg.head_dim + cfg.qk_rope_head_dim)
    if cache.shard is not None:
        return _cp_softmax(logits, lambda p_: torch.einsum(
            "bhqs,bsr->bqhr", p_, ckv), cache)
    filled = torch.arange(ckv.shape[1], device=ckv.device) < cache.length
    pr = torch.softmax(torch.where(filled, logits, NEG_INF), dim=-1)
    return torch.einsum("bhqs,bsr->bqhr", pr, ckv)
