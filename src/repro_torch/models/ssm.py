"""Mamba2 (SSD, state-space duality) blocks: the chunked scan of a whole
sequence and the O(1)-state decode step, behind the depthwise causal conv.

Shapes follow the Mamba2 paper: d_inner = expand * d_model, heads of size
``headdim`` (nheads = d_inner / headdim), a scalar-identity A per head and
one B/C group shared across heads (n = ssm_state).  The chunked scan adds
the intra-chunk dual (attention-like) term to the chunk-end states carried
across chunks, O(S * chunk) in place of O(S^2).  Decode keeps a
(batch, heads, headdim, n) f32 state and two bf16 conv windows, whatever
the context's length.

The four-operand contractions are spelled out in one order (C B^T, then
the decay mask, then X), and the recurrence over chunks is a Python loop
over the chunk axis.  ``SSMCache`` is written in place, as the attention
caches are.

A ``sliced`` node (the training and serving layouts, where the heads
divide by the model extent: ``model.computes_sliced``) computes on the
rank's block of heads.  It holds its column block of ``w_zx``, which is
[z | x], so at a model extent of 2 one rank holds z and the other x:
``h @ w_zx`` gives the rank its column block, and one exchange over the
model group a call (``sharding.exchange``) turns the blocks into the
rank's heads of z and of x.  The conv over x, the scan and the decode
step then run on those heads, with the rank's channels of ``conv_w_x``,
``conv_b_x`` and its cache; B, C and dt come from the replicated
``w_bcdt`` and enter the head-sliced region with the per-head vectors.
The gated norm sums its squares over the model group
(``sharding.model_psum``) and divides by the whole d_inner; the rank's
rows of ``w_out`` give a partial output, summed by
``sharding.model_sum``.  The cache holds the rank's heads of the state
and channels of the x window, as the JAX package's ``cache_specs``
split them; the B/C window stays whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding
from repro_torch.models.layers import (Params, dense_init, init_rmsnorm, randn,
                                       rmsnorm)


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_state


def _rank_heads(p: Params, cfg: ArchConfig) -> tuple[int, int]:
    """(first, count) of the heads node ``p`` computes on: the rank's
    block over "model" of a ``sliced`` node, else all of them."""
    _, nheads, _ = _dims(cfg)
    if not p.sliced:
        return 0, nheads
    h = nheads // sharding.tp_extent(p.mesh)
    return sharding.tp_index(p.mesh) * h, h


def init_ssm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    d_in, nheads, n = _dims(cfg)
    dev = gen.device
    return Params(
        w_zx=dense_init(gen, (d, 2 * d_in)),  # [z | x]
        w_bcdt=dense_init(gen, (d, 2 * n + nheads)),
        conv_w_x=randn(gen, (cfg.ssm_conv, d_in)) * 0.1,
        conv_b_x=torch.zeros(d_in, device=dev),
        conv_w_bc=randn(gen, (cfg.ssm_conv, 2 * n)) * 0.1,
        conv_b_bc=torch.zeros(2 * n, device=dev),
        a_log=torch.zeros(nheads, device=dev),  # A = -exp(a_log) = -1
        d_skip=torch.ones(nheads, device=dev),
        dt_bias=torch.full((nheads,), -2.0, device=dev),  # softplus ~ 0.12
        norm=init_rmsnorm(d_in, dev),
        w_out=dense_init(gen, (d_in, d)),
    )


def _softplus(x):
    # log(1 + e^x) as logaddexp(x, 0), as the JAX package forms it (F.softplus
    # returns x itself past its threshold of 20)
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(x):
    """(..., l) -> (..., l, l) lower-triangular inclusive segment sums:
    out[..., i, j] = sum_{j < m <= i} x[..., m], -inf above the diagonal
    (so that exp gives exact zeros there)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum_(j, i]
    i = torch.arange(l, device=x.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def _ssd_chunked(xh, a_dt, b_mat, c_mat, chunk: int):
    """Chunked SSD scan.

    xh:   (b, s, h, p)  inputs already scaled by dt
    a_dt: (b, s, h)     log-decay per step (A * dt, negative)
    b_mat/c_mat: (b, s, n)  single group shared across heads
    Returns y: (b, s, h, p) and the final state (b, h, p, n).
    """
    b, s, h, p = xh.shape
    n = b_mat.shape[-1]
    l = min(chunk, s)
    pad = (-s) % l
    if pad:  # zero-padding is exact: decay exp(0) = 1, x = 0 adds nothing
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    s_pad = s + pad
    c = s_pad // l
    xc = xh.reshape(b, c, l, h, p).permute(0, 3, 1, 2, 4)  # (b,h,c,l,p)
    ac = a_dt.reshape(b, c, l, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    bc = b_mat.reshape(b, c, l, n)
    cc = c_mat.reshape(b, c, l, n)

    a_cs = torch.cumsum(ac, dim=-1)  # (b,h,c,l)

    # 1. intra-chunk (dual / attention-like) term: (C B^T) * decay, then X
    scores = (cc @ bc.transpose(-1, -2))[:, None]  # (b,1,c,l,l)
    scores = scores * torch.exp(_segsum(ac))  # (b,h,c,l,l), lower-tri
    y = scores @ xc  # (b,h,c,l,p)
    del scores

    # 2. per-chunk end states: (X * decay to the chunk's end)^T B
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)  # (b,h,c,l)
    states = (xc * decay_states[..., None]).transpose(-1, -2) \
        @ bc[:, None]  # (b,h,c,p,n)

    # 3. inter-chunk recurrence over the chunk axis: the state entering
    # each chunk
    chunk_decay = torch.exp(a_cs[..., -1])  # (b,h,c)
    hstate = torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
    prev = []
    for i in range(c):
        prev.append(hstate)
        hstate = hstate * chunk_decay[:, :, i, None, None] + states[:, :, i]
    prev_states = torch.stack(prev, dim=2)  # (b,h,c,p,n)

    # 4. inter-chunk contribution: (C h_prev) * decay from the chunk's start
    state_decay = torch.exp(a_cs)  # (b,h,c,l)
    y = y + (cc[:, None] @ prev_states.transpose(-1, -2)) \
        * state_decay[..., None]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s_pad, h, p)[:, :s]
    return y, hstate


@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor  # (b, h, p, n) f32
    conv_x: torch.Tensor  # (b, conv-1, d_in) bf16 trailing x inputs (pre-conv)
    conv_bc: torch.Tensor  # (b, conv-1, 2n) bf16
    length: int  # tokens consumed, shared by the batch


def init_ssm_cache(cfg: ArchConfig, batch: int, device,
                   p: Params | None = None) -> SSMCache:
    """An empty cache of every head, or with ``p`` of the heads that node
    computes on (``_rank_heads``: a ``sliced`` node's state heads and x
    channels)."""
    d_in, nheads, n = _dims(cfg)
    if p is not None and p.sliced:
        nheads = _rank_heads(p, cfg)[1]
        d_in = nheads * cfg.ssm_headdim
    k = cfg.ssm_conv - 1
    return SSMCache(
        state=torch.zeros((batch, nheads, cfg.ssm_headdim, n), device=device),
        conv_x=torch.zeros((batch, k, d_in), dtype=torch.bfloat16,
                           device=device),
        conv_bc=torch.zeros((batch, k, 2 * n), dtype=torch.bfloat16,
                            device=device),
        length=0)


def _split_proj(p: Params, cfg: ArchConfig, x):
    """z, x_part, bc, dt_raw: of a ``sliced`` node, z, x_part and dt_raw
    of the rank's heads (``_zx_heads``; dt_raw entering the head-sliced
    region) and bc whole, replicated over "model"."""
    d_in, _, n = _dims(cfg)
    if p.sliced:
        zx = sharding.model_enter(x, p.mesh) @ p["w_zx"].to(x.dtype)
        z, x_part = _zx_heads(p, zx)
        bcdt = x @ p["w_bcdt"].to(x.dtype)
        h0, h = _rank_heads(p, cfg)
        dt_raw = sharding.model_enter(bcdt[..., 2 * n:], p.mesh)
        return z, x_part, bcdt[..., :2 * n], dt_raw[..., h0:h0 + h]
    zx = x @ p["w_zx"].to(x.dtype)
    bcdt = x @ p["w_bcdt"].to(x.dtype)
    return zx[..., :d_in], zx[..., d_in:], bcdt[..., :2 * n], bcdt[..., 2 * n:]


def _zx_heads(p: Params, zx):
    """The rank's heads of z and of x, each (b, s, d_in / tp), from its
    column block ``zx`` of [z | x].  [z | x] is 2 tp blocks of d_in / tp
    channels: block k is z's k-th for k < tp, else x's (k - tp)-th, and
    rank j holds blocks 2j and 2j + 1.  Block k goes to rank k mod tp,
    by one exchange over the model group: rank i receives z's block i
    from rank i // 2, then x's from rank (tp + i) // 2, an uneven
    exchange past tp = 2 (rank 0 of 4 sends both its blocks to ranks 0
    and 1, and nothing to ranks 2 and 3)."""
    tp, j = sharding.tp_extent(p.mesh), sharding.tp_index(p.mesh)
    b, s, w = zx.shape
    blocks = zx.reshape(b, s, 2, w // 2).movedim(2, 0)  # (2, b, s, d_in/tp)
    dest = [(2 * j) % tp, (2 * j + 1) % tp]
    if dest[1] < dest[0]:  # rank order: block 2j + 1 wrapped to rank 0
        blocks, dest = blocks.flip(0), dest[::-1]
    send = [dest.count(r) for r in range(tp)]
    recv = [int(r == j // 2) + int(r == (tp + j) // 2) for r in range(tp)]
    got = sharding.exchange(blocks, send, recv, sharding.model_group(p.mesh))
    return got[0], got[1]


def _head_params(p: Params, cfg: ArchConfig):
    """(a_log, d_skip, dt_bias, the norm's scale) of the heads ``p``
    computes on (the scale None for a whole node, whose norm reads it):
    a ``sliced`` node's replicated vectors enter the
    head-sliced region and are narrowed to the rank's heads (the scale to
    their channels), so that their gradients, one part a rank, are
    summed over the model group."""
    if not p.sliced:  # the whole norm reads its own scale
        return [p["a_log"], p["d_skip"], p["dt_bias"], None]
    vecs = [p["a_log"], p["d_skip"], p["dt_bias"], p["norm"]["scale"]]
    h0, h = _rank_heads(p, cfg)
    hd = cfg.ssm_headdim
    vecs = [sharding.model_enter(v, p.mesh) for v in vecs]
    return ([v[h0:h0 + h] for v in vecs[:3]]
            + [vecs[3][h0 * hd:(h0 + h) * hd]])


def _conv_train(w, b, u):
    """Depthwise causal conv over the sequence (kernel K)."""
    wt = w.to(u.dtype)
    k = wt.shape[0]
    padded = F.pad(u, (0, 0, k - 1, 0))
    out = sum(padded[:, i: i + u.shape[1], :] * wt[i] for i in range(k))
    return F.silu(out + b.to(u.dtype))


def _ssd_from_parts(cfg: ArchConfig, x_conv, bc_conv, dt_raw, heads):
    """The scan over the heads of ``x_conv`` and ``dt_raw``, with
    ``heads`` = ``_head_params``' vectors of those heads."""
    a_log, d_skip, dt_bias, _ = heads
    _, _, n = _dims(cfg)
    b, s, d_in = x_conv.shape
    b_mat = bc_conv[..., :n].float()
    c_mat = bc_conv[..., n:].float()
    dt = _softplus(dt_raw.float() + dt_bias)  # (b,s,h)
    a = -torch.exp(a_log)  # (h,)
    xh = x_conv.reshape(b, s, dt.shape[-1], cfg.ssm_headdim).float()
    y, hfinal = _ssd_chunked(xh * dt[..., None], a * dt, b_mat, c_mat,
                             cfg.ssm_chunk)
    y = y + d_skip[None, None, :, None] * xh
    return y.reshape(b, s, d_in), hfinal


def _gate_out(p: Params, cfg: ArchConfig, y, z, dtype, scale):
    """The gated RMSNorm over d_inner, then ``w_out``.  A ``sliced`` node
    holds the rank's channels: their sum of squares is summed over the
    model group and divided by the whole d_inner, the norm scaled by the
    rank's ``scale``, and the partial output of its rows of ``w_out``
    summed over the model group."""
    if not p.sliced:
        y = rmsnorm(p["norm"], y.to(dtype) * F.silu(z), cfg.rms_eps)
        return y @ p["w_out"].to(dtype)
    d_in = _dims(cfg)[0]
    g = rmsnorm({"scale": scale}, y.to(dtype) * F.silu(z), cfg.rms_eps,
                mean=lambda sq: sharding.model_psum(
                    torch.sum(sq, dim=-1, keepdim=True), p.mesh) / d_in)
    return sharding.model_sum(g @ p["w_out"].to(dtype), p.mesh)


def _ssm_forward(p: Params, cfg: ArchConfig, x):
    """(out, (final state, pre-conv x, pre-conv bc)) of the chunked scan,
    over the heads ``p`` computes on."""
    z, x_part, bc, dt_raw = _split_proj(p, cfg, x)
    heads = _head_params(p, cfg)
    x_conv = _conv_train(p["conv_w_x"], p["conv_b_x"], x_part)
    bc_conv = _conv_train(p["conv_w_bc"], p["conv_b_bc"], bc)
    if p.sliced:  # every head of the rank reads B and C
        bc_conv = sharding.model_enter(bc_conv, p.mesh)
    y, hfinal = _ssd_from_parts(cfg, x_conv, bc_conv, dt_raw, heads)
    return _gate_out(p, cfg, y, z, x.dtype, heads[3]), (hfinal, x_part, bc)


def ssm_train(p: Params, cfg: ArchConfig, x):
    """x: (b, s, d) -> (b, s, d) with the chunked SSD scan."""
    out, _ = _ssm_forward(p, cfg, x)
    return out


def ssm_prefill(p: Params, cfg: ArchConfig, x, cache: SSMCache):
    """Like ssm_train, and writes the post-prompt recurrent state and the
    conv windows (the last ssm_conv - 1 pre-conv inputs) into ``cache``,
    so that decode continues from the prompt (a ``sliced`` node: the
    state of the rank's heads and the window of their x channels).  A prompt shorter than the
    window raises ``ValueError``: it cannot fill the window (the JAX
    package keeps a short window there, and its next decode step fails)."""
    k = cfg.ssm_conv - 1
    if x.shape[1] < k:
        raise ValueError(
            f"a prompt of {x.shape[1]} tokens is shorter than the SSM conv "
            f"window of ssm_conv - 1 = {k} inputs that decode continues from")
    out, (hfinal, x_part, bc) = _ssm_forward(p, cfg, x)
    cache.state.copy_(hfinal)
    cache.conv_x.copy_(x_part[:, -k:])
    cache.conv_bc.copy_(bc[:, -k:])
    cache.length += x.shape[1]
    return out, cache


def ssm_decode(p: Params, cfg: ArchConfig, x, cache: SSMCache):
    """Single-token step: x (b, 1, d); O(1) in the context's length.  The
    cache advances in place.  A ``sliced`` node steps the rank's heads
    (its cache holds theirs)."""
    _, _, n = _dims(cfg)
    b = x.shape[0]
    dt_ = x.dtype
    z, x_part, bc, dt_raw = _split_proj(p, cfg, x)
    a_log, d_skip, dt_bias, scale = _head_params(p, cfg)

    def conv_step(w, bias, window, new):
        cat = torch.cat([window.to(dt_), new], dim=1)  # (b, K, ch)
        out = torch.sum(cat * w.to(dt_)[None], dim=1, keepdim=True)
        window.copy_(cat[:, 1:])
        return F.silu(out + bias.to(dt_))

    x_conv = conv_step(p["conv_w_x"], p["conv_b_x"], cache.conv_x, x_part)
    bc_conv = conv_step(p["conv_w_bc"], p["conv_b_bc"], cache.conv_bc, bc)
    if p.sliced:
        bc_conv = sharding.model_enter(bc_conv, p.mesh)

    b_vec = bc_conv[:, 0, :n].float()
    c_vec = bc_conv[:, 0, n:].float()
    dt = _softplus(dt_raw[:, 0].float() + dt_bias)  # (b,h)
    a = -torch.exp(a_log)
    da = torch.exp(a * dt)  # (b,h)
    xh = x_conv[:, 0].reshape(b, dt.shape[-1], cfg.ssm_headdim).float()
    state = cache.state * da[..., None, None] \
        + (xh * dt[..., None])[..., None] * b_vec[:, None, None, :]
    cache.state.copy_(state)
    y = (state @ c_vec[:, None, :, None])[..., 0] \
        + d_skip[None, :, None] * xh  # (b,h,p)
    out = _gate_out(p, cfg, y.reshape(b, 1, x_part.shape[-1]), z, dt_, scale)
    cache.length += 1
    return out, cache


def ssm_reference_scan(p: Params, cfg: ArchConfig, x):
    """Sequential (step-by-step) oracle: ssm_decode over the sequence from
    an empty cache.  O(S) steps."""
    b, s, _ = x.shape
    cache = init_ssm_cache(cfg, b, x.device)
    return torch.cat([ssm_decode(p, cfg, x[:, t: t + 1], cache)[0]
                      for t in range(s)], dim=1)
