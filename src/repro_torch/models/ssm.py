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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (Params, dense_init, init_rmsnorm, randn,
                                       rmsnorm)


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_state


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


def init_ssm_cache(cfg: ArchConfig, batch: int, device) -> SSMCache:
    d_in, nheads, n = _dims(cfg)
    k = cfg.ssm_conv - 1
    return SSMCache(
        state=torch.zeros((batch, nheads, cfg.ssm_headdim, n), device=device),
        conv_x=torch.zeros((batch, k, d_in), dtype=torch.bfloat16,
                           device=device),
        conv_bc=torch.zeros((batch, k, 2 * n), dtype=torch.bfloat16,
                            device=device),
        length=0)


def _split_proj(p: Params, cfg: ArchConfig, x):
    """z, x_part, bc, dt_raw."""
    d_in, _, n = _dims(cfg)
    zx = x @ p["w_zx"].to(x.dtype)
    bcdt = x @ p["w_bcdt"].to(x.dtype)
    return zx[..., :d_in], zx[..., d_in:], bcdt[..., :2 * n], bcdt[..., 2 * n:]


def _conv_train(w, b, u):
    """Depthwise causal conv over the sequence (kernel K)."""
    wt = w.to(u.dtype)
    k = wt.shape[0]
    padded = F.pad(u, (0, 0, k - 1, 0))
    out = sum(padded[:, i: i + u.shape[1], :] * wt[i] for i in range(k))
    return F.silu(out + b.to(u.dtype))


def _ssd_from_parts(p: Params, cfg: ArchConfig, x_conv, bc_conv, dt_raw):
    d_in, nheads, n = _dims(cfg)
    b, s, _ = x_conv.shape
    b_mat = bc_conv[..., :n].float()
    c_mat = bc_conv[..., n:].float()
    dt = _softplus(dt_raw.float() + p["dt_bias"])  # (b,s,h)
    a = -torch.exp(p["a_log"])  # (h,)
    xh = x_conv.reshape(b, s, nheads, cfg.ssm_headdim).float()
    y, hfinal = _ssd_chunked(xh * dt[..., None], a * dt, b_mat, c_mat,
                             cfg.ssm_chunk)
    y = y + p["d_skip"][None, None, :, None] * xh
    return y.reshape(b, s, d_in), hfinal


def _gate_out(p: Params, cfg: ArchConfig, y, z, dtype):
    y = rmsnorm(p["norm"], y.to(dtype) * F.silu(z), cfg.rms_eps)
    return y @ p["w_out"].to(dtype)


def _ssm_forward(p: Params, cfg: ArchConfig, x):
    """(out, (final state, pre-conv x, pre-conv bc)) of the chunked scan."""
    z, x_part, bc, dt_raw = _split_proj(p, cfg, x)
    x_conv = _conv_train(p["conv_w_x"], p["conv_b_x"], x_part)
    bc_conv = _conv_train(p["conv_w_bc"], p["conv_b_bc"], bc)
    y, hfinal = _ssd_from_parts(p, cfg, x_conv, bc_conv, dt_raw)
    return _gate_out(p, cfg, y, z, x.dtype), (hfinal, x_part, bc)


def ssm_train(p: Params, cfg: ArchConfig, x):
    """x: (b, s, d) -> (b, s, d) with the chunked SSD scan."""
    out, _ = _ssm_forward(p, cfg, x)
    return out


def ssm_prefill(p: Params, cfg: ArchConfig, x, cache: SSMCache):
    """Like ssm_train, and writes the post-prompt recurrent state and the
    conv windows (the last ssm_conv - 1 pre-conv inputs) into ``cache``,
    so that decode continues from the prompt.  A prompt shorter than the
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
    cache advances in place."""
    d_in, nheads, n = _dims(cfg)
    b = x.shape[0]
    dt_ = x.dtype
    z, x_part, bc, dt_raw = _split_proj(p, cfg, x)

    def conv_step(w, bias, window, new):
        cat = torch.cat([window.to(dt_), new], dim=1)  # (b, K, ch)
        out = torch.sum(cat * w.to(dt_)[None], dim=1, keepdim=True)
        window.copy_(cat[:, 1:])
        return F.silu(out + bias.to(dt_))

    x_conv = conv_step(p["conv_w_x"], p["conv_b_x"], cache.conv_x, x_part)
    bc_conv = conv_step(p["conv_w_bc"], p["conv_b_bc"], cache.conv_bc, bc)

    b_vec = bc_conv[:, 0, :n].float()
    c_vec = bc_conv[:, 0, n:].float()
    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (b,h)
    a = -torch.exp(p["a_log"])
    da = torch.exp(a * dt)  # (b,h)
    xh = x_conv[:, 0].reshape(b, nheads, cfg.ssm_headdim).float()
    state = cache.state * da[..., None, None] \
        + (xh * dt[..., None])[..., None] * b_vec[:, None, None, :]
    cache.state.copy_(state)
    y = (state @ c_vec[:, None, :, None])[..., 0] \
        + p["d_skip"][None, :, None] * xh  # (b,h,p)
    out = _gate_out(p, cfg, y.reshape(b, 1, d_in), z, dt_)
    cache.length += 1
    return out, cache


def ssm_reference_scan(p: Params, cfg: ArchConfig, x):
    """Sequential (step-by-step) oracle: ssm_decode over the sequence from
    an empty cache.  O(S) steps."""
    b, s, _ = x.shape
    cache = init_ssm_cache(cfg, b, x.device)
    return torch.cat([ssm_decode(p, cfg, x[:, t: t + 1], cache)[0]
                      for t in range(s)], dim=1)
