"""Model API of the port for the dense and MoE block families (and vlm,
which runs the dense blocks behind a patch-embedding stub); attention is
GQA, or MLA with a latent cache where the config says ``use_mla``.

    model = Model(cfg, device, generator)
    loss, metrics = model.train_loss(batch)
    logits, state = model.prefill(batch, max_seq)       # serving
    logits, state = model.decode_step(state, tokens)

``batch`` carries "tokens" (and "labels" for the loss); vlm adds the
stub "patches" of ``frontends.synthetic_frontend``.  The parameter
layout is the JAX package's tree with the stacked layer axis unrolled
into ``layers.<i>`` (``convert.lm_params_from_numpy`` carries a JAX tree
across).  The SSM, hybrid and enc-dec families are not ported and raise
``NotImplementedError``; none falls back to another family.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Params, dense_init, embed,
                                       init_embedding, init_rmsnorm, rmsnorm)
from repro_torch.models.transformer import Block, stack_decode, stack_train

# ROADMAP A.4's slice for each family the port does not build yet
_UNPORTED = {"ssm": "9c (SSM)", "hybrid": "9c (hybrid)",
             "encdec": "9c (enc-dec)"}


def _check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port cannot build."""
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet (ROADMAP A.4, slice {_UNPORTED[cfg.family]})")


class ServeState(NamedTuple):
    # one attention.KVCache (attention.MLACache under MLA) per layer,
    # written in place
    caches: list


class Model(nn.Module):
    """The dense/MoE/vlm language model.  Parameters are drawn from
    ``generator`` (seed 0 on ``device`` when None) on its device, stored
    f32, and live on ``device`` (the CUDA card when None)."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.init(generator)
        self.to(dev)

    def init(self, gen: torch.Generator) -> None:
        """The parameter layout of the JAX package's ``model.init``."""
        cfg = self.cfg
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model)
        self.final_norm = init_rmsnorm(cfg.d_model, gen.device)
        if not cfg.tie_embeddings:
            self.unembed = Params(table=dense_init(
                gen, (cfg.vocab_size, cfg.d_model), in_axis=1))
        kind = "moe" if cfg.family == "moe" else "dense"
        self.layers = nn.ModuleList(Block(cfg, gen, kind)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _table(self) -> torch.Tensor:
        return (self.embed if self.cfg.tie_embeddings else self.unembed)["table"]

    def _input_embeddings(self, batch: dict) -> torch.Tensor:
        x = embed(self.embed, batch["tokens"])  # (b, s, d)
        if self.cfg.family == "vlm" and "patches" in batch:
            # anyres stub: precomputed patch embeddings replace the first
            # num_patch_tokens positions
            n = self.cfg.num_patch_tokens
            x = torch.cat([batch["patches"].to(x.dtype), x[:, n:]], dim=1)
        return x

    # ---- training loss (forward) ------------------------------------------

    def _chunked_xent(self, hidden, labels, chunk: int = 512):
        """Mean cross entropy over labels >= 0, with the (b, s, vocab) f32
        logits formed one sequence chunk at a time; the padded tail of
        the last chunk carries label -1."""
        table = self._table().float()
        s = hidden.shape[1]
        chunk = min(chunk, s)
        pad = (-s) % chunk
        if pad:
            hidden = nn.functional.pad(hidden, (0, 0, 0, pad))
            labels = nn.functional.pad(labels, (0, pad), value=-1)
        tot = torch.zeros((), device=hidden.device)
        cnt = torch.zeros((), device=hidden.device)
        for c0 in range(0, s + pad, chunk):
            lab = labels[:, c0:c0 + chunk].long()
            logits = hidden[:, c0:c0 + chunk].float() @ table.T
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
            valid = (lab >= 0).float()
            tot = tot + torch.sum((lse - gold) * valid)
            cnt = cnt + torch.sum(valid)
        return tot / torch.clamp(cnt, min=1.0)

    def train_loss(self, batch: dict, aux_weight: float = 0.01):
        """(xent + aux_weight * aux, {"xent", "aux"}): aux is the MoE
        load-balancing loss summed over the layers, 0 for dense blocks."""
        x, aux = stack_train(self.layers, self._input_embeddings(batch))
        h = rmsnorm(self.final_norm, x, self.cfg.rms_eps)
        loss = self._chunked_xent(h, batch["labels"])
        return loss + aux_weight * aux, {"xent": loss, "aux": aux}

    # ---- serving: prefill + decode -------------------------------------------

    def init_caches(self, batch: int, max_seq: int) -> ServeState:
        """Empty caches for ``batch`` requests of context ``max_seq``."""
        cfg = self.cfg
        if cfg.use_mla:
            return ServeState(caches=[
                attn.init_mla_cache(cfg, batch, max_seq, self.device)
                for _ in range(cfg.num_layers)])
        return ServeState(caches=[
            attn.init_kv_cache(cfg, batch, max_seq, cfg.num_kv_heads,
                               cfg.head_dim, self.device)
            for _ in range(cfg.num_layers)])

    @torch.no_grad()
    def prefill(self, batch: dict, max_seq: int = 0):
        """Run the prompt, fill each layer's cache; returns the
        last-position logits (b, vocab) f32 and the state."""
        b, s = batch["tokens"].shape
        x = self._input_embeddings(batch)
        state = self.init_caches(b, max_seq or s)
        update = (attn.mla_cache_update if self.cfg.use_mla
                  else attn.cache_update)
        for block, cache in zip(self.layers, state.caches, strict=True):
            x, entries, _ = block.block_train(x)
            update(cache, *entries, 0)
        h = rmsnorm(self.final_norm, x, self.cfg.rms_eps)
        return self._last_logits(h), state

    @torch.no_grad()
    def decode_step(self, state: ServeState, tokens):
        """tokens (b, 1) -> next-token logits (b, vocab) f32; the caches
        advance in place."""
        x = stack_decode(self.layers, embed(self.embed, tokens), state.caches)
        return self._last_logits(rmsnorm(self.final_norm, x,
                                         self.cfg.rms_eps)), state

    def _last_logits(self, h):
        return h[:, -1].float() @ self._table().float().T
