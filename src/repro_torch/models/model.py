"""Model API of the port over every family of the registry: dense, MoE
(attention GQA, or MLA with a latent cache where the config says
``use_mla``), vlm (the dense blocks behind a patch-embedding stub), ssm
(Mamba2 blocks), hybrid (Zamba2: groups of SSM blocks, each followed by
one weight-shared attention block) and encdec (whisper: an encoder over
stub frames, decoder layers with cross attention).

    model = Model(cfg, device, generator)
    loss, metrics = model.train_loss(batch)
    logits, state = model.prefill(batch, max_seq)       # serving
    logits, state = model.decode_step(state, tokens)

``batch`` carries "tokens" (and "labels" for the loss); vlm adds the
stub "patches" and encdec the stub "frames" of
``frontends.synthetic_frontend``.  The parameter layout is the JAX
package's tree with each stacked layer axis unrolled into
``layers.<i>``, ``ssm_layers.<i>`` or ``enc_layers.<i>``; the hybrid's
``shared_attn`` is one block, unstacked, as there
(``convert.lm_params_from_numpy`` carries a JAX tree across).

Under a mesh (``sharding.set_mesh`` with a ``DeviceMesh``; one rank is
one shard) ``prefill`` and ``decode_step`` take the global batch, run
this rank's rows (its block of the data axes, or every row where the
batch does not divide) and return the global logits, gathered over the
data group; ``train_loss`` takes the global batch and returns the loss
of the rank's rows.  Each GQA cache holds the rank's rows and its slice
of the sequence over "model", every KV head, and each MLA latent cache
its rows and its slice of the sequence (context-parallel decode, as
``cache_specs`` splits them; the whole sequence where it does not divide
by the model extent); the SSM caches of a whole mixer hold the rank's
rows.  A whole model serves in the experts-only form
(``shard_model(model, mesh)``: the MoE runs the rank's experts, every
other projection, the Mamba2 mixer included, runs whole on every rank,
whisper's cross K/V holds every head).

A model in a SLICED LAYOUT holds only its slice of every parameter under
the JAX package's ``param_specs`` (``launch.shardings.train_layout``).
It is built by ``shard_model(model, mesh, train=True, fsdp=, dtype=)``,
or by ``Model(..., train_mesh=mesh, fsdp=, dtype=)``, which slices each
block as soon as it is drawn, so the whole model is never held.  The
training layout takes ``param_specs``' FSDP choice (``fsdp=None``); the
serving layout is its ``fsdp=False`` form with ``dtype=torch.bfloat16``,
as the JAX package's serving cells hold the weights, each slice cast
once at rest.  A layer
gathers what it cannot compute on when it reads a parameter
(``sharding.read_param``: the FSDP dim over the data axes always, the
"model" dim in the gather form) and computes on the rest Megatron style:
attention by heads where they divide by the model extent, the MLP's
hidden dim, the MoE's experts, the vocabulary of the tables, the Mamba2
mixer by heads where they divide (``computes_sliced``; ``models.ssm``
exchanges its [z | x] column blocks into head-aligned blocks).  Served,
head-sliced attention exchanges its K/V into the context-parallel cache
(``attention.prefill_cache``, ``attention.gqa_decode``; MLA gathers each
decoded token's absorbed queries, ``attention.mla_decode``), whisper's cross
K/V holds the rank's heads, a head-sliced Mamba2 layer's cache holds
the state of the rank's heads and the x window of their channels (the
B/C window whole), as ``cache_specs`` splits them, and the
vocabulary-sliced logits are gathered over the model group.
``prefill`` and ``decode_step`` refuse a layout with FSDP slices: the
JAX package never serves with FSDP.

``cfg.remat_policy`` sets what ``train_loss`` keeps for the backward
pass, block by block (``torch.utils.checkpoint``): "full" (the default)
keeps a block's input and runs the block again, "dots" keeps the
products' outputs, "none" keeps everything.  As in the JAX package, the
hybrid's groups and the encoder always remat in full.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MetaGenerator, Params, dense_init,
                                       embed, init_embedding, init_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.models.transformer import Block, precompute_cross_kv


def _hybrid_layout(cfg: ArchConfig):
    """(groups, SSM layers per group, trailing SSM layers): each group's
    SSM layers run, then the shared attention block."""
    n_groups = cfg.num_layers // cfg.attn_every
    per_group = cfg.attn_every - 1
    trailing = cfg.num_layers - n_groups * cfg.attn_every
    return n_groups, per_group, trailing


# the products whose outputs the "dots" policy keeps (JAX's checkpoint_dots
# keeps every dot_general's)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(policy: str, fn, *args):
    """fn(*args) under a remat policy: "full" keeps only the inputs and
    runs fn again in the backward pass, "dots" keeps the products'
    outputs and recomputes the rest, "none" keeps everything.  Without
    autograd (serving) fn just runs."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r}")


def _train_blocks(blocks: list, x, crosses: list):
    """x through ``blocks`` (each with its cross (k, v) or None);
    returns (x, the blocks' aux losses stacked)."""
    auxs = []
    for blk, cross in zip(blocks, crosses):
        x, _, aux = blk.block_train(x, cross)
        auxs.append(aux)
    return x, torch.stack(auxs)


class _Rows(NamedTuple):
    """A sharded call's rows: ``split`` over the data axes of ``mesh``,
    or whole (also without a mesh)."""
    mesh: object
    split: bool

    def __call__(self, x):
        return sharding.own_rows(self.mesh, x) if self.split else x

    def gather(self, x):
        return sharding.gather_rows(self.mesh, x) if self.split else x


def computes_sliced(cfg: ArchConfig, name: str, tp: int) -> bool:
    """Whether the layer of parameter ``name`` (the port's name) computes
    on its "model" slice at a model extent ``tp`` (else a "model" split
    of the parameter is gathered on use: the gather form).  The Mamba2
    mixer computes on the rank's heads where its heads divide by ``tp``
    (its [z | x] column blocks exchanged into head-aligned blocks, its
    gated norm's statistic summed over the model group: ``models.ssm``);
    attention where its heads (GQA: query and KV heads) divide; the MoE
    where the experts and the shared hidden dim divide; the MLP's hidden
    dim and the tables' vocabulary always.  Else gathered: the config
    alone decides."""
    path = name.split(".")
    if "ssm" in path:
        return ssm_mod._dims(cfg)[1] % tp == 0
    if "moe" in path:
        return moe_mod.expert_sharded(cfg, tp)
    heads = cfg.num_heads % tp == 0
    if "cross" in path or ("attn" in path and cfg.use_mla):
        return heads
    if "attn" in path:
        return heads and cfg.num_kv_heads % tp == 0
    return True


def _slice_tree(module: nn.Module, prefix: str, layout,
                dtype: torch.dtype | None = None) -> None:
    """Slice the parameters of ``module`` (``prefix`` its name in the
    model) to this rank's by ``layout`` (a ``shardings.TrainLayout``),
    cast to ``dtype`` where given, in place, and mark each ``Params``
    node that holds a slice."""
    with torch.no_grad():
        for mod_name, node in module.named_modules(prefix=prefix):
            if not isinstance(node, Params):
                continue
            splits = {}
            for leaf, t in list(node._parameters.items()):
                name = f"{mod_name}.{leaf}"
                split = layout.splits[name]
                if split.data is not None or split.model is not None:
                    if tuple(t.shape) != split.shape:
                        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                         f"the layout's whole {split.shape}")
                    t = layout.local(name, t)
                    splits[leaf] = split
                elif dtype in (None, t.dtype):
                    continue
                node._parameters[leaf] = nn.Parameter(
                    t.to(dtype=dtype or t.dtype, copy=True))
            if splits:
                node.splits = splits
                node.mesh = layout.mesh
                node.sliced = any(sp.model is not None and sp.sliced
                                  for sp in splits.values())


def shard_model(model: "Model", mesh, *, train: bool = False,
                fsdp: bool | None = None,
                dtype: torch.dtype | None = None) -> "Model":
    """Shard a whole model for ``mesh``, in place; returns it.

    Experts only (``train`` False): drop the expert weights this rank
    does not own: each MoE block keeps experts [j E/tp, (j+1) E/tp) of
    its stacks and, with shared experts, that slice of their hidden dim,
    j being the rank's "model" coordinate of ``mesh``.  Experts that do
    not divide by the model extent stay whole (the grouped form runs
    them all).

    Sliced (``train`` True): the layout of ``mesh`` (a ``DeviceMesh``)
    under ``param_specs(..., fsdp)`` (None: FSDP where the JAX package's
    threshold puts it), every parameter this rank's slice, cast once to
    ``dtype`` where given; the layout is kept as ``model.train_layout``.
    ``fsdp=False`` with ``dtype=torch.bfloat16`` is the serving layout,
    as the JAX package's serving cells hold the weights."""
    if model.train_layout is not None:
        raise ValueError("the model is already in a sliced layout")
    if train:
        from repro_torch.launch import shardings

        layout = shardings.train_layout(model.cfg, mesh, fsdp)
        _slice_tree(model, "", layout, dtype)
        model.train_layout = layout
        return model
    if dtype is not None:
        raise ValueError("dtype is the weight dtype of a sliced layout "
                         "(train=True)")
    cfg = model.cfg
    tp_ext = sharding.extent(mesh, sharding.tp_axis(mesh))
    if cfg.family != "moe" or tp_ext == 1 or not moe_mod.expert_sharded(
            cfg, tp_ext):
        return model
    j = sharding.tp_index(mesh)
    e_loc = cfg.num_experts // tp_ext
    f_loc = cfg.moe_d_ff * cfg.num_shared_experts // tp_ext

    def keep(node, name, dim, n):
        node._parameters[name] = nn.Parameter(
            node[name].narrow(dim, j * n, n).clone())

    with torch.no_grad():
        for blk in model.layers:
            p = blk.moe
            if p["w_gate"].shape[0] != cfg.num_experts:
                continue  # already sharded
            for name in ("w_gate", "w_up", "w_down"):
                keep(p, name, 0, e_loc)
            if "shared" in p:
                for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0)):
                    keep(p["shared"], name, dim, f_loc)
    return model


def _sliced_xent_terms(logits, local, n: int, mesh):
    """(logsumexp, gold logit) of each position over the whole vocabulary
    from the rank's block of its logits (n columns): the max (MAX) and
    the sum of exponentials (SUM) over the model group, the gold logit
    from the rank that holds the label (``local``: the label's column in
    the block, out of [0, n) on the other ranks)."""
    group = sharding.model_group(mesh)
    m = sharding.all_reduce(logits.detach().amax(dim=-1), dist.ReduceOp.MAX,
                            group)
    lse = m + torch.log(sharding.model_sum(
        torch.exp(logits - m[..., None]).sum(dim=-1), mesh))
    held = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, sharding.model_sum(torch.where(held, gold, 0.0), mesh)


class ServeState(NamedTuple):
    # per layer, written in place: an attention.KVCache (MLACache under
    # MLA), or an ssm.SSMCache for the SSM layers of ssm and hybrid
    caches: list
    # encdec: each decoder layer's cross (k, v) of the encoder output
    cross_kv: list | None = None
    # hybrid: one KVCache per group for the shared attention block
    attn_caches: list | None = None


class Model(nn.Module):
    """The language model of any family.  Parameters are drawn from
    ``generator`` (seed 0 on ``device`` when None) on its device, stored
    f32, and live on ``device`` (the CUDA card when None).  On the meta
    device nothing is drawn or allocated: the parameters have their
    shapes only.

    With ``train_mesh`` (a ``DeviceMesh``) the model is built in that
    mesh's sliced layout (``shard_model``'s sliced form, ``fsdp`` and
    ``dtype`` as there: ``fsdp=False, dtype=torch.bfloat16`` is the
    serving layout): each block is sliced and cast as soon as it is
    drawn, so the whole model is never held, and the values are the
    slices of the whole model drawn from the same generator."""

    # the sliced layout (``launch.shardings.TrainLayout``) the parameters
    # are sliced by; None: whole
    train_layout = None

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: torch.Generator | None = None, *,
                 train_mesh=None, fsdp: bool | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if dtype is not None and train_mesh is None:
            raise ValueError("dtype is the weight dtype of a sliced layout "
                             "(train_mesh)")
        dev = resolve_device(device)
        if generator is None:
            generator = (MetaGenerator() if dev.type == "meta" else
                         torch.Generator(device=dev).manual_seed(0))
        self.cfg = cfg
        layout = None
        if train_mesh is not None:
            from repro_torch.launch import shardings

            layout = shardings.train_layout(cfg, train_mesh, fsdp)
        self.init(generator, layout, dtype)
        self.to(dev)
        self.train_layout = layout

    def init(self, gen: torch.Generator, layout=None,
             dtype: torch.dtype | None = None) -> None:
        """The parameter layout of the JAX package's ``model.init``; with
        ``layout``, each top-level node and block sliced by it and cast
        to ``dtype`` (where given) once drawn."""
        cfg = self.cfg

        def put(name, module):
            if layout is not None:
                _slice_tree(module, name, layout, dtype)
            return module

        self.embed = put("embed", init_embedding(gen, cfg.vocab_size,
                                                 cfg.d_model))
        self.final_norm = put("final_norm",
                              init_rmsnorm(cfg.d_model, gen.device))
        if not cfg.tie_embeddings:
            self.unembed = put("unembed", Params(table=dense_init(
                gen, (cfg.vocab_size, cfg.d_model), in_axis=1)))

        def stack(name, kind, n):
            return nn.ModuleList(put(f"{name}.{i}", Block(cfg, gen, kind))
                                 for i in range(n))

        if cfg.family == "hybrid":
            n_groups, per_group, trailing = _hybrid_layout(cfg)
            self.ssm_layers = stack("ssm_layers", "ssm",
                                    n_groups * per_group + trailing)
            self.shared_attn = put("shared_attn", Block(cfg, gen, "dense"))
        elif cfg.family == "encdec":
            self.enc_layers = stack("enc_layers", "dense", cfg.encoder_layers)
            self.enc_norm = put("enc_norm",
                                init_rmsnorm(cfg.d_model, gen.device))
            self.layers = stack("layers", "cross", cfg.num_layers)
        else:
            self.layers = stack("layers", {"moe": "moe", "ssm": "ssm"}.get(
                cfg.family, "dense"), cfg.num_layers)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _table_node(self) -> Params:
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def _blocks(self) -> list:
        """The blocks in the order the residual stream runs through them,
        each with its cache's place in a ServeState: (block, field,
        index).  The hybrid runs the one shared block after each group,
        with that group's cache."""
        if self.cfg.family != "hybrid":
            return [(blk, "caches", i) for i, blk in enumerate(self.layers)]
        n_groups, per_group, trailing = _hybrid_layout(self.cfg)
        out = []
        for g in range(n_groups):
            out += [(self.ssm_layers[i], "caches", i)
                    for i in range(g * per_group, (g + 1) * per_group)]
            out.append((self.shared_attn, "attn_caches", g))
        first = n_groups * per_group
        return out + [(self.ssm_layers[i], "caches", i)
                      for i in range(first, first + trailing)]

    def _input_embeddings(self, batch: dict) -> torch.Tensor:
        x = embed(self.embed, batch["tokens"])  # (b, s, d)
        if self.cfg.family == "vlm" and "patches" in batch:
            # anyres stub: precomputed patch embeddings replace the first
            # num_patch_tokens positions
            n = self.cfg.num_patch_tokens
            x = torch.cat([batch["patches"].to(x.dtype), x[:, n:]], dim=1)
        return x

    def _encode(self, frames) -> torch.Tensor:
        """The whisper encoder over the stub frame embeddings: non-causal
        attention blocks, then enc_norm."""
        cfg = self.cfg

        def layer(blk, x):
            h = rmsnorm(blk.pre_norm, x, cfg.rms_eps)
            a, _ = attn.gqa_train(blk.attn, cfg, h, causal=False)
            x = x + a
            return x + mlp(blk.mlp, rmsnorm(blk.post_norm, x, cfg.rms_eps))

        x = frames.to(layers.COMPUTE_DTYPE)
        for blk in self.enc_layers:  # the encoder always remats in full
            x = _remat("full", layer, blk, x)
        return rmsnorm(self.enc_norm, x, cfg.rms_eps)

    def _cross_kvs(self, batch: dict) -> list | None:
        """Each decoder layer's cross (k, v) of the encoded frames
        (encdec), else None."""
        if self.cfg.family != "encdec":
            return None
        enc = self._encode(batch["frames"])
        return [precompute_cross_kv(blk.cross, self.cfg, enc)
                for blk in self.layers]

    # ---- training loss (forward) ------------------------------------------

    def _chunked_xent(self, hidden, labels, chunk: int = 512):
        """Mean cross entropy over labels >= 0, with the (b, s, vocab) f32
        logits formed one sequence chunk at a time; the padded tail of
        the last chunk carries label -1.  A ``sliced`` table holds the
        rank's block of the vocabulary: each chunk's logits are that
        block's (``_sliced_xent_terms``)."""
        node = self._table_node()
        table = node["table"].float()
        if node.sliced:
            hidden = sharding.model_enter(hidden, node.mesh)
            lo, n = layers.vocab_range(node)
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
            if node.sliced:
                lse, gold = _sliced_xent_terms(logits, lab - lo, n, node.mesh)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
            valid = (lab >= 0).float()
            tot = tot + torch.sum((lse - gold) * valid)
            cnt = cnt + torch.sum(valid)
        return tot / torch.clamp(cnt, min=1.0)

    def _remat_units(self) -> list:
        """``_blocks()`` cut into units of remat, each (entries, policy):
        one block a unit under ``cfg.remat_policy``, but the hybrid's
        groups (SSM layers, then the shared block) are one unit each,
        remat in full whatever the policy, as in the JAX package; its
        trailing layers follow the policy."""
        entries, policy = self._blocks(), self.cfg.remat_policy
        if self.cfg.family != "hybrid":
            return [([e], policy) for e in entries]
        n_groups, per_group, _ = _hybrid_layout(self.cfg)
        size = per_group + 1
        grouped = n_groups * size
        return ([(entries[s:s + size], "full") for s in range(0, grouped, size)]
                + [([e], policy) for e in entries[grouped:]])

    def train_loss(self, batch: dict, aux_weight: float = 0.01):
        """(xent + aux_weight * aux, {"xent", "aux"}): aux is the MoE
        load-balancing loss summed over the layers, 0 for other blocks.
        Under autograd each unit of ``_remat_units`` runs under its remat
        policy; the policy moves no value.

        Under a mesh it takes the global batch and runs this rank's rows
        (``_rows``): xent is the mean over the rank's valid tokens, and
        aux the mean of the data groups' (``moe.moe_ffn``, autograd-aware),
        so the global loss is the mean of the ranks' losses.  That holds
        because every rank holds the same number of valid tokens: the
        labels are the rolled tokens (``data.pipeline``), valid at every
        position, and the chunk padding is the same on every rank.  The
        mean is the caller's (``dryrun.build_train_step``); the loss here
        is the rank's, the same on every rank of its model group.

        A model in its training layout runs under the mesh it was sliced
        for; under a mesh whose "model" axis holds several ranks the model
        must be in its training layout (a whole model's MoE would give
        each rank the gradients of its own experts only)."""
        mesh = sharding.current_mesh()
        lay = self.train_layout
        if lay is not None and mesh != lay.mesh:
            raise ValueError("a model in its training layout trains under "
                             "the mesh it was sliced for")
        if lay is None and mesh is not None and sharding.tp_extent(mesh) > 1:
            raise ValueError("training under a mesh whose model axis holds "
                             "several ranks needs the model in its training "
                             "layout (shard_model(..., train=True))")
        with self._rows(batch["labels"].shape[0]) as own:
            batch = {k: own(v) for k, v in batch.items()}
            x = self._input_embeddings(batch)
            cross = self._cross_kvs(batch)
            auxs = []
            for unit, policy in self._remat_units():
                crosses = [None if cross is None else cross[i]
                           for _, _, i in unit]
                x, aux = _remat(policy, _train_blocks, [b for b, _, _ in unit],
                                x, crosses)
                auxs.append(aux)
            aux = torch.cat(auxs).sum()
            h = rmsnorm(self.final_norm, x, self.cfg.rms_eps)
            loss = self._chunked_xent(h, batch["labels"])
        return loss + aux_weight * aux, {"xent": loss, "aux": aux}

    # ---- serving: prefill + decode -------------------------------------------

    def init_caches(self, batch: int, max_seq: int) -> ServeState:
        """Empty caches for ``batch`` requests of context ``max_seq`` (an
        SSM cache holds the same bytes at any context).  Under a mesh,
        this rank's shards of them (a head-sliced Mamba2 layer's: its
        heads)."""
        cfg, dev = self.cfg, self.device
        # every cache holds the rank's rows; a KV or MLA cache its
        # positions too
        batch, seq, shard = attn.kv_layout(batch, max_seq)

        def kv_caches(n):
            return [attn.init_kv_cache(cfg, batch, seq, cfg.num_kv_heads,
                                       cfg.head_dim, dev, shard)
                    for _ in range(n)]

        def ssm_caches(blocks):
            # each of the heads its mixer computes on
            return [ssm_mod.init_ssm_cache(cfg, batch, dev, blk.ssm)
                    for blk in blocks]

        if cfg.family == "hybrid":
            n_groups, _, _ = _hybrid_layout(cfg)
            return ServeState(caches=ssm_caches(self.ssm_layers),
                              attn_caches=kv_caches(n_groups))
        if cfg.family == "ssm":
            return ServeState(caches=ssm_caches(self.layers))
        if cfg.use_mla:
            return ServeState(caches=[
                attn.init_mla_cache(cfg, batch, seq, dev, shard)
                for _ in range(cfg.num_layers)])
        return ServeState(caches=kv_caches(cfg.num_layers))

    def _run(self, step, x, state: ServeState):
        """x through every block by ``step`` (Block.block_prefill or
        Block.block_decode), each with its cache and cross (k, v)."""
        for blk, field, i in self._blocks():
            x = step(blk, x, getattr(state, field)[i],
                     None if state.cross_kv is None else state.cross_kv[i])
        return x

    def _serving(self, what: str) -> None:
        """Refuse to serve a sliced layout that the JAX package never
        serves (FSDP slices), or outside the mesh it was sliced for."""
        lay = self.train_layout
        if lay is None:
            return
        if any(sp.data is not None for sp in lay.splits.values()):
            raise ValueError(f"{what} of a model whose layout splits "
                             "parameters over the data axes (FSDP): the JAX "
                             "package serves only TP-only slices "
                             "(param_specs(..., fsdp=False), the serving "
                             "layout)")
        if sharding.current_mesh() != lay.mesh:
            raise ValueError(f"{what} of a model in a sliced layout runs "
                             "under the mesh it was sliced for")

    @torch.no_grad()
    def prefill(self, batch: dict, max_seq: int = 0):
        """Run the prompt, fill each layer's cache; returns the
        last-position logits (b, vocab) f32 and the state.  An SSM layer
        raises ``ValueError`` on a prompt shorter than ssm_conv - 1, and
        so does a model that ``_serving`` refuses."""
        self._serving("prefill")
        b, s = batch["tokens"].shape
        with self._rows(b) as own:
            batch = {k: own(v) for k, v in batch.items()}
            x = self._input_embeddings(batch)
            state = self.init_caches(b, max_seq or s)._replace(
                cross_kv=self._cross_kvs(batch))
            x = self._run(Block.block_prefill, x, state)
            h = rmsnorm(self.final_norm, x, self.cfg.rms_eps)
            return own.gather(self._last_logits(h)), state

    @torch.no_grad()
    def decode_step(self, state: ServeState, tokens):
        """tokens (b, 1) -> next-token logits (b, vocab) f32; the caches
        advance in place.  A model that ``_serving`` refuses raises
        ``ValueError``."""
        self._serving("decode_step")
        with self._rows(tokens.shape[0]) as own:
            x = self._run(Block.block_decode, embed(self.embed, own(tokens)),
                          state)
            return own.gather(self._last_logits(rmsnorm(
                self.final_norm, x, self.cfg.rms_eps))), state

    @contextlib.contextmanager
    def _rows(self, batch: int):
        """This rank's rows of a global batch of ``batch`` under a mesh:
        yields ``own`` (x -> the rank's rows of x) with ``own.gather``
        (the rank's rows of a result -> the global result); without a
        mesh, or inside a caller's ``sharding.model_rows`` (whose input
        already holds the rank's rows), both return their input."""
        mesh = sharding.current_mesh()
        if mesh is None or sharding.rows_split() is not None:
            # no mesh, or the caller already holds the rank's rows
            yield _Rows(None, False)
            return
        split = sharding.batch_split(mesh, batch)
        with sharding.model_rows(split):
            yield _Rows(mesh, split)

    def _last_logits(self, h):
        """The last position's f32 logits (rows, vocab); a ``sliced``
        table's (rows, its block of the vocabulary) gathered over the
        model group."""
        node = self._table_node()
        logits = h[:, -1].float() @ node["table"].float().T
        if node.sliced:
            logits = sharding.all_gather_dim(logits, -1,
                                             sharding.model_group(node.mesh))
        return logits
