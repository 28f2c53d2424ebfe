"""The port's tensor-parallel serving on one gloo world of 4 CPU ranks, a
(2, 2) ("data", "model") mesh, against the JAX package without a mesh.

Each model is held in the serving layout (``shard_model(..., train=True,
fsdp=False, dtype=torch.float32)``: every rank holds exactly its slice of
every parameter under ``param_specs(..., fsdp=False)``), and ``prefill`` and
``decode_step`` run on it under the mesh.  The world is spawned once for
the module (``parallel.run_ranks``); every rank runs all cases
(``tests/torch_dist_ranks.run_serve_tp``) in f32 compute and returns
numpy.  JAX sees one CPU device here, so each mesh output is held to
what the JAX package's mesh path computes, which needs no mesh to
reproduce: its dispatch groups are the data-parallel row blocks, so
every reference runs each data half of the batch alone (the whole batch
where it does not divide), fed the argmax of its own logits.  Bars, with
f32 weights and compute in both packages:
  * a prefill 1e-4 and 8 greedy decode steps 5e-3 (ROADMAP C's f32
    decode bar: the bf16 cache rounds values that differ in their last
    bits);
  * the families the JAX package shards only through its compiler
    (mamba2, zamba2, whisper, deepseek's MLA) also against the port's
    own no-mesh run on the same halves, 1e-4 of the largest logit (the
    head-sliced mixers' free-running steps 1e-3; every step also 1e-4
    when decoded from the no-mesh run's own caches).
mamba2 and zamba2 compute their Mamba2 mixers on the rank's heads (the
[z | x] blocks exchanged into head-aligned blocks, the norm's statistic
summed over "model"); deepseek holds its MLA latent caches split over the
sequence and combines the absorbed decode's softmax over "model".  Each
fall-back takes its branch: KV heads that do not divide by the model
extent (the gather form), SSM heads that do not (the mixer's gather
form), a vocabulary that does not (the whole table), a ``max_seq`` that
does not (the whole cache, GQA and MLA), an int8 cache, a batch that does
not divide by the data extent.  The bf16 serving layout is built on the
meta device in each rank: its parameter bytes, GQA, MLA and SSM cache
bytes are ``dryrun.reckon``'s decode cell's.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro import configs as jcfg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import convert, parallel
from repro_torch.models import layers as tlayers
from repro_torch.models.frontends import frontend_spec
from repro_torch.models.model import _hybrid_layout

CPU = "cpu"
PREFILL_TOL, DECODE_TOL = 1e-4, 5e-3
PORT_TOL = 1e-4
# the head-sliced mixers' free-running decode against the port without a
# mesh: about twice the worst of three prompt draws (4.9e-4 of the
# largest logit; the steps from the same caches read <= 2.8e-5)
SLICED_SSM_FREE_TOL = 1e-3
B, PROMPT, STEPS = 4, 12, 8
QWEN = "qwen3-4b"
SSM_3_HEADS = {"ssm_expand": 3, "ssm_headdim": 128}
MODELS = {  # (arch, overrides, batch, max_seq, steps)
    "qwen3": (QWEN, None, B, PROMPT + STEPS, STEPS),
    "llava": ("llava-next-mistral-7b", None, B, PROMPT + STEPS, STEPS),
    "granite": ("granite-moe-1b-a400m", None, B, PROMPT + STEPS, STEPS),
    "deepseek": ("deepseek-v2-236b", None, B, PROMPT + STEPS, STEPS),
    "zamba2": ("zamba2-1.2b", None, B, PROMPT + STEPS, STEPS),
    "mamba2": ("mamba2-2.7b", None, B, PROMPT + STEPS, STEPS),
    "whisper": ("whisper-small", None, B, PROMPT + STEPS, STEPS),
    # the fall-back branches
    "kv_heads_not_dividing": (QWEN, {"num_kv_heads": 1}, B, PROMPT + 4, 4),
    # 3 SSM heads of 128 channels: the mixer gathers its four split weights
    "ssm_heads_not_dividing": ("mamba2-2.7b", SSM_3_HEADS, B, PROMPT + 4, 4),
    "vocab_not_dividing": (QWEN, {"vocab_size": 511}, B, PROMPT + 4, 4),
    "seq_not_dividing": (QWEN, None, B, PROMPT + 3, 3),
    "mla_seq_not_dividing": ("deepseek-v2-236b", None, B, PROMPT + 3, 3),
    "int8": (QWEN, {"kv_cache_dtype": "int8"}, B, PROMPT + 4, 4),
    "batch_not_dividing": ("granite-moe-1b-a400m", None, 3, PROMPT + 4, 4),
}
# held also to the port's no-mesh run: the JAX package shards these only
# through its compiler
PORT_HELD = ("deepseek", "zamba2", "mamba2", "whisper",
             "ssm_heads_not_dividing")
# the GQA caches follow the JAX package's cache_specs: every cache bytes
# reckoned (the caches' int32 lengths are Python ints in the port)
CACHE_SPECS_HELD = ("qwen3", "llava", "granite", "whisper",
                    "seq_not_dividing", "int8", "batch_not_dividing")
# and the head-sliced SSM caches (zamba2: with its GQA caches)
SSM_CACHE_HELD = ("mamba2", "zamba2")
# and the MLA latent caches: split over the sequence, or whole where
# max_seq does not divide by the model extent
MLA_CACHE_HELD = ("deepseek", "mla_seq_not_dividing")


def _jcfg(arch, overrides=None):
    return dataclasses.replace(jcfg.smoke_config(jcfg.get_arch(arch)),
                               **(overrides or {}))


def _numpy(tree, rng):
    """A JAX tree as numpy f32, norm scales perturbed from ``rng``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _numpy(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "scale":
            v = v * (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _batch(tc, b, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, tc.vocab_size, (b, PROMPT),
                                  dtype=np.int32)}
    for k, (shape, _) in frontend_spec(tc, b).items():
        out[k] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _halves(batch, b):
    """The JAX package's dispatch groups on a (2, 2) mesh: the data halves
    where the batch divides, else the whole batch."""
    if b % 2:
        return [batch]
    return [{k: v[:b // 2] for k, v in batch.items()},
            {k: v[b // 2:] for k, v in batch.items()}]


def _jax_serve(jc, tree, batch, max_seq, steps):
    """The JAX package's prefill and ``steps`` greedy decode steps on each
    dispatch group; (logits (steps + 1, b, V), tokens fed each step)."""
    p = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, bt: jmodel.prefill(p, jc, bt, max_seq=max_seq))
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
    runs = []
    for half in _halves(batch, batch["tokens"].shape[0]):
        logits, state = prefill(p, {k: jnp.asarray(v) for k, v in half.items()})
        seq, fed = [np.asarray(logits)], []
        for _ in range(steps):
            fed.append(np.argmax(seq[-1], -1)[:, None].astype(np.int32))
            logits, state = decode(p, state, jnp.asarray(fed[-1]))
            seq.append(np.asarray(logits))
        runs.append((np.stack(seq), fed))
    return (np.concatenate([r[0] for r in runs], axis=1),
            [np.concatenate([r[1][t] for r in runs]) for t in range(steps)])


def _port_serve(tc, tree, batch, max_seq, fed):
    """The port without a mesh on each dispatch group, fed ``fed``: the
    logits of each call, and the caches each decode step starts from
    (per step, per group: ``ranks.serve_cache_tensors``).  On one
    thread, as each rank runs: a product's rounding can change with the
    thread count, and the bf16 conv windows carry such a last bit into
    the following steps (the 3-head mixer's 4th step moves by 4.7e-4 of
    the largest logit between 1 and 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_serve_groups(tc, tree, batch, max_seq, fed)
    finally:
        torch.set_num_threads(threads)


def _port_serve_groups(tc, tree, batch, max_seq, fed):
    model = convert.lm_params_from_numpy(tc, tree, device=CPU)
    b = batch["tokens"].shape[0]
    outs, caches = [], [[] for _ in fed]
    for i, half in enumerate(_halves(batch, b)):
        rows = slice(i * (b // 2), (i + 1) * (b // 2)) if b % 2 == 0 else slice(None)
        logits, state = model.prefill({k: torch.from_numpy(v)
                                       for k, v in half.items()}, max_seq)
        seq = [logits.numpy()]
        for t, tok in enumerate(fed):
            caches[t].append([{k: v.clone() for k, v in c.items()}
                              for c in ranks.serve_cache_tensors(state)])
            logits, state = model.decode_step(state, torch.from_numpy(tok[rows]))
            seq.append(logits.numpy())
        outs.append(np.stack(seq))
    return np.concatenate(outs, axis=1), caches


def _case(name):
    arch, overrides, b, max_seq, steps = MODELS[name]
    jc = _jcfg(arch, overrides)
    tree = _numpy(jax.jit(jmodel.init, static_argnums=1)(
        jax.random.PRNGKey(1), jc), np.random.default_rng(len(name)))
    tc = ranks.lm_config(arch, overrides)
    batch = _batch(tc, b, 7)
    want, fed = _jax_serve(jc, tree, batch, max_seq, steps)
    port, forced = (_port_serve(tc, tree, batch, max_seq, fed)
                    if name in PORT_HELD else (None, None))
    return ({"arch": arch, "overrides": overrides, "tree": tree,
             "batch": batch, "fed": fed, "max_seq": max_seq,
             "forced": forced},
            want, port)


@pytest.fixture(scope="module")
def world():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        cases, want, port = {}, {}, {}
        for name in MODELS:
            cases[name], want[name], port[name] = _case(name)
    sizes = {name: {"arch": a, "overrides": o, "batch": b, "max_seq": s}
             for name, (a, o, b, s, _) in MODELS.items()}
    inputs = {"model": cases, "bytes": sizes}
    results = parallel.run_ranks(4, ranks.run_serve_tp, inputs, device=CPU,
                                 timeout=300.0)
    return SimpleNamespace(outs=[r.value for r in results], want=want,
                           port=port)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


def test_ranks_form_the_2x2_mesh(world):
    assert [o["coord"] for o in world.outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", list(MODELS))
def test_each_rank_holds_exactly_its_slices(world, name):
    assert all(out[f"model/{name}"]["slices_exact"] for out in world.outs)


@pytest.mark.parametrize("name", list(MODELS))
def test_serving_layout_matches_reference(world, name):
    want = world.want[name]
    for rank, out in enumerate(world.outs):
        got = out[f"model/{name}"]["logits"]
        assert got.shape == want.shape
        assert _maxabs(got[0], want[0]) <= PREFILL_TOL, rank
        assert _maxabs(got[1:], want[1:]) <= DECODE_TOL, rank


@pytest.mark.parametrize("name", PORT_HELD)
def test_serving_layout_matches_port_without_mesh(world, name):
    """The prefill and the free-running decode at 1e-4 of the largest
    logit, and each decode step also decoded from the caches the port's
    run without a mesh decodes it from (each rank loads its shard of
    them) at 1e-4.  The head-sliced SSM cases hold their free-running
    steps at ``SLICED_SSM_FREE_TOL``: the model ranks' partial sums
    (w_out's, the norm's) round in another order than one process's
    whole products, and the bf16 conv windows, as the JAX package keeps
    them, turn such a last-bit difference into a whole bf16 step now and
    then, which the following steps carry; the steps from the same
    caches hold at 1e-4."""
    want = world.port[name]
    scale = max(1.0, np.abs(want).max())
    free = SLICED_SSM_FREE_TOL if name in SSM_CACHE_HELD else PORT_TOL
    for rank, out in enumerate(world.outs):
        got = out[f"model/{name}"]
        assert _maxabs(got["logits"][0], want[0]) <= PORT_TOL * scale, rank
        assert _maxabs(got["logits"][1:], want[1:]) <= free * scale, rank
        assert got["forced_logits"].shape == want[1:].shape
        assert _maxabs(got["forced_logits"], want[1:]) <= PORT_TOL * scale, rank


@pytest.mark.parametrize("name", list(MODELS))
def test_model_group_logits_bitwise_equal(world, name):
    by_coord = {o["coord"]: o[f"model/{name}"]["logits"] for o in world.outs}
    for i in (0, 1):
        assert np.array_equal(by_coord[(i, 0)], by_coord[(i, 1)])


def _layer_counts(cfg) -> tuple[int, int]:
    """(attention blocks, SSM layers) a token runs through: the hybrid's
    shared block once a group."""
    if cfg.family == "hybrid":
        n_groups, per_group, trailing = _hybrid_layout(cfg)
        return n_groups, n_groups * per_group + trailing
    if cfg.family == "ssm":
        return 0, cfg.num_layers
    return cfg.num_layers, 0


def _step_collectives(name):
    """(all_reduce, all_gather, all_to_all) of a decode step of case
    ``name`` on the (2, 2) mesh, from its config: the embedding's model
    sum (a vocabulary that divides), per GQA layer one gather of q, k and
    v, the three all_reduces of the context-parallel softmax and wo's sum
    (the whole cache: one gather of k and v and wo's sum; the gather
    form: its four weights gathered, then the context-parallel softmax),
    per MLP one sum, per MoE its combine and aux's mean over the data
    rows, per MLA layer one gather of q_eff and q_rope, the three
    all_reduces of the context-parallel softmax and wo's sum (the whole
    latent cache: wo's sum only); per SSM layer the [z | x] exchange, the
    norm's sum and w_out's sum (the gather form: its four split weights
    gathered, and no mixer weight gathered otherwise); then the logits
    gathered over "model" (a vocabulary that divides) and over "data" (a
    batch that divides)."""
    arch, overrides, b, max_seq, _ = MODELS[name]
    cfg = ranks.lm_config(arch, overrides)
    vocab = cfg.vocab_size % 2 == 0
    rows = b % 2 == 0
    cp = max_seq % 2 == 0
    if cfg.num_kv_heads % 2 == 0 and cfg.num_heads % 2 == 0:
        attn = (1, 3 + 1) if cp else (1, 1)
    else:
        attn = (4, 3 if cp else 0)
    ffn = (0, 2 if rows else 1) if cfg.family == "moe" else (0, 1)
    per = (attn[0] + ffn[0], attn[1] + ffn[1])
    if cfg.use_mla:
        per = (1, 4 + ffn[1]) if cp else (0, 1 + ffn[1])
    ssm_heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    ssm = (0, 2, 1) if ssm_heads % 2 == 0 else (4, 0, 0)  # (ag, ar, a2a)
    n_attn, n_ssm = _layer_counts(cfg)
    return (int(vocab) + per[1] * n_attn + ssm[1] * n_ssm,
            per[0] * n_attn + ssm[0] * n_ssm + int(vocab) + int(rows),
            ssm[2] * n_ssm)


@pytest.mark.parametrize("name", [n for n, (a, *_) in MODELS.items()
                                  if a in (QWEN, "granite-moe-1b-a400m",
                                           "llava-next-mistral-7b",
                                           "deepseek-v2-236b", "mamba2-2.7b",
                                           "zamba2-1.2b")])
def test_decode_step_collectives(world, name):
    want = _step_collectives(name)
    for out in world.outs:
        st = out[f"model/{name}"]["step_collectives"]
        assert (st["all_reduce"], st["all_gather"], st["all_to_all"]) == \
            want, out["coord"]


@pytest.mark.parametrize("name", ["qwen3", "int8", "seq_not_dividing",
                                  "kv_heads_not_dividing", "mamba2", "zamba2",
                                  "ssm_heads_not_dividing", "deepseek",
                                  "mla_seq_not_dividing"])
def test_prefill_exchanges_heads_for_positions(world, name):
    """One all_to_all a GQA layer into a context-parallel cache; none
    into a whole cache (an all_gather over heads) or in the gather form
    (the K/V already hold every head).  One a head-sliced SSM layer (its
    [z | x] exchange), none in the mixer's gather form.  None an MLA
    layer: every rank computes the whole prompt's latents and writes the
    positions it holds."""
    arch, overrides, _, max_seq, _ = MODELS[name]
    cfg = ranks.lm_config(arch, overrides)
    n_attn, n_ssm = _layer_counts(cfg)
    sliced = cfg.num_kv_heads % 2 == 0 and not cfg.use_mla
    want = n_attn if sliced and max_seq % 2 == 0 else 0
    if (cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim) % 2 == 0:
        want += n_ssm
    for out in world.outs:
        assert out[f"model/{name}"]["prefill_collectives"]["all_to_all"] == want


def test_whisper_cross_kv_holds_the_ranks_heads(world):
    heads = ranks.lm_config("whisper-small").num_heads
    for out in world.outs:
        assert out["model/whisper"]["cross_heads"] == heads // 2


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_parameter_bytes_are_reckoned(world, name):
    for out in world.outs:
        got = out[f"bytes/{name}"]
        assert got["dtypes"] == ["torch.bfloat16"]
        assert got["param_bytes"] == got["reckon_params"]


@pytest.mark.parametrize("name", CACHE_SPECS_HELD)
def test_gqa_cache_bytes_are_reckoned(world, name):
    for out in world.outs:
        got = out[f"bytes/{name}"]
        assert got["kv_bytes"] + 4 * got["kv_caches"] == got["reckon_cache"]
        served = out[f"model/{name}"]
        assert (served["kv_bytes"], served["kv_caches"]) == (
            got["kv_bytes"], got["kv_caches"])


@pytest.mark.parametrize("name", SSM_CACHE_HELD)
def test_ssm_cache_bytes_are_reckoned(world, name):
    """Each rank's SSM caches hold the state of its rows and heads, the x
    window of their channels and the whole B/C window, as ``cache_specs``
    splits them: with the GQA caches (zamba2), the bytes of
    ``dryrun.reckon``'s decode cell, the stacked tree's int32 lengths
    (one a layer) aside.  The model served holds the same bytes."""
    for out in world.outs:
        got = out[f"bytes/{name}"]
        assert got["ssm_caches"] > 0
        assert (got["ssm_bytes"] + got["kv_bytes"]
                + 4 * (got["ssm_caches"] + got["kv_caches"])
                == got["reckon_cache"])
        served = out[f"model/{name}"]
        assert (served["ssm_bytes"], served["ssm_caches"]) == (
            got["ssm_bytes"], got["ssm_caches"])


@pytest.mark.parametrize("name", MLA_CACHE_HELD)
def test_mla_cache_bytes_are_reckoned(world, name):
    """Each rank's MLA latent caches hold its rows and its slice of the
    sequence (the whole sequence where ``max_seq`` does not divide by the
    model extent), as ``cache_specs`` splits them: the bytes of
    ``dryrun.reckon``'s decode cell, the stacked tree's int32 lengths
    (one a layer) aside.  The model served holds the same bytes."""
    arch, _, b, max_seq, _ = MODELS[name]
    cfg = ranks.lm_config(arch)
    held = max_seq // 2 if max_seq % 2 == 0 else max_seq
    for out in world.outs:
        got = out[f"bytes/{name}"]
        assert got["mla_caches"] == cfg.num_layers
        assert got["mla_bytes"] + 4 * got["mla_caches"] == got["reckon_cache"]
        assert got["mla_bytes"] == (cfg.num_layers * (b // 2) * held * 2
                                    * (cfg.kv_lora_rank + cfg.qk_rope_head_dim))
        served = out[f"model/{name}"]
        assert (served["mla_bytes"], served["mla_caches"]) == (
            got["mla_bytes"], got["mla_caches"])


def test_f32_layout_holds_twice_the_bf16_bytes(world):
    """The f32 serving layout holds each slice in 4 bytes: twice the bf16
    layout's bytes."""
    for out in world.outs:
        for name in MODELS:
            assert (out[f"model/{name}"]["param_bytes"]
                    == 2 * out[f"bytes/{name}"]["param_bytes"])


@pytest.mark.parametrize("what", ["fsdp_prefill", "fsdp_decode",
                                  "no_mesh_prefill"])
def test_serving_refuses(world, what):
    for out in world.outs:
        assert out["refusals"][what] == "ValueError"
