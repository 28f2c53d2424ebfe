"""The port's LM mesh paths on one gloo world of 4 CPU ranks, a (2, 2)
("data", "model") mesh, against the JAX package without a mesh.

The world is spawned once for the module (``parallel.run_ranks``); every
rank runs all cases (``tests/torch_dist_ranks.run_lm_mesh``) in f32
compute and returns numpy.  JAX sees one CPU device here, so each mesh
output is held to what the JAX package's mesh path computes, which needs
no mesh to reproduce: its dispatch groups are the data-parallel row
blocks, so its MoE on a (2, 2) mesh is its no-mesh MoE on each half of
the batch; its context-parallel decode is its plain decode.  Bars, with
f32 compute in both packages:
  * context-parallel ``gqa_decode`` (bf16 and int8 caches) 1e-5, and
    ``mla_decode`` on a latent cache split over the sequence 1e-5;
  * the sharded ``moe_ffn`` 1e-5 of the output's largest magnitude, aux
    1e-6;
  * a whole prefill 1e-4 and 8 decode steps 5e-3 (ROADMAP C's f32 decode
    bar: the bf16 cache rounds values that differ in their last bits);
  * the families the JAX package shards only through its compiler
    (mamba2, zamba2, whisper, deepseek's MLA) against the port's own
    no-mesh run, 1e-4.
The fall-back branches each take the JAX package's branch: a cache slice
with no filled position, a batch that does not divide by the data extent,
a sequence that does not divide by the model extent, experts that do not
divide by it.  On ``torch_dist_ranks.one_rank_world()`` the ports of
tests/test_system.py's MoE and decode tests on a (1, 1) mesh run against
both packages; the dry-run's CLI runs as a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro import compat
from repro import configs as jcfg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import convert, parallel
from repro_torch.models import attention as attn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding
from repro_torch.models.model import Model, shard_model

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ATTN_TOL = 1e-5
MOE_TOL, AUX_TOL = 1e-5, 1e-6
PREFILL_TOL, DECODE_TOL = 1e-4, 5e-3
PORT_TOL = 1e-4
BF16_TOL = 6e-2
B, PROMPT, STEPS = 4, 12, 8
QWEN, GRANITE, DEEPSEEK = "qwen3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b"


def _jcfg(arch, overrides=None):
    return dataclasses.replace(jcfg.smoke_config(jcfg.get_arch(arch)),
                               **(overrides or {}))


def _numpy(tree, rng=None):
    """A JAX tree as numpy f32, norm scales perturbed from ``rng``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _numpy(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "scale" and rng is not None:
            v = v * (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _x(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# cases and the JAX package's answers
# ---------------------------------------------------------------------------

ATTN_CASES = {  # (overrides, batch, filled positions, max_seq)
    "bf16_slice_unfilled": (None, B, 5, 16),
    "bf16_both_slices": (None, B, 11, 16),
    "int8": ({"kv_cache_dtype": "int8"}, B, 11, 16),
    "seq_not_dividing": (None, B, 11, 15),
    "batch_not_dividing": (None, 3, 11, 16),
}
MLA_CASES = {  # (batch, filled positions, max_seq) of deepseek's MLA
    "mla_slice_unfilled": (B, 5, 16),
    "mla_both_slices": (B, 11, 16),
}
MOE_CASES = {  # (arch, overrides, batch)
    "granite": (GRANITE, None, B),
    "deepseek_shared": (DEEPSEEK, None, B),
    "batch_not_dividing": (GRANITE, None, 3),
    "experts_not_dividing": (GRANITE, {"num_experts": 7}, B),
    "experts_not_dividing_batch3": (GRANITE, {"num_experts": 7}, 3),
}
JAX_MODELS = {  # (arch, batch, max_seq, steps): held to the JAX package
    "qwen3": (QWEN, B, PROMPT + STEPS, STEPS),
    "granite": (GRANITE, B, PROMPT + STEPS, STEPS),
    "granite_batch_not_dividing": (GRANITE, 3, PROMPT + STEPS, STEPS),
    "qwen3_seq_not_dividing": (QWEN, B, PROMPT + STEPS - 1, STEPS - 1),
}
PORT_MODELS = {  # held to the port without a mesh
    "mamba2": ("mamba2-2.7b", B, PROMPT + 4, 4),
    "zamba2": ("zamba2-1.2b", B, PROMPT + 4, 4),
    "whisper": ("whisper-small", B, PROMPT + 4, 4),
    "deepseek": (DEEPSEEK, B, PROMPT + 4, 4),
}


def _attn_case(name):
    overrides, b, filled, max_seq = ATTN_CASES[name]
    jc = _jcfg(QWEN, overrides)
    rng = np.random.default_rng(len(name))
    kv = (b, filled, jc.num_kv_heads, jc.head_dim)
    case = {"arch": QWEN, "overrides": overrides, "max_seq": max_seq,
            "params": _numpy(jattn.init_attention(jax.random.PRNGKey(3), jc),
                             rng),
            "k": rng.standard_normal(kv).astype(np.float32),
            "v": rng.standard_normal(kv).astype(np.float32),
            "x": _x((b, 1, jc.d_model), 5)}
    cache = jattn.cache_update(jattn.init_kv_cache(
        jc, b, max_seq, jc.num_kv_heads, jc.head_dim), jnp.asarray(case["k"]),
        jnp.asarray(case["v"]), 0)
    cache = cache._replace(length=jnp.asarray(filled, jnp.int32))
    want, _ = jax.jit(lambda p, x, c: jattn.gqa_decode(p, jc, x, c))(
        jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["x"]),
        cache)
    return case, np.asarray(want)


def _mla_case(name):
    """A latent cache of ``filled`` positions and one token's x; the JAX
    package's ``mla_decode`` on the whole cache."""
    b, filled, max_seq = MLA_CASES[name]
    jc = _jcfg(DEEPSEEK)
    rng = np.random.default_rng(len(name))
    case = {"arch": DEEPSEEK, "max_seq": max_seq,
            "params": _numpy(jattn.init_attention(jax.random.PRNGKey(3), jc),
                             rng),
            "c_kv": rng.standard_normal((b, filled, jc.kv_lora_rank)
                                        ).astype(np.float32),
            "k_rope": rng.standard_normal((b, filled, jc.qk_rope_head_dim)
                                          ).astype(np.float32),
            "x": _x((b, 1, jc.d_model), 5)}
    cache = jattn.init_mla_cache(jc, b, max_seq)
    cache = jattn.MLACache(
        c_kv=cache.c_kv.at[:, :filled].set(jnp.asarray(case["c_kv"], jnp.bfloat16)),
        k_rope=cache.k_rope.at[:, :filled].set(
            jnp.asarray(case["k_rope"], jnp.bfloat16)),
        length=jnp.asarray(filled, jnp.int32))
    want, _ = jax.jit(lambda p, x, c: jattn.mla_decode(p, jc, x, c))(
        jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["x"]),
        cache)
    return case, np.asarray(want)


def _halves(x, b):
    """The JAX package's dispatch groups on a (2, 2) mesh: the data
    halves where the batch divides, else the whole batch."""
    return [x[:b // 2], x[b // 2:]] if b % 2 == 0 else [x]


def _moe_case(name):
    arch, overrides, b = MOE_CASES[name]
    jc = _jcfg(arch, overrides)
    params = _numpy(jmoe.init_moe(jax.random.PRNGKey(4), jc))
    x = _x((b, 8, jc.d_model), 6)
    p = jax.tree.map(jnp.asarray, params)
    ffn = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x))
    outs, auxs = zip(*(ffn(p, jnp.asarray(h)) for h in _halves(x, b)))
    return ({"arch": arch, "overrides": overrides, "params": params, "x": x},
            (np.concatenate([np.asarray(o) for o in outs]),
             float(np.mean([float(a) for a in auxs]))))


def _jax_tree(arch, seed=1):
    return _numpy(jax.jit(jmodel.init, static_argnums=1)(
        jax.random.PRNGKey(seed), _jcfg(arch)), np.random.default_rng(seed))


def _jax_model_case(name):
    arch, b, max_seq, steps = JAX_MODELS[name]
    jc = _jcfg(arch)
    tree = _jax_tree(arch)
    batch = {"tokens": _tokens(jc, b, PROMPT, 7)}
    p = jax.tree.map(jnp.asarray, tree)
    logits, state = jax.jit(lambda p, t: jmodel.prefill(
        p, jc, {"tokens": t}, max_seq=max_seq))(p, batch["tokens"])
    want, fed = [np.asarray(logits)], []
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
    for _ in range(steps):
        fed.append(np.argmax(want[-1], -1)[:, None].astype(np.int32))
        logits, state = decode(p, state, jnp.asarray(fed[-1]))
        want.append(np.asarray(logits))
    return ({"arch": arch, "tree": tree, "batch": batch, "fed": fed,
             "max_seq": max_seq}, np.stack(want))


def _port_model_case(name):
    """The port without a mesh, fed its own argmax."""
    from repro_torch.models.frontends import frontend_spec

    arch, b, max_seq, steps = PORT_MODELS[name]
    tc = ranks.lm_config(arch)
    tree = convert.lm_params_to_numpy(Model(tc, device=CPU,
                                            generator=torch.Generator().manual_seed(2)))
    batch = {"tokens": _tokens(tc, b, PROMPT, 8)}
    for i, (k, (shape, _)) in enumerate(frontend_spec(tc, b).items()):
        batch[k] = _x(shape, 9 + i, 0.02)
    model = convert.lm_params_from_numpy(tc, tree, device=CPU)
    logits, state = model.prefill({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, max_seq=max_seq)
    want, fed = [logits.numpy()], []
    for _ in range(steps):
        fed.append(np.argmax(want[-1], -1)[:, None].astype(np.int32))
        logits, state = model.decode_step(state, torch.from_numpy(fed[-1]))
        want.append(logits.numpy())
    return ({"arch": arch, "tree": tree, "batch": batch, "fed": fed,
             "max_seq": max_seq}, np.stack(want))


@pytest.fixture(scope="module")
def world():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        attn_in, attn_want = {}, {}
        for name in ATTN_CASES:
            attn_in[name], attn_want[name] = _attn_case(name)
        mla_in, mla_want = {}, {}
        for name in MLA_CASES:
            mla_in[name], mla_want[name] = _mla_case(name)
        moe_in, moe_want = {}, {}
        for name in MOE_CASES:
            moe_in[name], moe_want[name] = _moe_case(name)
        model_in, model_want = {}, {}
        for name in JAX_MODELS:
            model_in[name], model_want[name] = _jax_model_case(name)
        for name in PORT_MODELS:
            model_in[name], model_want[name] = _port_model_case(name)
    inputs = {"attn": attn_in, "mla": mla_in, "moe": moe_in,
              "model": model_in}
    results = parallel.run_ranks(4, ranks.run_lm_mesh, inputs, device=CPU,
                                 timeout=300.0)
    return SimpleNamespace(outs=[r.value for r in results], inputs=inputs,
                           attn=attn_want, mla=mla_want, moe=moe_want,
                           model=model_want)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


# ---------------------------------------------------------------------------
# the (2, 2) world
# ---------------------------------------------------------------------------

def test_ranks_form_the_2x2_mesh(world):
    assert [o["coord"] for o in world.outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_context_parallel_decode_matches_reference(world, name):
    _, b, filled, max_seq = ATTN_CASES[name]
    for rank, out in enumerate(world.outs):
        got = out[f"attn/{name}"]
        assert _maxabs(got["out"], world.attn[name]) <= ATTN_TOL, rank
        assert got["length"] == filled + 1
        # a sequence that does not divide by "model" is held whole: the
        # reference's gather path
        assert got["sharded"] == (max_seq % 2 == 0)
        assert got["positions"] == (max_seq // 2 if got["sharded"] else max_seq)


def test_a_slice_with_no_filled_position_adds_nothing(world):
    """Five filled positions of 16: model rank 1 holds [8, 16), none
    filled before the step nor by it (position 5), and the result is
    still the reference's."""
    held = {out["coord"]: out["attn/bf16_slice_unfilled"]["held_before"]
            for out in world.outs}
    assert held == {(0, 0): 5, (0, 1): 0, (1, 0): 5, (1, 1): 0}


@pytest.mark.parametrize("name", list(MLA_CASES))
def test_split_mla_cache_decode_matches_reference(world, name):
    """``mla_decode`` with every head on the rank and the latent cache
    split over "model" (three all_reduces combine the softmax) against
    the JAX package's decode on the whole cache."""
    _, filled, max_seq = MLA_CASES[name]
    for rank, out in enumerate(world.outs):
        got = out[f"mla/{name}"]
        assert _maxabs(got["out"], world.mla[name]) <= ATTN_TOL, rank
        assert got["length"] == filled + 1
        assert got["sharded"] and got["positions"] == max_seq // 2


def test_a_split_mla_slice_with_no_filled_position_adds_nothing(world):
    """Five filled positions of 16: model rank 1 holds [8, 16) of the
    latent cache, none filled before the step nor by it (position 5)."""
    held = {out["coord"]: out["mla/mla_slice_unfilled"]["held_before"]
            for out in world.outs}
    assert held == {(0, 0): 5, (0, 1): 0, (1, 0): 5, (1, 1): 0}
    held = {out["coord"]: out["mla/mla_both_slices"]["held_before"]
            for out in world.outs}
    assert held == {(0, 0): 8, (0, 1): 3, (1, 0): 8, (1, 1): 3}


@pytest.mark.parametrize("name", list(MLA_CASES))
def test_a_write_past_the_split_mla_cache_raises(world, name):
    """Positions [14, 17) of a sequence of 16: every rank raises, the one
    whose slice holds none of them too."""
    for out in world.outs:
        assert out[f"mla/{name}"]["write_past_end"] == "ValueError"


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_sharded_moe_matches_reference_groups(world, name):
    want, aux = world.moe[name]
    for rank, out in enumerate(world.outs):
        got = out[f"moe/{name}"]
        assert _maxabs(got["out"], want) <= MOE_TOL * np.abs(want).max(), rank
        assert abs(float(got["aux"]) - aux) <= AUX_TOL, rank


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_model_under_mesh_matches_reference(world, name):
    want = world.model[name]
    for rank, out in enumerate(world.outs):
        got = out[f"model/{name}"]["logits"]
        assert got.shape == want.shape
        assert _maxabs(got[0], want[0]) <= PREFILL_TOL, rank
        assert _maxabs(got[1:], want[1:]) <= DECODE_TOL, rank


@pytest.mark.parametrize("name", list(PORT_MODELS))
def test_model_under_mesh_matches_port_without_mesh(world, name):
    want = world.model[name]
    for rank, out in enumerate(world.outs):
        got = out[f"model/{name}"]["logits"]
        assert got.shape == want.shape
        assert _maxabs(got, want) <= PORT_TOL * max(1.0, np.abs(want).max()), rank


def test_decode_step_collectives(world):
    """A decode step's collectives: per GQA or MLA layer three
    all_reduces of the context-parallel softmax, per MoE layer one of the
    combine and one of aux's mean, and one all_gather of the logits; a
    batch that does not divide by "data" gathers nothing and averages no
    aux; a sequence that does not divide by "model" reduces nothing in
    attention."""
    layers = ranks.lm_config(QWEN).num_layers
    mla_layers = ranks.lm_config(DEEPSEEK).num_layers
    expect = {"qwen3": (3 * layers, 1), "granite": (5 * layers, 1),
              "granite_batch_not_dividing": (4 * layers, 0),
              "qwen3_seq_not_dividing": (0, 1),
              "deepseek": ((3 + 2) * mla_layers, 1)}
    for out in world.outs:
        for name, (reduces, gathers) in expect.items():
            st = out[f"model/{name}"]["step_collectives"]
            assert (st["all_reduce"], st["all_gather"]) == (reduces, gathers), name


def test_shard_model_keeps_the_ranks_experts(world):
    cfg = ranks.lm_config(GRANITE)
    whole = Model(cfg, device=CPU).parameters()
    n_whole = sum(p.numel() for p in whole)
    experts = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts * cfg.num_layers
    for out in world.outs:
        assert out["model/granite"]["params"] == n_whole - experts // 2


# ---------------------------------------------------------------------------
# one rank: tests/test_system.py's mesh equivalences
# ---------------------------------------------------------------------------

def test_one_rank_sharded_moe_matches_no_mesh():
    """tests/test_system.py:40 in both packages: the MoE on a (1, 1)
    mesh equals the MoE without one."""
    jc = _jcfg(GRANITE)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jc)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, jc.d_model),
                          jnp.float32) * 0.3
    ref, aux_ref = jmoe.moe_ffn(p, jc, x)
    with compat.set_mesh(compat.make_mesh((1, 1), ("data", "model"))):
        jgot, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x))(p, x)
    tp = ranks.lm_params(_numpy(p))
    tx = torch.tensor(np.asarray(x))
    tc = ranks.lm_config(GRANITE)
    with torch.no_grad():
        plain, plain_stats = tmoe.moe_ffn(tp, tc, tx)
        with ranks.one_rank_world() as mesh, sharding.set_mesh(mesh):
            got, stats = tmoe.moe_ffn(tp, tc, tx)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6)
    assert float(stats.aux) == pytest.approx(float(plain_stats.aux), abs=1e-7)
    # the reference's own bar (rtol = atol = 2e-2; aux 1e-4 / 1e-5)
    np.testing.assert_allclose(np.asarray(jgot), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(stats.aux), float(jaux), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(stats.aux), float(aux_ref), rtol=1e-4,
                               atol=1e-5)


def test_one_rank_decode_under_mesh_matches_no_mesh():
    """tests/test_system.py:57 in both packages: whole-model decode from
    empty caches under a (1, 1) mesh (context-parallel attention with a
    group of one) equals decode without one, in bf16 at the reference's
    3e-2; the port's mesh run is held to the reference's at the
    cross-package bf16 bar, 6e-2."""
    jc, tc = _jcfg(QWEN), ranks.lm_config(QWEN)
    p = jmodel.init(jax.random.PRNGKey(0), jc)
    b, s = 2, 8
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                         jc.vocab_size), np.int32)
    def jax_run():
        state = jmodel.init_caches(jc, b, s + 1)
        step = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
        for t in range(s):
            logits, state = step(p, state, toks[:, t:t + 1])
        return np.asarray(logits)

    jplain = jax_run()
    with compat.set_mesh(compat.make_mesh((1, 1), ("data", "model"))):
        jgot = jax_run()
    model = convert.lm_params_from_numpy(tc, _numpy(p), device=CPU)

    def run():
        st = model.init_caches(b, s + 1)
        for t in range(s):
            logits, st = model.decode_step(st, torch.tensor(toks[:, t:t + 1]))
        return logits.numpy(), st

    plain, _ = run()
    with ranks.one_rank_world() as mesh, sharding.set_mesh(mesh):
        got, st = run()
    assert st.caches[0].shard is not None and st.caches[0].shard.total == s + 1
    # within a package the reference's bar; across the two, the bf16 bar
    # of tests/test_torch_lm_model.py (two libraries' bf16 rounding over 8
    # steps reads 1.07 of 3e-2 here, with or without the mesh)
    np.testing.assert_allclose(jgot, jplain, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, plain, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, jgot, rtol=BF16_TOL, atol=BF16_TOL)


def test_make_local_mesh_is_world_by_one():
    from repro_torch.launch.mesh import make_local_mesh

    with ranks.one_rank_world():
        mesh = make_local_mesh(device=CPU)
        assert mesh.mesh_dim_names == ("data", "model")
        assert sharding.mesh_shape(mesh) == {"data": 1, "model": 1}


def test_reckoning_on_a_device_mesh_equals_the_abstract_one():
    """``dryrun.reckon`` reads a ``DeviceMesh`` as it reads an abstract
    mesh of the same axes (the card's allocation check runs on the
    one-rank local mesh)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, make_local_mesh

    cfg = ranks.lm_config(GRANITE)
    abstract = AbstractMesh((1, 1), ("data", "model"))
    with ranks.one_rank_world():
        mesh = make_local_mesh(device=CPU)
        for kind in ("train", "prefill", "decode"):
            assert dryrun.reckon(cfg, kind, 4, 32, mesh) == dryrun.reckon(
                cfg, kind, 4, 32, abstract)
    model = Model(cfg, device=CPU)
    state = model.init_caches(4, 32)
    want = (sum(p.numel() * 4 for p in model.parameters())
            + sum(t.numel() * t.element_size() for c in state.caches
                  for t in (c.k, c.v)) + 4 * cfg.num_layers)
    got = dryrun.reckon(cfg, "decode", 4, 32, abstract)
    assert got["cache_bytes"] + 2 * got["params_bytes"] + got[
        "batch_bytes"] == want + 4 * 4


def test_a_write_past_the_sharded_cache_raises():
    cfg = ranks.lm_config(QWEN)
    with ranks.one_rank_world() as mesh, sharding.set_mesh(mesh):
        rows, seq, shard = attn.kv_layout(2, 6)
        cache = attn.init_kv_cache(cfg, rows, seq, cfg.num_kv_heads,
                                   cfg.head_dim, CPU, shard)
        k = torch.zeros((2, 7, cfg.num_kv_heads, cfg.head_dim))
        with pytest.raises(ValueError):
            attn.cache_update(cache, k, k, 0)


# ---------------------------------------------------------------------------
# the dry-run's shell
# ---------------------------------------------------------------------------

def _dryrun(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_dryrun_cli_writes_one_record_per_mesh(tmp_path):
    out = tmp_path / "dry"
    run = _dryrun("--arch", QWEN, "--shape", "decode_32k", "--mesh", "both",
                  "--out", str(out), "--budget-bytes", str(80 * 10 ** 9),
                  cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    files = sorted(p.name for p in out.iterdir())
    assert files == [f"{QWEN}__decode_32k__multipod.json",
                     f"{QWEN}__decode_32k__pod.json"]
    for f in files:
        rec = json.loads((out / f).read_text())
        assert rec["status"] == "ok" and rec["memory"]["fits"] is True
    assert run.stdout.count("[dryrun] ") == 2
    assert f"[dryrun] {QWEN}__decode_32k__pod: ok args=" in run.stdout


def test_dryrun_cli_refuses_save_hlo(tmp_path):
    run = _dryrun("--save-hlo", "x", "--out", str(tmp_path / "d"), cwd=tmp_path)
    assert run.returncode == 2
    assert "--save-hlo" in run.stderr
