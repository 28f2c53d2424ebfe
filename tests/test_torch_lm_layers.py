"""The LM substrate's layers, attention core, KV cache, configurations and
token stream in the port, held to the JAX package on the CPU.

Inputs come from a numpy seed and cross as numpy arrays.  A bar is on
max |diff| in units of the reference's largest magnitude where that
exceeds 1 (f32 rounds relative to the value).  Measured maxima on this
CPU beside their bars:
  * f32 layers, bar 1e-6: rmsnorm 9.5e-7 absolute at outputs up to 4.2
    (2.3e-7 in units), RoPE 2.4e-7, SwiGLU MLP 1.8e-7, GELU MLP 2.4e-7,
    embed and unembed 0;
  * attention, bar 1e-5: chunked (chunk 4 over 10 keys, causal and not,
    q_offset 0 and 3) 4.8e-7, dense 3.6e-7;
  * KV cache: bf16 bytes, int8 bytes and scales equal to JAX's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import configs as tcfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

LAYER_TOL = 1e-6
ATTN_TOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def _close(want, got, tol) -> bool:
    """max |want - got| <= tol, in units of want's largest magnitude where
    that exceeds 1: f32 rounds relative to the value, so a bar of a few
    ulps grows with it."""
    return _err(want, got) <= tol * max(1.0, float(np.max(np.abs(
        np.asarray(want, np.float64)))))


def _params(**leaves):
    return tlayers.Params(**{k: _t(v) for k, v in leaves.items()})


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = tlayers.rmsnorm(_params(scale=scale), _t(x), 1e-5)
    assert _close(want, got.detach(), LAYER_TOL)
    # bf16 input: statistics and scale in f32, one cast back at the end
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xb, 1e-5)
    got = tlayers.rmsnorm(_params(scale=scale), _t(x).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    assert _err(want.astype(jnp.float32), got.detach().float()) == 0.0


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 7))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    assert _close(want, got, LAYER_TOL)
    assert _err(jlayers.rope_frequencies(32, theta),
                tlayers.rope_frequencies(32, theta)) == 0.0


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp_matches_jax(gated):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"w_up": rng.standard_normal((32, 64)).astype(np.float32) / 6,
         "w_down": rng.standard_normal((64, 32)).astype(np.float32) / 8}
    if gated:
        p["w_gate"] = rng.standard_normal((32, 64)).astype(np.float32) / 6
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = tlayers.mlp(_params(**p), _t(x))
    assert _close(want, got.detach(), LAYER_TOL)


def test_embed_and_unembed_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    assert _err(jlayers.embed({"table": jnp.asarray(table)},
                              jnp.asarray(toks)).astype(jnp.float32),
                tlayers.embed(_params(table=table), _t(toks)).float()
                .detach()) == 0.0
    # COMPUTE_DTYPE is read at call time
    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
    assert tlayers.embed(_params(table=table), _t(toks)).dtype == torch.float32
    want = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))
    got = tlayers.unembed(_params(table=table), _t(x))
    assert _close(want, got.detach(), LAYER_TOL)


def _qkv(seed, b=2, s=10, h=3, dh=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, dh)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 3)])
def test_chunked_attention_matches_jax(causal, q_offset):
    """chunk 4 over s = 10 keys: the last chunk is padded by 2 and masked."""
    q, k, v = _qkv(4)
    q = q[:, :7] if q_offset else q  # 7 queries after 3 cached positions
    want = jattn._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    q_offset=q_offset, chunk=4)
    got = tattn._chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_offset=q_offset, chunk=4)
    assert _close(want, got, ATTN_TOL)
    dense = tattn._dense_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_offset=q_offset)
    assert _close(got, dense, ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_and_kv_broadcast_match_jax(causal):
    q, k, v = _qkv(5, h=4)
    kv = k[:, :, :2], v[:, :, :2]  # 2 KV heads for 4 query heads
    kb = [jattn._broadcast_kv(jnp.asarray(a), 4) for a in kv]
    tb = [tattn._broadcast_kv(_t(a), 4) for a in kv]
    for a, b in zip(kb, tb):
        assert _err(a, b) == 0.0
    want = jattn._dense_attention(jnp.asarray(q), *kb, causal=causal,
                                  q_offset=0)
    got = tattn._dense_attention(_t(q), *tb, causal=causal, q_offset=0)
    assert _close(want, got, ATTN_TOL)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_cache_update_and_cache_kv_match_jax(cache_dtype):
    """Two writes (a 5-position prefill, then one decode position) into a
    9-position cache: bytes and scales equal to JAX's, the dequantized
    K/V too.  One row of K is all zero: the int8 scale floor."""
    cfg = dataclasses.replace(tcfg.smoke_config(tcfg.get_arch("qwen3-4b")),
                              kv_cache_dtype=cache_dtype)
    jc = jcfg.smoke_config(jcfg.get_arch("qwen3-4b"))
    jc = dataclasses.replace(jc, kv_cache_dtype=cache_dtype)
    rng = np.random.default_rng(6)
    writes = [[(rng.standard_normal((2, s, 2, 32)) * 2).astype(np.float32)
               for _ in range(2)] for s in (5, 1)]
    writes[0][0][1, 2, 1] = 0.0
    jcache = jattn.init_kv_cache(jc, 2, 9, 2, 32)
    tcache = tattn.init_kv_cache(cfg, 2, 9, 2, 32, "cpu")
    pos = 0
    for k_new, v_new in writes:
        kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k_new, v_new))
        jcache = jattn.cache_update(jcache, kb, vb, pos)
        tcache = tattn.cache_update(tcache, _t(k_new).bfloat16(),
                                    _t(v_new).bfloat16(), pos)
        pos += k_new.shape[1]
        assert int(jcache.length) == tcache.length == pos
    for name in ("k", "v", "k_scale", "v_scale"):
        want, got = getattr(jcache, name), getattr(tcache, name)
        if want is None:
            assert got is None
            continue
        if want.dtype == jnp.bfloat16:
            want, got = want.astype(jnp.float32), got.float()
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if cache_dtype == "int8":
        assert tcache.k.dtype == torch.int8
        assert float(tcache.k_scale[1, 2, 1, 0]) == np.float32(1e-8) / 127
    for want, got in zip(jattn.cache_kv(jcache, jnp.float32),
                         tattn.cache_kv(tcache, torch.float32)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError, match="cannot hold"):
        tattn.cache_update(tcache, _t(writes[0][0]), _t(writes[0][1]), pos)


@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_configs_match_jax(arch):
    jc, tc = jcfg.get_arch(arch), tcfg.get_arch(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert (dataclasses.asdict(tcfg.smoke_config(tc))
            == dataclasses.asdict(jcfg.smoke_config(jc)))
    for shape in jcfg.SHAPES:
        assert tcfg.shape_applicable(tc, shape) == jcfg.shape_applicable(
            jc, shape)


def test_registry_matches_jax():
    assert sorted(tcfg.ARCHS) == sorted(jcfg.ARCHS)
    assert tcfg.SHAPES == jcfg.SHAPES
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_arch("gpt-2")


def test_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.smoke_config(tcfg.get_arch("qwen3-4b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(512, 2, 8).batch_at(0)


def test_token_pipeline():
    """Deterministic per (seed, step) and per (seed, step, shard); labels
    are the tokens rolled left by one; int32 tokens in [0, vocab)."""
    pipe = TokenPipeline(vocab_size=97, global_batch=4, seq_len=12, seed=3)
    a, b = pipe.batch_at(5, "cpu"), pipe.batch_at(5, "cpu")
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 12)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], pipe.batch_at(6, "cpu")["tokens"])
    assert not torch.equal(
        a["tokens"], dataclasses.replace(pipe, seed=4).batch_at(5, "cpu")
        ["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97
    s1 = pipe.shard_batch_at(5, 1, 2, "cpu")
    assert s1["tokens"].shape == (2, 12)
    assert torch.equal(s1["tokens"], pipe.shard_batch_at(5, 1, 2, "cpu")
                       ["tokens"])
    assert not torch.equal(s1["tokens"],
                           pipe.shard_batch_at(5, 0, 2, "cpu")["tokens"])
    assert torch.equal(s1["labels"], torch.roll(s1["tokens"], -1, dims=1))
    with pytest.raises(ValueError, match="does not split"):
        pipe.shard_batch_at(5, 0, 3, "cpu")


def test_shard_rows_are_not_slice_rows_in_either_package():
    """A shard's rows are a stream of their own, not a slice of the
    global batch: so in the JAX package too, whose shard_batch_at
    docstring says otherwise."""
    pipe = TokenPipeline(vocab_size=512, global_batch=4, seq_len=8, seed=0)
    jpipe = JaxTokenPipeline(vocab_size=512, global_batch=4, seq_len=8,
                             seed=0)
    assert not torch.equal(pipe.shard_batch_at(3, 1, 2, "cpu")["tokens"],
                           pipe.batch_at(3, "cpu")["tokens"][2:4])
    assert not np.array_equal(
        np.asarray(jpipe.shard_batch_at(3, 1, 2)["tokens"]),
        np.asarray(jpipe.batch_at(3)["tokens"])[2:4])
