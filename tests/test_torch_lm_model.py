"""The port's dense/vlm language model and its serving launcher, held to the
JAX package on the CPU at ``smoke_config`` size.

JAX parameters come from ``repro.models.model.init`` (norm scales and
QKV biases then perturbed from a numpy seed, so that they are not 1 and
0) and cross by ``convert.lm_params_from_numpy``.  The prompt is numpy's;
each decode step feeds both packages JAX's argmax.  Bars, with the
largest value measured on this CPU over the five configurations:

  * f32 (``COMPUTE_DTYPE`` patched to float32 in both packages):
    prefill logits 1e-4 (3.6e-6); train_loss at s = 520, past its chunk
    of 512, 1e-4 (4.8e-7); the caches within one bf16 step (int8: one
    integer) of JAX's on under 1 % of entries (0.10 %; int8 0);
    four decode steps 5e-3 (4.0e-4).  The decode bar is wider because
    the K/V cache is bf16 (or int8) in both packages: an f32 value a few
    ulps from a rounding boundary of the cache lands on neighbouring
    cache values in the two packages.  Over 16 prompts a configuration
    such flips put the decode logits up to 2.4e-3 apart (qwen1.5-32b's
    int8 cache), 4 of the 80 above 1e-3; a wrong position, mask or
    scale moves them by 1e-1 or more;
  * bf16: prefill and decode logits and the loss at rtol = atol = 6e-2,
    the JAX package's own prefill-vs-decode bar (largest |diff| / (atol
    + rtol |want|) 0.86, loss 0.002); argmax equal wherever JAX's top
    two logits are further apart than twice that bar, which is where
    the bar decides the argmax (1 of the 50 rows flips, at a near-tie;
    over 16 prompts a configuration about one row in ten does).
"""
import argparse
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-4b", "qwen1.5-32b", "starcoder2-15b", "minitron-8b",
         "llava-next-mistral-7b"]
F32_TOL = 1e-4
DECODE_F32_TOL = 5e-3
BF16_TOL = 6e-2
# a bf16 cache entry may round to a neighbour of JAX's, 2^-8 .. 2^-7 of its
# magnitude away; where cancellation left the f32 value near zero, a few
# of its (tiny) steps (measured excess over the rtol 7.6e-7)
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-5
BATCH, PROMPT, STEPS, LOSS_SEQ = 2, 12, 4, 520


def _configs(arch):
    return (jcfg.smoke_config(jcfg.get_arch(arch)),
            tcfg.smoke_config(tcfg.get_arch(arch)))


def _perturbed(tree, rng):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturbed(value, rng)
            continue
        value = np.asarray(value)
        if key == "scale":
            value = value * (1 + 0.1 * rng.standard_normal(value.shape))
        elif key in ("bq", "bk", "bv"):
            value = 0.1 * rng.standard_normal(value.shape)
        out[key] = value.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, _ = _configs(arch)
            cache[arch] = _perturbed(
                jmodel.init(jax.random.PRNGKey(1), jc),
                np.random.default_rng(ARCHS.index(arch)))
        return cache[arch]

    return get


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        out["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patch_tokens, cfg.d_model))).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "patches"
            else jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).bfloat16() if k == "patches"
            else torch.from_numpy(v) for k, v in batch.items()}


def _cache_np(a) -> np.ndarray:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor)
                   else a.astype(jnp.float32))
    return a.astype(np.float64)


def _serve_both(arch, tree):
    """Prefill, STEPS decode steps fed JAX's argmax, and the loss, in
    both packages: (jax outputs, port outputs), each a dict of logits
    (prefill, then the steps), caches after prefill, and the loss."""
    jc, tc = _configs(arch)
    batch = _batch(jc, BATCH, PROMPT, seed=7)
    loss_batch = _batch(jc, 1, LOSS_SEQ, seed=8)
    p = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tc, tree, device="cpu")
    max_seq = PROMPT + STEPS

    prefill = jax.jit(lambda p, b: jmodel.prefill(p, jc, b, max_seq=max_seq))
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
    logits, state = prefill(p, _jax_batch(batch))
    want = {"logits": [np.asarray(logits)],
            "caches": [None if a is None else np.asarray(a)
                       if a.dtype == jnp.int8 else _cache_np(a)
                       for a in state.caches[:4]]}
    fed = []
    for _ in range(STEPS):
        fed.append(np.argmax(want["logits"][-1], -1)[:, None].astype(np.int32))
        logits, state = decode(p, state, jnp.asarray(fed[-1]))
        want["logits"].append(np.asarray(logits))
    want["loss"] = float(jmodel.train_loss(p, jc, _jax_batch(loss_batch))[0])

    with torch.no_grad():
        logits, st = model.prefill(_torch_batch(batch), max_seq=max_seq)
        caches = [torch.stack([getattr(c, name) for c in st.caches])
                  if getattr(st.caches[0], name) is not None else None
                  for name in ("k", "v", "k_scale", "v_scale")]
        got = {"logits": [logits.numpy()],
               "caches": [None if a is None else a.numpy()
                          if a.dtype == torch.int8 else _cache_np(a)
                          for a in caches]}
        for tok in fed:
            logits, st = model.decode_step(st, torch.from_numpy(tok))
            got["logits"].append(logits.numpy())
        got["loss"] = float(model.train_loss(_torch_batch(loss_batch))[0])
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Names and shapes of the port's parameters, restacked, are JAX's
    tree; the tree goes across and back unchanged."""
    jc, tc = _configs(arch)

    def shapes(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out.update(shapes(value, f"{prefix}{key}/"))
            else:
                out[prefix + key] = tuple(value.shape)
        return out

    want = shapes(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                     jc)))
    tree = convert.lm_params_to_numpy(Model(tc, device="cpu"))
    assert shapes(tree) == want
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tc, tree, device="cpu"))
    assert shapes(back) == want
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_lm_params_from_numpy_rejects_a_wrong_tree(trees):
    _, tc = _configs("qwen3-4b")
    tree = trees("qwen3-4b")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="missing.*final_norm.scale"):
        convert.lm_params_from_numpy(tc, missing, device="cpu")
    extra = {**tree, "enc_norm": {"scale": tree["final_norm"]["scale"]}}
    with pytest.raises(KeyError, match="extra.*enc_norm.scale"):
        convert.lm_params_from_numpy(tc, extra, device="cpu")
    bad = {**tree, "embed": {"table": tree["embed"]["table"][:, :64]}}
    with pytest.raises(ValueError, match="embed.table: shape"):
        convert.lm_params_from_numpy(tc, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_matches_jax(arch, trees, f32):
    want, got = _serve_both(arch, trees(arch))
    assert np.max(np.abs(want["logits"][0] - got["logits"][0])) <= F32_TOL
    for a, b in zip(want["logits"][1:], got["logits"][1:]):
        assert np.max(np.abs(a - b)) <= DECODE_F32_TOL
    assert abs(want["loss"] - got["loss"]) <= F32_TOL
    for name, a, b in zip(("k", "v", "k_scale", "v_scale"), want["caches"],
                          got["caches"]):
        if name.endswith("scale"):
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
            continue
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=CACHE_RTOL, atol=CACHE_ATOL)
        assert np.mean(a != b) < 0.01


def _argmax_equal_where_decided(want, got, tol):
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * (tol + tol * np.abs(top2[:, 1]))
    assert np.array_equal(np.argmax(want, -1)[decided],
                          np.argmax(got, -1)[decided])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(arch, trees):
    want, got = _serve_both(arch, trees(arch))
    for a, b in zip(want["logits"], got["logits"]):
        np.testing.assert_allclose(b, a, rtol=BF16_TOL, atol=BF16_TOL)
        _argmax_equal_where_decided(a, b, BF16_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_generate_matches_jax_serve(f32, capsys):
    """launch.serve's generate from the JAX launcher's own parameters and
    prompt gives its tokens."""
    args = argparse.Namespace(arch="qwen3-4b", smoke=True, batch=2,
                              prompt_len=16, gen=8, seed=0)
    want = jserve.serve(args)
    jc, tc = _configs(args.arch)
    key = jax.random.PRNGKey(args.seed)
    params = jax.tree.map(np.asarray, jmodel.init(key, jc))
    toks = jax.random.randint(jax.random.fold_in(key, 1),
                              (args.batch, args.prompt_len), 0, jc.vocab_size)
    model = convert.lm_params_from_numpy(tc, params, device="cpu")
    out = tserve.generate(model, {"tokens": torch.from_numpy(
        np.array(toks))}, args.gen)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    assert len(out.logits) == args.gen + 1
    capsys.readouterr()


def _shell(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_serve_shell_on_cpu():
    out = _shell("--arch", "qwen3-4b", "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3, out.stdout
    assert re.fullmatch(r"prefill 16 toks x2: [\d.]+ ms", lines[0])
    assert re.fullmatch(r"decode 8 steps: [\d.]+ ms \([\d.]+ tok/s\)",
                        lines[1])
    gen = ast.literal_eval(lines[2].removeprefix("generated: "))
    assert np.asarray(gen).shape == (2, 8)


def test_serve_shell_without_card_exits_with_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _shell("--arch", "qwen3-4b", "--smoke")
    assert out.returncode == 2
    assert out.stdout == ""
    assert "device='cpu'" in out.stderr
