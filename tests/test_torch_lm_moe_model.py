"""The port's MoE models (granite's GQA + MoE, deepseek-v2's MLA + MoE
with a shared expert) and the serving launcher's default, held to the
JAX package on the CPU at ``smoke_config`` size (capacity factor 4.0:
no pair drops).

JAX parameters come from ``repro.models.model.init`` (norm scales then
perturbed from a numpy seed) and cross by
``convert.lm_params_from_numpy``.  The prompt is numpy's; each decode
step feeds both packages JAX's argmax.  Bars, beside the largest value
measured on this CPU over the two configurations:
  * f32 (``COMPUTE_DTYPE`` patched to float32 in both packages): prefill
    logits 1e-4 (1.2e-5), four decode steps 5e-3 (4.8e-5; the cache is
    bf16 in both packages), train_loss with its aux term, xent and aux
    1e-4 each (4.8e-7); the caches after prefill within one bf16 step of
    JAX's on under 1 % of entries (0.07 %);
  * bf16: logits and the loss terms at rtol = atol = 6e-2, the JAX
    package's own prefill-vs-decode bar, with argmax equal wherever
    JAX's top two logits are further apart than twice that bar.  At the
    whole smoke depth (4 layers) the prefill logits read 0.92 of the bar
    and the loss 0.005; the decode steps are held at the first
    BF16_DEPTH = 2 layers (0.80 of the bar).  At 4 layers two libraries'
    bf16 rounding moves decode rows by up to 1.25 of the bar with the
    same routing, and a near-tied router (top-k margin 6e-4) routes a
    token to another expert in one package, which moves its row by 56
    times the bar; JAX's bf16 run is no closer to its own f32 run (1.2
    to 2.2 of the bar, 48 at that flip) than the port's (ROADMAP C).
"""
import argparse
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
F32_TOL = 1e-4
DECODE_F32_TOL = 5e-3
BF16_TOL = 6e-2
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-5
BATCH, PROMPT, STEPS, LOSS_SEQ = 2, 12, 4, 520
# bf16 decode steps are held at the first two layers (see the docstring)
BF16_DEPTH = 2


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
        out[key] = value.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def trees():
    return {arch: _perturbed(jax.jit(jmodel.init, static_argnums=1)(
        jax.random.PRNGKey(1), _configs(arch)[0]), np.random.default_rng(i))
            for i, arch in enumerate(ARCHS)}


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _cache_fields(cfg):
    return ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")


def _f64(a) -> np.ndarray:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor)
                   else a.astype(jnp.float32))
    return a.astype(np.float64)


def _serve_both(arch, tree, depth=None, steps=STEPS, loss=True):
    """Prefill, ``steps`` decode steps fed JAX's argmax, and (with
    ``loss``) the loss, in both packages, optionally cut to the first
    ``depth`` layers: (jax outputs, port outputs), each a dict of logits
    (prefill, then the steps), the caches after prefill, the loss, xent
    and aux."""
    jc, tc = _configs(arch)
    if depth is not None:
        jc = dataclasses.replace(jc, num_layers=depth)
        tc = dataclasses.replace(tc, num_layers=depth)
        tree = {**tree, "layers": jax.tree.map(lambda a: a[:depth],
                                               tree["layers"])}
    batch = _batch(jc, BATCH, PROMPT, seed=7)
    loss_batch = _batch(jc, 1, LOSS_SEQ, seed=8)
    p = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tc, tree, device="cpu")
    max_seq = PROMPT + steps
    fields = _cache_fields(tc)

    prefill = jax.jit(lambda p, b: jmodel.prefill(p, jc, b, max_seq=max_seq))
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
    logits, state = prefill(p, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {"logits": [np.asarray(logits)],
            "caches": [_f64(getattr(state.caches, f)) for f in fields]}
    fed = []
    for _ in range(steps):
        fed.append(np.argmax(want["logits"][-1], -1)[:, None].astype(np.int32))
        logits, state = decode(p, state, jnp.asarray(fed[-1]))
        want["logits"].append(np.asarray(logits))
    if loss:
        value, metrics = jax.jit(lambda p, b: jmodel.train_loss(p, jc, b))(
            p, {k: jnp.asarray(v) for k, v in loss_batch.items()})
        want.update(loss=float(value), xent=float(metrics["xent"]),
                    aux=float(metrics["aux"]))

    with torch.no_grad():
        logits, st = model.prefill(
            {"tokens": torch.from_numpy(batch["tokens"])}, max_seq=max_seq)
        got = {"logits": [logits.numpy()],
               "caches": [_f64(torch.stack([getattr(c, f) for c in st.caches]))
                          for f in fields]}
        for tok in fed:
            logits, st = model.decode_step(st, torch.from_numpy(tok))
            got["logits"].append(logits.numpy())
        if loss:
            value, metrics = model.train_loss(
                {k: torch.from_numpy(v) for k, v in loss_batch.items()})
            got.update(loss=float(value), xent=float(metrics["xent"]),
                       aux=float(metrics["aux"]))
    return want, got


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Names and shapes of the port's parameters, restacked, are JAX's
    tree (the MoE tree with its stacked (L, e, d, f) experts, deepseek's
    MLA and shared expert); the tree goes across and back unchanged."""
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
    assert "layers/moe/w_gate" in want
    assert ("layers/attn/w_kv_up" in want) == tc.use_mla
    assert ("layers/moe/shared/w_down" in want) == bool(tc.num_shared_experts)
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tc, tree, device="cpu"))
    assert shapes(back) == want
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_matches_jax(arch, trees, f32):
    want, got = _serve_both(arch, trees[arch])
    assert np.max(np.abs(want["logits"][0] - got["logits"][0])) <= F32_TOL
    for a, b in zip(want["logits"][1:], got["logits"][1:]):
        assert np.max(np.abs(a - b)) <= DECODE_F32_TOL
    for name in ("loss", "xent", "aux"):
        assert abs(want[name] - got[name]) <= F32_TOL, name
    assert got["aux"] > 0
    assert abs(got["loss"] - (got["xent"] + 0.01 * got["aux"])) <= 1e-6
    for a, b in zip(want["caches"], got["caches"]):
        np.testing.assert_allclose(b, a, rtol=CACHE_RTOL, atol=CACHE_ATOL)
        assert np.mean(a != b) < 0.01


def _argmax_equal_where_decided(want, got, tol):
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * (tol + tol * np.abs(top2[:, 1]))
    assert np.array_equal(np.argmax(want, -1)[decided],
                          np.argmax(got, -1)[decided])


def _held_bf16(want, got):
    for a, b in zip(want["logits"], got["logits"]):
        np.testing.assert_allclose(b, a, rtol=BF16_TOL, atol=BF16_TOL)
        _argmax_equal_where_decided(a, b, BF16_TOL)
    for name in ("loss", "xent", "aux"):
        if name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(arch, trees):
    """The whole smoke depth's prefill and loss terms, and BF16_DEPTH
    layers' prefill and decode steps, at the bar."""
    _held_bf16(*_serve_both(arch, trees[arch], steps=0))
    _held_bf16(*_serve_both(arch, trees[arch], depth=BF16_DEPTH,
                            loss=False))


def test_train_loss_aux_weight(trees):
    """train_loss(batch, aux_weight) returns xent + aux_weight * aux."""
    _, tc = _configs(ARCHS[0])
    model = convert.lm_params_from_numpy(tc, trees[ARCHS[0]], device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tc, 1, 16, seed=9).items()}
    with torch.no_grad():
        loss0, m0 = model.train_loss(batch, aux_weight=0.0)
        loss1, m1 = model.train_loss(batch, aux_weight=1.0)
    assert float(loss0) == float(m0["xent"]) == float(m1["xent"])
    assert float(loss1) == float(m1["xent"] + m1["aux"])


def test_serve_shell_defaults_to_granite():
    """``python -m repro_torch.launch.serve --smoke --device cpu`` with no
    --arch serves granite-moe-1b-a400m, the JAX launcher's default."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3, out.stdout
    gen = ast.literal_eval(lines[2].removeprefix("generated: "))
    args = argparse.Namespace(
        arch="granite-moe-1b-a400m", smoke=True, batch=2, prompt_len=16,
        gen=4, seed=0)
    with torch.no_grad():
        want = tserve.serve(args, torch.device("cpu"))
    assert gen == want.tolist()
