"""The port's SSM (mamba2), hybrid (zamba2, one weight-shared attention
block) and enc-dec (whisper) models, held to the JAX package on the CPU at
``smoke_config`` size: mamba2 4 SSM layers; zamba2 5 layers at
attn_every 3 (one group of 2 SSM layers and the shared block, then 2
trailing SSM layers); whisper 2 encoder layers over 16 stub frames and 4
decoder layers.

JAX parameters come from ``repro.models.model.init`` (norm scales and the
SSM constants a_log, d_skip, dt_bias then perturbed from a numpy seed)
and cross by ``convert.lm_params_from_numpy``.  The prompt and the
frames are numpy's; each decode step feeds both packages JAX's argmax.
The f32 runs patch ``COMPUTE_DTYPE`` in both packages' ``layers`` and in
JAX's ``model``, which imports it by name for the whisper encoder.  Bars,
beside the largest value measured on this CPU over the three
configurations:
  * f32: prefill logits 1e-4 (2.7e-6), four decode steps 5e-3 (5.5e-4:
    the bf16 conv windows and KV cache round an f32 value that differs
    in its last bits), the loss 1e-4 (4.8e-7); the SSM states after
    prefill 1e-4 of their largest entry (1.2e-6), the conv windows and
    KV caches within one bf16 step of JAX's on under 1 % of entries
    (0.05 %); whisper's cross K/V 1e-5 of their largest entry (6.0e-7);
  * bf16: logits and the loss at rtol = atol = 6e-2, the JAX package's
    prefill-vs-decode bar, with argmax equal wherever JAX's top two
    logits are further apart than twice that bar: mamba2 0.89 of the
    bar, whisper 0.40, zamba2's prefill 0.79.  zamba2's decode steps are
    held at BF16_DECODE_DEPTH = 3 layers (one group: 2 SSM layers and
    the shared block; 0.71 there): at its 5 layers one of 1,024 logits
    of the fourth step reads 1.10 of the bar with the same fed tokens,
    while f32 agrees to 2.6e-4, and ``repro``'s bf16 is 0.94 from its own
    f32 against the port's 1.14 (ROADMAP C);
  * the port of tests/test_arch_smoke.py's prefill-vs-decode test for
    the SSM families keeps its 6e-2.
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
from repro.launch import serve as jserve
from repro.models import frontends as jfront
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-2.7b", "zamba2-1.2b", "whisper-small"]
F32_TOL = 1e-4
DECODE_F32_TOL = 5e-3
BF16_TOL = 6e-2
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-5
BATCH, PROMPT, STEPS, LOSS_SEQ = 2, 12, 4, 520
# bf16 decode steps held at one group of the hybrid (see the docstring)
BF16_DECODE_DEPTH = {"zamba2-1.2b": 3}
# perturbed so that they are not their init constants
_PERTURBED = ("scale", "a_log", "d_skip", "dt_bias", "conv_b_x", "conv_b_bc")


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
        elif key in _PERTURBED:
            value = value + 0.1 * rng.standard_normal(value.shape)
        out[key] = value.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, _ = _configs(arch)
            cache[arch] = _perturbed(
                jax.jit(jmodel.init, static_argnums=1)(
                    jax.random.PRNGKey(1), jc),
                np.random.default_rng(ARCHS.index(arch)))
        return cache[arch]

    return get


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "encdec":
        out["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "frames"
            else jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).bfloat16() if k == "frames"
            else torch.from_numpy(v) for k, v in batch.items()}


def _f64(a) -> np.ndarray:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor)
                   else a.astype(jnp.float32))
    return a.astype(np.float64)


def _state_arrays(state, jax_side: bool) -> dict:
    """The serving state after prefill as {name: f64 array}, the layers
    stacked on axis 0: SSM state and windows, KV caches, cross K/V."""
    out = {}
    if jax_side:
        caches, attn, cross = state.caches, state.attn_caches, state.cross_kv
        for name in ("state", "conv_x", "conv_bc", "k", "v"):
            if hasattr(caches, name):
                out[name] = _f64(getattr(caches, name))
        if attn is not None:
            out["attn_k"], out["attn_v"] = _f64(attn.k), _f64(attn.v)
        if cross is not None:
            out["cross_k"], out["cross_v"] = _f64(cross[0]), _f64(cross[1])
        return out

    def stacked(items, name):
        return _f64(torch.stack([getattr(c, name) for c in items]))

    for name in ("state", "conv_x", "conv_bc", "k", "v"):
        if hasattr(state.caches[0], name):
            out[name] = stacked(state.caches, name)
    if state.attn_caches is not None:
        out["attn_k"] = stacked(state.attn_caches, "k")
        out["attn_v"] = stacked(state.attn_caches, "v")
    if state.cross_kv is not None:
        out["cross_k"] = _f64(torch.stack([k for k, _ in state.cross_kv]))
        out["cross_v"] = _f64(torch.stack([v for _, v in state.cross_kv]))
    return out


def _cut(tree, tc, depth):
    """The tree of the first ``depth`` layers of tc's family."""
    if tc.family != "hybrid":
        return {**tree, "layers": jax.tree.map(lambda a: a[:depth],
                                               tree["layers"])}
    n_ssm = depth // tc.attn_every * (tc.attn_every - 1) \
        + depth % tc.attn_every
    return {**tree, "ssm_layers": jax.tree.map(lambda a: a[:n_ssm],
                                               tree["ssm_layers"])}


def _serve_both(arch, tree, depth=None, fed=None, steps=STEPS, loss=True):
    """Prefill, ``steps`` decode steps fed JAX's argmax (or ``fed``), and
    (with ``loss``) the loss, in both packages, optionally cut to the
    first ``depth`` layers:
    (jax outputs, port outputs), each a dict of logits (prefill, then the
    steps), the state after prefill, the loss, and the tokens fed."""
    jc, tc = _configs(arch)
    if depth is not None:
        jc = dataclasses.replace(jc, num_layers=depth)
        tc = dataclasses.replace(tc, num_layers=depth)
        tree = _cut(tree, tc, depth)
    batch = _batch(jc, BATCH, PROMPT, seed=7)
    loss_batch = _batch(jc, 1, LOSS_SEQ, seed=8)
    p = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tc, tree, device="cpu")
    max_seq = PROMPT + steps

    prefill = jax.jit(lambda p, b: jmodel.prefill(p, jc, b, max_seq=max_seq))
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))
    logits, state = prefill(p, _jax_batch(batch))
    want = {"logits": [np.asarray(logits)],
            "state": _state_arrays(state, jax_side=True)}
    fed = [] if fed is None else list(fed)
    for i in range(steps):
        if len(fed) == i:
            fed.append(np.argmax(want["logits"][-1], -1)[:, None]
                       .astype(np.int32))
        logits, state = decode(p, state, jnp.asarray(fed[i]))
        want["logits"].append(np.asarray(logits))
    want["fed"] = fed
    if loss:
        want["loss"] = float(jax.jit(
            lambda p, b: jmodel.train_loss(p, jc, b)[0])(
                p, _jax_batch(loss_batch)))

    with torch.no_grad():
        logits, st = model.prefill(_torch_batch(batch), max_seq=max_seq)
        got = {"logits": [logits.numpy()],
               "state": _state_arrays(st, jax_side=False)}
        for tok in fed:
            logits, st = model.decode_step(st, torch.from_numpy(tok))
            got["logits"].append(logits.numpy())
        if loss:
            got["loss"] = float(model.train_loss(_torch_batch(loss_batch))[0])
    return want, got


def _shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(value.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Names and shapes of the port's parameters, restacked, are JAX's
    tree (ssm_layers and the one unstacked shared_attn of the hybrid,
    enc_layers, enc_norm and the cross layers of whisper); the tree goes
    across and back unchanged."""
    jc, tc = _configs(arch)
    want = _shapes(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                      jc)))
    tree = convert.lm_params_to_numpy(Model(tc, device="cpu"))
    assert _shapes(tree) == want
    stacks = {name.split("/")[0] for name in want}
    assert stacks >= {"ssm": {"layers"}, "hybrid": {"ssm_layers",
                                                    "shared_attn"},
                      "encdec": {"layers", "enc_layers",
                                 "enc_norm"}}[tc.family]
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tc, tree, device="cpu"))
    assert _shapes(back) == want
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_shared_block_appears_once():
    """zamba2's attention block is one module: its parameters appear once
    (shared_attn.*, unstacked, as in JAX's tree), and every group runs
    that one block with the group's own KV cache."""
    jc, tc = _configs("zamba2-1.2b")
    model = Model(tc, device="cpu")
    shared = [n for n, _ in model.named_parameters()
              if n.startswith("shared_attn.")]
    want = _shapes(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                      jc))["shared_attn"])
    assert len(shared) == len(want)
    assert tuple(model.shared_attn.attn["wq"].shape) == want["attn/wq"]
    runs = [(blk, field, i) for blk, field, i in model._blocks()
            if blk is model.shared_attn]
    n_groups = tc.num_layers // tc.attn_every
    assert [(f, i) for _, f, i in runs] == [("attn_caches", g)
                                           for g in range(n_groups)]
    assert len(model.init_caches(1, 8).attn_caches) == n_groups


def test_convert_keeps_shared_attn_unstacked(trees):
    """A stacked shared_attn, a missing SSM stack and a wrong SSM leaf are
    refused."""
    _, tc = _configs("zamba2-1.2b")
    tree = trees("zamba2-1.2b")
    stacked = {**tree, "shared_attn": jax.tree.map(
        lambda a: np.stack([a, a]), tree["shared_attn"])}
    with pytest.raises(ValueError, match="shared_attn.*: shape"):
        convert.lm_params_from_numpy(tc, stacked, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ssm_layers"}
    with pytest.raises(KeyError, match="missing.*ssm_layers.0.ssm.w_zx"):
        convert.lm_params_from_numpy(tc, missing, device="cpu")
    ssm = tree["ssm_layers"]["ssm"]
    bad = {**tree, "ssm_layers": {**tree["ssm_layers"], "ssm": {
        **ssm, "a_log": ssm["a_log"][:, :-1]}}}
    with pytest.raises(ValueError, match="ssm_layers.0.ssm.a_log: shape"):
        convert.lm_params_from_numpy(tc, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_matches_jax(arch, trees, f32):
    want, got = _serve_both(arch, trees(arch))
    assert np.max(np.abs(want["logits"][0] - got["logits"][0])) <= F32_TOL
    for a, b in zip(want["logits"][1:], got["logits"][1:]):
        assert np.max(np.abs(a - b)) <= DECODE_F32_TOL
    assert abs(want["loss"] - got["loss"]) <= F32_TOL
    assert want["state"].keys() == got["state"].keys()
    for name, a in want["state"].items():
        b = got["state"][name]
        assert a.shape == b.shape, name
        if name == "state":
            assert np.max(np.abs(a - b)) <= F32_TOL * np.max(np.abs(a))
        elif name.startswith("cross"):
            assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(a))
        else:
            np.testing.assert_allclose(b, a, rtol=CACHE_RTOL, atol=CACHE_ATOL,
                                       err_msg=name)
            assert np.mean(a != b) < 0.01, name


def _argmax_equal_where_decided(want, got, tol):
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * (tol + tol * np.abs(top2[:, 1]))
    assert np.array_equal(np.argmax(want, -1)[decided],
                          np.argmax(got, -1)[decided])


def _held_bf16(want, got):
    for a, b in zip(want["logits"], got["logits"]):
        np.testing.assert_allclose(b, a, rtol=BF16_TOL, atol=BF16_TOL)
        _argmax_equal_where_decided(a, b, BF16_TOL)
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=BF16_TOL,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(arch, trees):
    """The whole smoke depth's prefill, decode steps and loss; zamba2's
    decode steps at BF16_DECODE_DEPTH (see the docstring)."""
    depth = BF16_DECODE_DEPTH.get(arch)
    _held_bf16(*_serve_both(arch, trees(arch),
                            steps=STEPS if depth is None else 0))
    if depth is not None:
        _held_bf16(*_serve_both(arch, trees(arch), depth=depth, loss=False))
    if arch == "whisper-small":  # the cross K/V stay in the compute dtype
        _, st = convert.lm_params_from_numpy(
            _configs(arch)[1], trees(arch), device="cpu").prefill(
                _torch_batch(_batch(_configs(arch)[0], 1, 4, seed=9)))
        assert {k.dtype for k, _ in st.cross_kv} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_prefill_matches_decode_ssm(arch, trees):
    """Port of tests/test_arch_smoke.py's test: a chunked SSD prefill of 8
    tokens, and decoding the same 8 tokens one by one from empty caches,
    give the same last logits (bf16)."""
    _, tc = _configs(arch)
    model = convert.lm_params_from_numpy(tc, trees(arch), device="cpu")
    toks = torch.from_numpy(_batch(tc, 1, 8, seed=3)["tokens"])
    logits_a, _ = model.prefill({"tokens": toks}, max_seq=10)
    state = model.init_caches(1, 10)
    for t in range(8):
        logits_b, state = model.decode_step(state, toks[:, t:t + 1])
    torch.testing.assert_close(logits_a, logits_b, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_short_prompt_raises(arch):
    """A prompt shorter than ssm_conv - 1 = 3 is refused at the prefill
    (the JAX package fails at the next decode step,
    tests/test_torch_lm_ssm.py); 3 tokens serve."""
    _, tc = _configs(arch)
    model = Model(tc, device="cpu")
    with pytest.raises(ValueError, match="shorter than the SSM conv window"):
        model.prefill({"tokens": torch.zeros((1, 2), dtype=torch.int32)})
    logits, st = model.prefill({"tokens": torch.zeros((1, 3),
                                                      dtype=torch.int32)},
                               max_seq=4)
    model.decode_step(st, logits.argmax(-1, keepdim=True))
    assert st.caches[0].length == 4


def test_ssm_cache_bytes_do_not_grow_with_the_context():
    """mamba2's serving state holds the same bytes after 4 and 40 tokens
    (and for any max_seq): O(1) in the context's length."""
    _, tc = _configs("mamba2-2.7b")
    model = Model(tc, device="cpu")

    def nbytes(s):
        _, st = model.prefill({"tokens": torch.zeros((2, s),
                                                     dtype=torch.int32)},
                              max_seq=s + 1000)
        return sum(t.numel() * t.element_size() for c in st.caches
                   for t in (c.state, c.conv_x, c.conv_bc))

    assert nbytes(4) == nbytes(40)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_cpu(arch, trees):
    """launch.serve's generate serves each family on the CPU: greedy
    tokens, the argmax of the logits before them, equal to a prefill and
    decode steps run by hand."""
    jc, tc = _configs(arch)
    model = convert.lm_params_from_numpy(tc, trees(arch), device="cpu")
    batch = _torch_batch(_batch(jc, BATCH, PROMPT, seed=10))
    del batch["labels"]
    out = tserve.generate(model, batch, STEPS)
    assert out.tokens.shape == (BATCH, STEPS) and len(out.logits) == STEPS + 1
    for i, logits in enumerate(out.logits[:-1]):
        assert torch.equal(out.tokens[:, i], logits.argmax(-1))
    logits, st = model.prefill(batch, max_seq=PROMPT + STEPS)
    torch.testing.assert_close(logits, out.logits[0], rtol=0, atol=0)
    for i in range(STEPS):
        logits, st = model.decode_step(st, out.tokens[:, i:i + 1])
        torch.testing.assert_close(logits, out.logits[i + 1], rtol=0, atol=0)


def test_generate_matches_jax_serve(f32, monkeypatch, capsys):
    """generate from the JAX launcher's own whisper parameters, prompt and
    stub frames gives its tokens."""
    args = argparse.Namespace(arch="whisper-small", smoke=True, batch=2,
                              prompt_len=8, gen=4, seed=0)
    drawn = []
    init = jmodel.init
    monkeypatch.setattr(jmodel, "init",
                        lambda *a: drawn.append(init(*a)) or drawn[-1])
    want = jserve.serve(args)
    jc, tc = _configs(args.arch)
    key = jax.random.PRNGKey(args.seed)
    toks = jax.random.randint(jax.random.fold_in(key, 1),
                              (args.batch, args.prompt_len), 0, jc.vocab_size)
    frames = jfront.synthetic_frontend(jax.random.fold_in(key, 2), jc,
                                       args.batch)["frames"]
    batch = {"tokens": torch.from_numpy(np.array(toks)),
             "frames": torch.from_numpy(np.array(
                 frames.astype(jnp.float32))).bfloat16()}
    model = convert.lm_params_from_numpy(
        tc, jax.tree.map(np.asarray, drawn[0]), device="cpu")
    out = tserve.generate(model, batch, args.gen)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    capsys.readouterr()


def test_serve_shell_serves_whisper_on_cpu():
    """``python -m repro_torch.launch.serve --arch whisper-small --smoke
    --device cpu`` draws the stub frames and serves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-small", "--smoke", "--device", "cpu", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3, out.stdout
    gen = ast.literal_eval(lines[2].removeprefix("generated: "))
    assert np.asarray(gen).shape == (2, 4)


@pytest.mark.parametrize("arch", sorted(tcfg.ARCHS))
def test_every_registry_config_serves(arch):
    """Model builds every configuration of the registry (smoke size) on
    the CPU, and one prefill and one decode step give finite logits."""
    jc, tc = _configs(arch)
    model = Model(tc, device="cpu")
    batch = _torch_batch(_batch(jc, 1, 4, seed=11))
    del batch["labels"]
    logits, st = model.prefill(batch, max_seq=5)
    step, _ = model.decode_step(st, logits.argmax(-1, keepdim=True))
    assert logits.shape == step.shape == (1, tc.vocab_size)
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
