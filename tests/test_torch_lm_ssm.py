"""The port's Mamba2 (SSD) mixer held to the JAX package's on the CPU at
``smoke_config(mamba2-2.7b)`` size (d_model 128, 16 heads of 16, state 16,
chunk 16), from the same numpy inputs and from JAX's ``init_ssm``
parameters carried across.

Bars, with the largest value measured on this CPU:
  * ``_segsum`` and ``_ssd_chunked`` in f32: 1e-5 of the largest output
    (2.5e-7 at most); the -inf above ``_segsum``'s diagonal exactly;
  * ``ssm_train`` / ``ssm_prefill`` / ``ssm_decode`` in f32: 1e-4 (the
    smoke configs' prefill bar of tests/test_torch_lm_model.py; the
    outputs 1.9e-6, the state 4.9e-9 of its largest entry); the bf16
    conv windows within one bf16 step of JAX's on under 1 % of entries
    (the f32 value each is rounded from differs in its last bits: none
    differ at this seed); decode steps and the sequential oracle 5e-3,
    the decode bar of the LM tests (3.1e-6, 2.4e-6);
  * the ports of tests/test_models_unit.py's sequential-oracle and
    chunk-size-invariance tests keep their 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import ssm as jssm
from repro_torch import configs as tcfg
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Params

REL = 1e-5
F32_TOL = 1e-4
DECODE_F32_TOL = 5e-3
ORACLE_TOL = 2e-2
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-5
ARCH = "mamba2-2.7b"


def _configs():
    return (jcfg.smoke_config(jcfg.get_arch(ARCH)),
            tcfg.smoke_config(tcfg.get_arch(ARCH)))


def _jax_init(jc):
    return jax.jit(jssm.init_ssm, static_argnums=1)(jax.random.PRNGKey(0), jc)


def _port(tree) -> Params:
    return Params(**{k: _port(v) if isinstance(v, dict)
                     else torch.from_numpy(np.array(v, np.float32))
                     for k, v in tree.items()})


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def params():
    """JAX's init_ssm with every leaf perturbed (so that a_log, d_skip,
    dt_bias, the biases and the norm scale are not their constants):
    (numpy tree, JAX tree, the port's Params)."""
    jc, _ = _configs()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), _jax_init(jc))
    return tree, jax.tree.map(jnp.asarray, tree), _port(tree)


@pytest.fixture(scope="module")
def jfns():
    """JAX's mixer functions at the smoke config, jitted (eager JAX takes
    seconds a call here)."""
    jc, _ = _configs()
    return {"train": jax.jit(lambda p, x: jssm.ssm_train(p, jc, x)),
            "prefill": jax.jit(lambda p, x: jssm.ssm_prefill(
                p, jc, x, jssm.init_ssm_cache(jc, x.shape[0]))),
            "decode": jax.jit(lambda p, x, c: jssm.ssm_decode(p, jc, x, c)),
            "scan": jax.jit(lambda p, x: jssm.ssm_reference_scan(p, jc, x))}


def _x(b, s, d, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def test_init_ssm_tree_and_constants():
    """The port's tree is JAX's (names, shapes); the constant leaves are
    JAX's values; the conv weights are N(0, 0.1^2) and the projections
    N(0, 1/fan_in) draws."""
    jc, tc = _configs()
    want = _jax_init(jc)
    got = tssm.init_ssm(torch.Generator().manual_seed(0), tc)
    flat = {**{k: v for k, v in want.items() if k != "norm"},
            "norm.scale": want["norm"]["scale"]}
    assert {k: tuple(v.shape) for k, v in got.named_parameters()} \
        == {k: v.shape for k, v in flat.items()}
    for name in ("a_log", "d_skip", "dt_bias", "conv_b_x", "conv_b_bc"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(got["norm"]["scale"].numpy(),
                                  np.asarray(want["norm"]["scale"]))
    assert float(got["a_log"][0]) == 0.0 and float(got["d_skip"][0]) == 1.0
    assert float(got["dt_bias"][0]) == -2.0
    for name, std in (("conv_w_x", 0.1), ("conv_w_bc", 0.1),
                      ("w_zx", tc.d_model ** -0.5),
                      ("w_bcdt", tc.d_model ** -0.5),
                      ("w_out", (2 * tc.d_model) ** -0.5)):
        assert abs(float(got[name].std()) / std - 1) < 0.15, name
        assert abs(float(got[name].mean())) < 0.15 * std, name


@pytest.mark.parametrize("l", [1, 5, 16])
def test_segsum_matches_jax(l):
    x = -np.abs(np.random.default_rng(l).standard_normal((2, 3, l))
                ).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    above = np.triu(np.ones((l, l), bool), 1)
    assert np.isneginf(got[..., above]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("s", [11, 32, 45], ids=["below_one_chunk",
                                                  "two_chunks", "ragged"])
def test_ssd_chunked_matches_jax(s):
    """y and the final state from the same (x * dt, A dt, B, C) at chunk
    16: one partial chunk, whole chunks, and the zero-padded tail."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a_dt = -0.2 * np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    y_j, h_j = jax.jit(jssm._ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (xh, a_dt, bm, cm)), 16)
    y_t, h_t = tssm._ssd_chunked(*map(torch.from_numpy, (xh, a_dt, bm, cm)),
                                 16)
    _close(y_t, y_j)
    _close(h_t, h_j)


def test_ssm_train_matches_jax(params, jfns):
    _, tc = _configs()
    _, jp, tp = params
    x = _x(2, 45, tc.d_model, seed=1)
    want = jfns["train"](jp, jnp.asarray(x))
    _close(tssm.ssm_train(tp, tc, torch.from_numpy(x)), want, F32_TOL)


def _prefill_both(params, jfns, x):
    _, tc = _configs()
    _, jp, tp = params
    out_j, cache_j = jfns["prefill"](jp, jnp.asarray(x))
    cache_t = tssm.init_ssm_cache(tc, x.shape[0], "cpu")
    out_t, _ = tssm.ssm_prefill(tp, tc, torch.from_numpy(x), cache_t)
    return (out_j, cache_j), (out_t, cache_t)


def test_ssm_prefill_matches_jax(params, jfns):
    """The output, the final state and both bf16 conv windows."""
    x = _x(2, 37, _configs()[1].d_model, seed=2)
    (out_j, cache_j), (out_t, cache_t) = _prefill_both(params, jfns, x)
    _close(out_t, out_j, F32_TOL)
    _close(cache_t.state, cache_j.state, F32_TOL)
    assert cache_t.state.dtype == torch.float32
    for name in ("conv_x", "conv_bc"):
        got, want = getattr(cache_t, name), getattr(cache_j, name)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=CACHE_RTOL,
                                   atol=CACHE_ATOL)
        assert np.mean(got != want) < 0.01
    assert cache_t.length == int(cache_j.length) == 37


def test_ssm_decode_matches_jax(params, jfns):
    """Four decode steps after a prefill, each fed the same input, and
    the sequential oracle over six positions from an empty cache."""
    _, tc = _configs()
    _, jp, tp = params
    x = _x(2, 20, tc.d_model, seed=3)
    (_, cache_j), (_, cache_t) = _prefill_both(params, jfns, x[:, :16])
    for t in range(16, 20):
        out_j, cache_j = jfns["decode"](jp, jnp.asarray(x[:, t:t + 1]),
                                        cache_j)
        out_t, _ = tssm.ssm_decode(tp, tc, torch.from_numpy(x[:, t:t + 1]),
                                   cache_t)
        assert np.max(np.abs(out_t.numpy() - np.asarray(out_j))) \
            <= DECODE_F32_TOL
    _close(cache_t.state, cache_j.state, F32_TOL)
    assert cache_t.length == int(cache_j.length) == 20
    want = jfns["scan"](jp, jnp.asarray(x[:, :6]))
    got = tssm.ssm_reference_scan(tp, tc, torch.from_numpy(x[:, :6]))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= DECODE_F32_TOL


def test_ssd_chunked_matches_sequential_oracle(params):
    """Port of tests/test_models_unit.py's test: the chunked SSD equals
    the step-by-step recurrence (f32)."""
    _, tc = _configs()
    tp = params[2]
    x = torch.from_numpy(_x(2, 12, tc.d_model, seed=4))
    torch.testing.assert_close(tssm.ssm_train(tp, tc, x),
                               tssm.ssm_reference_scan(tp, tc, x),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_ssd_chunk_size_invariance(params, chunk):
    """Port of tests/test_models_unit.py's test: the output does not
    depend on the chunking."""
    _, tc = _configs()
    tp = params[2]
    x = torch.from_numpy(_x(1, 16, tc.d_model, seed=5))
    torch.testing.assert_close(
        tssm.ssm_train(tp, dataclasses.replace(tc, ssm_chunk=chunk), x),
        tssm.ssm_train(tp, dataclasses.replace(tc, ssm_chunk=16), x),
        rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_defect(params, jfns, s):
    """A prompt shorter than ssm_conv - 1 = 3: the JAX package keeps a
    short conv window and its next decode step fails on the shapes; the
    port refuses the prefill, naming the window."""
    jc, tc = _configs()
    _, jp, tp = params
    x = _x(1, s + 1, tc.d_model, seed=6)
    _, cache = jfns["prefill"](jp, jnp.asarray(x[:, :s]))
    assert cache.conv_x.shape[1] == s < jc.ssm_conv - 1
    with pytest.raises(TypeError, match="incompatible shapes"):
        jfns["decode"](jp, jnp.asarray(x[:, s:]), cache)
    with pytest.raises(ValueError, match=r"ssm_conv - 1 = 3"):
        tssm.ssm_prefill(tp, tc, torch.from_numpy(x[:, :s]),
                         tssm.init_ssm_cache(tc, 1, "cpu"))
