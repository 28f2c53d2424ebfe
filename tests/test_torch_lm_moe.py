"""The port's MoE FFN and MLA attention, held to the JAX package on the
CPU at ``smoke_config`` size, in f32.

Parameters come from the JAX package's own ``init_moe`` /
``init_attention`` and cross as numpy arrays; inputs are numpy's.  JAX
runs its grouped MoE form with one group (no mesh), which is the form
the port has.  Measured maxima on this CPU beside their bars:
  * ``moe_ffn`` (smoke granite, smoke deepseek with one shared expert;
    capacity factor 4.0 and 0.05): expert ids, keep masks, sort order and
    slots equal to JAX's; outputs 1.4e-7 of the largest magnitude (bar
    1e-5); aux 1.2e-7 (bar 1e-6);
  * ``mla_train`` 1.2e-6 absolute at outputs up to 3.8 (bar 1e-5);
  * ``mla_decode`` against JAX's 7.2e-7 (bar 5e-3, the decode bar of
    test_torch_lm_model.py: the latent cache is bf16 in both packages);
  * the port's absorbed decode against its own train attention at JAX's
    bar (tests/test_arch_smoke.py: rtol 1e-2, atol 5e-3);
  * ``mla_train`` past 4096 positions leaves the last s % 1024 outputs
    at zero in both packages (a defect of the reference, ROADMAP C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch import configs as tcfg
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Params

MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
MLA_ARCH = "deepseek-v2-236b"
OUT_TOL = 1e-5  # in units of the reference's largest magnitude
AUX_TOL = 1e-6
MLA_TRAIN_TOL = 1e-5
MLA_DECODE_TOL = 5e-3
ABSORB_RTOL, ABSORB_ATOL = 1e-2, 5e-3


def _configs(arch, **repl):
    jc = jcfg.smoke_config(jcfg.get_arch(arch))
    tc = tcfg.smoke_config(tcfg.get_arch(arch))
    return dataclasses.replace(jc, **repl), dataclasses.replace(tc, **repl)


def _params(tree) -> Params:
    return Params(**{k: _params(v) if isinstance(v, dict)
                     else torch.tensor(np.asarray(v, np.float32))
                     for k, v in tree.items()})


def _x(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def moe_trees():
    return {arch: jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(3), _configs(arch)[0])) for arch in MOE_ARCHS}


@pytest.fixture(scope="module")
def mla_tree():
    return jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(0), _configs(MLA_ARCH)[0]))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# --- MoE ----------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [4.0, 0.05])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, capacity_factor, moe_trees):
    """Routing, drops and outputs equal JAX's; at capacity factor 0.05
    both packages drop the same pairs."""
    jc, tc = _configs(arch, capacity_factor=capacity_factor)
    tree = moe_trees[arch]
    x = _x((2, 24, jc.d_model), seed=0)
    t = 2 * 24
    cap = jmoe._capacity(t, jc)
    assert tmoe.capacity(t, tc) == cap

    tokens = x.reshape(t, -1)
    logits = tokens @ tree["router"]
    _, want_ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                                jc.moe_top_k)
    _, (keep, slot, _, order, _), _ = jax.jit(
        lambda tok, lg: jmoe._group_dispatch(tok, lg, jc, cap))(
        jnp.asarray(tokens), jnp.asarray(logits))
    _, info, _ = tmoe.dispatch(torch.tensor(tokens), torch.tensor(logits),
                               tc, cap)
    got_keep, got_slot, _, got_order, _, got_ids = info
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(slot))
    if capacity_factor < 1:
        assert not np.asarray(keep).all()

    want, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got, stats = tmoe.moe_ffn(_params(tree), tc, torch.tensor(x))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= OUT_TOL * np.abs(want).max()
    assert abs(float(stats.aux) - float(want_aux)) <= AUX_TOL
    assert int(stats.dropped) == int((~np.asarray(keep)).sum())
    np.testing.assert_array_equal(stats.expert_ids.numpy(),
                                  np.asarray(want_ids))


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities keep the lower expert id first, as
    jax.lax.top_k does."""
    logits = np.zeros((3, 8), np.float32)
    logits[1, [2, 5, 6]] = 1.0
    logits[2, [7, 0]] = 2.0
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 3)
    _, gates, ids = tmoe.route(torch.tensor(logits), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ids.numpy(), [[0, 1, 2], [2, 5, 6],
                                                [0, 7, 1]])
    torch.testing.assert_close(gates.sum(-1), torch.ones(3))


def test_moe_outputs_finite_and_gates_normalized():
    _, tc = _configs("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(6)
    p = tmoe.init_moe(gen, tc)
    x = torch.randn((2, 8, tc.d_model), generator=gen) * 0.3
    out, stats = tmoe.moe_ffn(p, tc, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(stats.aux) > 0.0  # the load-balancing loss is positive
    _, gates, _ = tmoe.route(x.reshape(16, -1) @ p["router"], tc.moe_top_k)
    torch.testing.assert_close(gates.sum(-1), torch.ones(16))


def test_moe_capacity_drops_when_overloaded():
    """Every token routed to expert 0 first: most of its pairs drop and
    the output stays finite."""
    _, tc = _configs("granite-moe-1b-a400m", capacity_factor=0.05)
    gen = torch.Generator().manual_seed(8)
    p = tmoe.init_moe(gen, tc)
    p["router"][:, 0] = 100.0
    x = torch.randn((2, 64, tc.d_model), generator=gen) * 0.3
    out, stats = tmoe.moe_ffn(p, tc, x)
    assert bool(torch.isfinite(out).all())
    cap = tmoe.capacity(128, tc)
    # expert 0 keeps cap of its 128 pairs at most
    assert int(stats.dropped) >= 128 - cap > 0


def test_moe_matches_dense_reference_when_capacity_ample():
    """With capacity well above the tokens, sort dispatch equals direct
    per-token expert evaluation."""
    _, tc = _configs("granite-moe-1b-a400m", capacity_factor=8.0)
    gen = torch.Generator().manual_seed(10)
    p = tmoe.init_moe(gen, tc)
    x = torch.randn((1, 6, tc.d_model), generator=gen) * 0.3
    got, stats = tmoe.moe_ffn(p, tc, x)
    assert int(stats.dropped) == 0

    toks = x.reshape(-1, tc.d_model)
    probs = torch.softmax(toks @ p["router"], -1)
    gv, ei = torch.topk(probs, tc.moe_top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(toks)
    for t in range(toks.shape[0]):
        for j in range(tc.moe_top_k):
            e = int(ei[t, j])
            h = (torch.nn.functional.silu(toks[t] @ p["w_gate"][e])
                 * (toks[t] @ p["w_up"][e]))
            want[t] += gv[t, j] * (h @ p["w_down"][e])
    torch.testing.assert_close(got.reshape(-1, tc.d_model), want,
                               rtol=1e-5, atol=1e-5)


def test_moe_init_draws_the_reference_fan_in():
    """The expert stacks' scale is 1/sqrt(num_experts), not 1/sqrt(d):
    the JAX package's draw (dense_init's in_axis 0 of (e, d, f)), kept."""
    cfg = tcfg.get_arch("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, d_model=256, moe_d_ff=64)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    for name in ("w_gate", "w_up", "w_down"):
        std = float(p[name].std())
        assert abs(std * np.sqrt(cfg.num_experts) - 1) < 0.02, (name, std)
    assert abs(float(p["router"].std()) * np.sqrt(256) - 1) < 0.05


# --- MLA ----------------------------------------------------------------------

def test_mla_params_match_jax(mla_tree):
    _, tc = _configs(MLA_ARCH)
    got = tattn.init_attention(torch.Generator().manual_seed(0), tc)
    shapes = {n: tuple(v.shape) for n, v in got.named_parameters()}
    want = {}
    for k, v in mla_tree.items():
        if isinstance(v, dict):
            want.update({f"{k}.{kk}": vv.shape for kk, vv in v.items()})
        else:
            want[k] = v.shape
    assert shapes == want


def test_mla_train_matches_jax(mla_tree):
    jc, tc = _configs(MLA_ARCH)
    x = _x((2, 10, jc.d_model), seed=1)
    want, (want_c, want_kr) = jax.jit(lambda p, x: jattn.mla_train(p, jc, x))(
        jax.tree.map(jnp.asarray, mla_tree), jnp.asarray(x))
    got, (got_c, got_kr) = tattn.mla_train(_params(mla_tree), tc,
                                           torch.tensor(x))
    for a, b in ((want, got), (want_c, got_c), (want_kr, got_kr)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= MLA_TRAIN_TOL


def _decode_all(fn, params, cfg, x, cache):
    outs = []
    for t in range(x.shape[1]):
        o, cache = fn(params, cfg, x[:, t:t + 1], cache)
        outs.append(np.asarray(o)[:, 0])
    return np.stack(outs, axis=1), cache


def test_mla_decode_matches_jax_and_train(mla_tree):
    """Absorbed decode against JAX's absorbed decode, and against the
    port's own train attention (the absorption algebra)."""
    jc, tc = _configs(MLA_ARCH)
    b, s = 2, 10
    x = _x((b, s, jc.d_model), seed=2)
    want, jcache = _decode_all(jax.jit(jattn.mla_decode, static_argnums=1),
                               jax.tree.map(jnp.asarray, mla_tree), jc,
                               jnp.asarray(x), jattn.init_mla_cache(jc, b, s))
    p = _params(mla_tree)
    got, tcache = _decode_all(tattn.mla_decode, p, tc, torch.tensor(x),
                              tattn.init_mla_cache(tc, b, s, "cpu"))
    assert np.abs(want - got).max() <= MLA_DECODE_TOL
    assert tcache.length == s
    for name in ("c_kv", "k_rope"):
        np.testing.assert_array_equal(
            getattr(tcache, name).float().numpy(),
            np.asarray(getattr(jcache, name).astype(jnp.float32)))
    train, _ = tattn.mla_train(p, tc, torch.tensor(x))
    np.testing.assert_allclose(got, train.numpy(), rtol=ABSORB_RTOL,
                               atol=ABSORB_ATOL)


def test_mla_cache_is_bf16_and_bounded():
    """The latent cache is bf16 even where the config asks for int8, as
    in the JAX package; a write past its end raises."""
    jc, tc = _configs(MLA_ARCH, kv_cache_dtype="int8")
    cache = tattn.init_mla_cache(tc, 2, 5, "cpu")
    want = jattn.init_mla_cache(jc, 2, 5)
    assert cache.c_kv.dtype == cache.k_rope.dtype == torch.bfloat16
    assert want.c_kv.dtype == jnp.bfloat16
    assert tuple(cache.c_kv.shape) == want.c_kv.shape
    assert tuple(cache.k_rope.shape) == want.k_rope.shape
    c = torch.ones((2, 4, tc.kv_lora_rank))
    kr = torch.ones((2, 4, tc.qk_rope_head_dim))
    tattn.mla_cache_update(cache, c, kr, 0)
    assert cache.length == 4
    with pytest.raises(ValueError, match="cannot hold"):
        tattn.mla_cache_update(cache, c, kr, 4)


def test_mla_train_zero_tail_past_4096_in_both_packages(mla_tree):
    """Past 4096 positions both packages attend s // 1024 query chunks
    and leave the last s % 1024 positions' outputs at zero."""
    jc, tc = _configs(MLA_ARCH)
    s = 4100
    x = _x((1, s, jc.d_model), seed=3, scale=0.1)
    want, _ = jax.jit(lambda p, x: jattn.mla_train(p, jc, x))(
        jax.tree.map(jnp.asarray, mla_tree), jnp.asarray(x))
    got, _ = tattn.mla_train(_params(mla_tree), tc, torch.tensor(x))
    want, got = np.asarray(want), got.numpy()
    body = 4096
    for out in (want, got):
        assert np.abs(out[:, body:]).max() == 0.0
        assert np.abs(out[:, :body]).max() > 0.1
    assert np.abs(want - got).max() <= MLA_TRAIN_TOL
