"""The port's training substrate against the JAX package on the CPU: the
AdamW optimizer, the checkpoint layout and the fault tools.

Ports of tests/test_train_substrate.py's optimizer, checkpoint and fault
tests and of tests/test_system.py's re-mesh-then-restore and bf16-moment
tests, plus the cross-package holds: one ``apply`` (plain, compressed,
bf16 moments) from the same parameters and gradients equals ``repro``'s
to 1e-6 (both compute in f32; the schedule, bias corrections and
clipping scale are f32 in both, the gradient norm sums its leaves in
another order), and a checkpoint directory written by either package
restores in the other bitwise.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import smoke_config as jsmoke_config
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as opt

import torch_dist_ranks

APPLY_TOL = 1e-6


def quadratic_params():
    return {"w": torch.tensor([2.0, -3.0, 1.0]), "b": torch.tensor(0.5)}


def _quadratic_grads(p):
    return {"w": 2 * p["w"], "b": 2 * p["b"]}


def _quadratic_loss(p) -> float:
    return float(torch.sum(p["w"] ** 2) + p["b"] ** 2)


# --- optimizer -------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    cfg = opt.OptConfig(lr=0.05, warmup_steps=5, total_steps=400,
                        weight_decay=0.0, clip_norm=10.0)
    params = quadratic_params()
    state = opt.init(cfg, params)
    for _ in range(400):
        params, state, _ = opt.apply(cfg, state, params, _quadratic_grads(params))
    assert _quadratic_loss(params) < 1e-3
    assert int(state.step) == 400


def test_grad_compression_error_feedback_converges():
    """int8 + error feedback still drives the loss down (the residual keeps
    the long-run average update unbiased)."""
    cfg = opt.OptConfig(lr=0.05, warmup_steps=0, total_steps=600,
                        weight_decay=0.0, compress_grads=True)
    params = quadratic_params()
    state = opt.init(cfg, params)
    for _ in range(600):
        params, state, _ = opt.apply(cfg, state, params, _quadratic_grads(params))
    assert _quadratic_loss(params) < 5e-3


def test_compression_roundtrip_residual():
    g = torch.tensor([1.0, -0.5, 0.001])
    g_hat, new_err = opt.compress_decompress(g, torch.zeros(3))
    np.testing.assert_allclose((g_hat + new_err).numpy(), g.numpy(), atol=1e-6)


def test_quantize_rounds_half_to_even_as_jax():
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    q, scale = opt._quantize_int8(torch.from_numpy(g))
    jq, jscale = jopt._quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_schedule_shape():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt.schedule(cfg, 0)) == 0.0
    assert abs(float(opt.schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(opt.schedule(cfg, 100)) <= cfg.min_lr_frac + 1e-6
    jcfg = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 1, 7, 10, 33, 99, 100, 250):
        got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(jopt.schedule(jcfg, jnp.int32(step)))) <= 1e-7


def test_bf16_moments_still_converge():
    cfg = opt.OptConfig(lr=0.05, warmup_steps=0, total_steps=500,
                        weight_decay=0.0, moment_dtype="bfloat16")
    params = {"w": torch.tensor([2.0, -3.0, 1.0])}
    state = opt.init(cfg, params)
    assert state.mu["w"].dtype == torch.bfloat16
    for _ in range(500):
        params, state, _ = opt.apply(cfg, state, params, {"w": 2 * params["w"]})
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


APPLY_CASES = {
    "plain": {},
    "compressed": {"compress_grads": True},
    "bf16_moments": {"moment_dtype": "bfloat16"},
    "clipped_decayed": {"clip_norm": 0.05, "weight_decay": 0.3},
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_matches_repro(case):
    """Three applies from the same parameters, gradients and (nonzero)
    state in both packages: parameters, moments, residuals, grad_norm and
    lr to 1e-6."""
    fields = dict(lr=1e-2, warmup_steps=2, total_steps=20, **APPLY_CASES[case])
    cfg, jcfg = opt.OptConfig(**fields), jopt.OptConfig(**fields)
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (3,), "c": ()}
    p_np = {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    jparams = {k: jnp.asarray(v) for k, v in p_np.items()}
    state, jstate = opt.init(cfg, params), jopt.init(jcfg, jparams)
    for _ in range(3):
        g_np = {k: np.asarray(rng.standard_normal(s) * 3, np.float32)
                for k, s in shapes.items()}
        params, state, m = opt.apply(
            cfg, state, params, {k: torch.from_numpy(v) for k, v in g_np.items()})
        jparams, jstate, jm = jopt.apply(
            jcfg, jstate, jparams, {k: jnp.asarray(v) for k, v in g_np.items()})
        for k in shapes:
            for got, want in ((params[k], jparams[k]), (state.mu[k], jstate.mu[k]),
                              (state.nu[k], jstate.nu[k])):
                assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           rtol=0, atol=APPLY_TOL)
            if cfg.compress_grads:
                np.testing.assert_allclose(state.error[k].numpy(),
                                           np.asarray(jstate.error[k]),
                                           rtol=0, atol=APPLY_TOL)
        assert (state.error is None) == (jstate.error is None)
        assert int(state.step) == int(jstate.step)
        for key in ("grad_norm", "lr"):
            assert abs(float(m[key]) - float(jm[key])) <= APPLY_TOL * max(
                1.0, abs(float(jm[key])))


# --- checkpointing ---------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, tree, extra={"cursor": 7})
    like = ckpt.map_leaves(torch.zeros_like, tree)
    restored, extra = ckpt.restore(d, like)
    assert extra["cursor"] == 7
    np.testing.assert_allclose(restored["a"].numpy(), tree["a"].numpy())
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_gc_keeps_last(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.zeros(2)}
    for s in range(5):
        ckpt.save(d, s, tree, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_000000003", "step_000000004"]
    assert ckpt.latest_step(d) == 4


def _flip_last_byte(path):
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(8).float()}
    path = ckpt.save(d, 1, tree)
    _flip_last_byte(os.path.join(path, "arr_00000.npy"))
    with pytest.raises(IOError):
        ckpt.restore(d, ckpt.map_leaves(torch.zeros_like, tree))


def test_restore_with_fallback_skips_corrupt(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.arange(4).float()
    ckpt.save(d, 1, {"x": x * 1}, keep_last=5)
    path2 = ckpt.save(d, 2, {"x": x * 2}, keep_last=5)
    _flip_last_byte(os.path.join(path2, "arr_00000.npy"))
    restored, _, step = ckpt.restore_with_fallback(d, {"x": torch.zeros(4)})
    assert step == 1  # fell back past the corrupt step 2
    assert torch.equal(restored["x"], x)


def test_restore_refuses_wrong_count_and_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"x": torch.zeros(4), "y": torch.zeros(2)})
    with pytest.raises(ValueError, match="2 arrays, expected 1"):
        ckpt.restore(d, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, {"x": torch.zeros(5), "y": torch.zeros(2)})


def test_leaf_order_is_jax_flatten_order():
    """Dict keys sorted, NamedTuple fields and sequences in order, None
    no leaf: the port numbers leaves as jax.tree.flatten does."""
    def tree(make):
        return ({"z": make(0), "a": [make(1), (make(2), make(3))]},
                opt.OptState(step=make(4), mu={"m": make(5), "b": make(6)},
                             nu={"k": make(7)}, error=None))
    got = [int(t) for t in ckpt.leaves(tree(lambda i: torch.tensor(i)))]
    want = [int(x) for x in jax.tree.leaves(tree(lambda i: jnp.asarray(i)))]
    assert got == want == [1, 2, 3, 0, 4, 6, 5, 7]


def _sped_tree(seed=0):
    v = np.random.default_rng(seed).standard_normal((150, 4)).astype(np.float32)
    return v


def _lm_trees():
    """(JAX (params, OptState) with bf16 moments and error=None, the same
    tree in the port's training form)."""
    jc = jsmoke_config(jget_arch("granite-moe-1b-a400m"))
    tc = smoke_config(get_arch("granite-moe-1b-a400m"))
    params = jmodel.init(jax.random.PRNGKey(2), jc)
    jcfg = jopt.OptConfig(moment_dtype="bfloat16")
    state = jopt.init(jcfg, params)
    rng = np.random.default_rng(4)
    state = state._replace(
        step=jnp.int32(17),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                              jnp.bfloat16), state.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape),
                                              jnp.bfloat16), state.nu))
    model = convert.lm_params_from_numpy(
        tc, jax.tree.map(np.asarray, params), device="cpu")
    tstate = opt.init(opt.OptConfig(moment_dtype="bfloat16"),
                      dict(model.named_parameters()))
    return (params, state), model, tstate


def _assert_bitwise(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for got, want in zip(port_leaves, jax_leaves):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert tuple(got.shape) == tuple(want.shape)
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repro_checkpoint_restores_in_the_port_bitwise(tmp_path):
    v = _sped_tree()
    jckpt.save(str(tmp_path / "sped"), 200, (jnp.asarray(v),))
    (got,), _, step = ckpt.restore_with_fallback(str(tmp_path / "sped"),
                                                 (torch.zeros(150, 4),))
    assert step == 200 and np.array_equal(got.numpy(), v)

    jtree, model, tstate = _lm_trees()
    jckpt.save(str(tmp_path / "lm"), 5, jtree, extra={"loss": 1.5})
    tree, extra, step = ckpt.restore_with_fallback(
        str(tmp_path / "lm"), convert.lm_train_tree(model, tstate))
    assert step == 5 and extra == {"loss": 1.5} and tree[1].error is None
    _assert_bitwise(ckpt.leaves(tree), jax.tree.leaves(jtree))
    # and into the model and the optimizer state, by name
    tstate = convert.load_lm_train_tree(model, tstate, tree)
    assert int(tstate.step) == 17
    _assert_bitwise(ckpt.leaves(convert.lm_train_tree(model, tstate)),
                    jax.tree.leaves(jtree))


def test_port_checkpoint_restores_in_repro_bitwise(tmp_path):
    v = _sped_tree(1)
    ckpt.save(str(tmp_path / "sped"), 400, (torch.from_numpy(v),))
    (got,), _ = jckpt.restore(str(tmp_path / "sped"), (jnp.zeros((150, 4)),))
    assert np.array_equal(np.asarray(got), v)

    jtree, model, tstate = _lm_trees()
    path = str(tmp_path / "jax")
    jckpt.save(path, 5, jtree)
    tree, _ = ckpt.restore(path, convert.lm_train_tree(model, tstate))
    tstate = convert.load_lm_train_tree(model, tstate, tree)
    out = ckpt.save(str(tmp_path / "lm"), 6, convert.lm_train_tree(model, tstate),
                    extra={"cursor": 6})
    like = jax.tree.map(jnp.zeros_like, jtree)
    back, extra = jckpt.restore(str(tmp_path / "lm"), like)
    assert extra == {"cursor": 6}
    _assert_bitwise(ckpt.leaves(tree), jax.tree.leaves(back))
    # the same bytes on disk as the JAX package's save of the same tree
    jdir = os.path.join(path, "step_000000005")
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert [a["sha256"] for a in manifest["arrays"]] == [
        a["sha256"] for a in json.load(open(os.path.join(
            jdir, "manifest.json")))["arrays"]]
    assert manifest["treedef"].startswith("PyTreeDef((")


# --- fault tolerance --------------------------------------------------------

def test_elastic_mesh_single_rank():
    jmesh, jdropped = jfault.elastic_mesh(model_axis=16)
    with torch_dist_ranks.one_rank_world():
        mesh, dropped = fault.elastic_mesh(model_axis=16, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.mesh.shape) == tuple(jmesh.devices.shape) == (1, 1, 1)
        assert mesh.size(2) == jmesh.shape["model"] == 1  # gcd(16, 1)
    assert dropped == [] and not jdropped


def test_elastic_remesh_then_restore(tmp_path):
    """Simulated node loss: save, rebuild the elastic mesh, restore (a
    checkpoint is numpy on disk, sharding-agnostic)."""
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    ckpt.save(str(tmp_path / "ck"), 5, tree)
    with torch_dist_ranks.one_rank_world():
        mesh, dropped = fault.elastic_mesh(model_axis=16, device="cpu")
        restored, _, step = ckpt.restore_with_fallback(
            str(tmp_path / "ck"), ckpt.map_leaves(torch.zeros_like, tree))
    assert step == 5 and not dropped
    assert torch.equal(restored["w"], tree["w"])


def test_straggler_scale():
    s = fault.straggler_scale(torch.tensor(3), 4)
    assert s.dtype == torch.float32
    assert float(s) == pytest.approx(4 / 3)
    assert float(s) == float(jfault.straggler_scale(jnp.asarray(3), 4))
    assert float(fault.straggler_scale(torch.tensor(0), 4)) == 4.0


def test_retrying_eventually_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    assert fault.retrying(flaky, attempts=5, base_delay=0.01)() == "ok"

    def broken():
        calls["n"] += 1
        raise IOError("persistent")

    calls["n"] = 0
    with pytest.raises(IOError):
        fault.retrying(broken, attempts=2, base_delay=0.0)()
    assert calls["n"] == 2


def test_heartbeat_monitor():
    hb = fault.HeartbeatMonitor(num_hosts=3, timeout_s=0.05)
    time.sleep(0.1)
    hb.beat(1)
    assert hb.dead_hosts() == [0, 2]


# --- the shell ----------------------------------------------------------------

def test_cli_without_card_and_device_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("sped", "lm"):
        assert ttrain.main(["--mode", mode, "--steps", "1"]) == 2
        assert "device='cpu'" in capsys.readouterr().err
