"""The port's data-parallel train step with ZeRO-1 moments on one gloo
world of 2 CPU ranks, a (2, 1) ("data", "model") mesh, against the JAX
package on its one CPU device.

The world is spawned once for the module (``parallel.run_ranks``); every
rank runs all cases (``tests/torch_dist_ranks.run_train_dp``) in f32
compute from numpy trees and batches shared with the JAX side.  The
reference is what the JAX package's mesh step computes: its dispatch
groups are the data blocks (as tests/test_torch_lm_mesh.py argues for
serving), so it is ``jax.value_and_grad`` of ``model.train_loss`` on each
half of the batch, the two averaged, then ``repro.train.optimizer.apply``.
Bars, f32 in both packages: losses and grad norms 1e-4 (the bars of
tests/test_torch_train_lm.py, the norms relative), parameters after the
steps 1e-5 of each leaf's largest magnitude, the moments 1e-4 of each
leaf's largest magnitude.  Measured
here: losses 9.5e-7, grad norms 4.6e-7, parameters and moments 1.6e-5
(a moment of granite's).  The ranks' parameters are bitwise equal, and
each rank's moments take the bytes ``dryrun.reckon`` gives the (2, 1)
mesh's ``optimizer_bytes``.  The compressed case matches the port's
one-process halves bitwise.  The ranks' checkpoint crosses to one
process, to the JAX package and back byte for byte, and survives
``elastic_mesh`` losing a rank.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro import configs as jcfg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import convert, parallel
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as tlayers
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

CPU = "cpu"
LOSS_TOL, PARAM_TOL, MOMENT_TOL = 1e-4, 1e-5, 1e-4
B, S, STEPS = 4, 32, 3
QWEN, GRANITE = "qwen3-4b", "granite-moe-1b-a400m"
# eps 1e-3, not the default 1e-8: Adam's update g / (|g| + eps) has slope
# 1 / eps at g = 0, so a rounding difference between the packages'
# gradients moves a parameter whose gradient is small by up to lr times
# that difference over eps.  Measured on qwen3's smoke model after 3
# steps WITHOUT a mesh, port against JAX package: embed.table off by
# 2.3e-4 of its largest magnitude at eps 1e-8, 3.8e-5 at 1e-5, 7.6e-7 at
# 1e-3.  At 1e-3 the parameter bar reads the step, not that slope.
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=STEPS, eps=1e-3)
CASES = {  # (arch, config overrides, extra OptConfig fields, aux weight,
    #          microbatches)
    "qwen3": (QWEN, None, {}, None, 1),
    "granite": (GRANITE, None, {}, None, 1),
    "granite_aux": (GRANITE, None, {}, 1.0, 1),
    "qwen3_three_layers": (QWEN, {"num_layers": 3}, {}, None, 1),
    # held to the JAX package at its first loss and grad norm only, and
    # otherwise to the port's one-process halves (``_port_halves``): int8
    # rounding turns a last-bit difference at a quantization boundary
    # into a whole step of max|g| / 127 (measured against the JAX package
    # after 3 steps: loss off by 3.1e-3, embed.table by 1.1e-2 of its
    # largest magnitude)
    "granite_compress": (GRANITE, None, {"compress_grads": True}, None, 1),
    "qwen3_microbatches": (QWEN, None, {}, None, 2),
}
COMPRESSED = ("granite_compress",)
CKPT_STEPS = 2


def _batch(vocab: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _tree(jc, seed: int) -> dict:
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), jc))


def _reference(jc, tree, batches, fields, aux_weight):
    """The JAX package's mesh step: each half's gradient, averaged, then
    AdamW.  Returns (losses, grad norms, params, OptState) as numpy."""
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, jc, b, aux_weight=aux_weight),
        has_aux=True))
    ocfg = jopt.OptConfig(**fields)
    apply = jax.jit(lambda st, p, g: jopt.apply(ocfg, st, p, g))
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(ocfg, params)
    losses, norms = [], []
    for batch in batches:
        outs = [grad(params, {k: jnp.asarray(v[h]) for k, v in batch.items()})
                for h in (slice(0, B // 2), slice(B // 2, B))]
        g = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
        params, state, m = apply(state, params, g)
        losses.append(np.mean([float(o[0][0]) for o in outs]))
        norms.append(float(m["grad_norm"]))
    return (np.array(losses), np.array(norms), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state))


def _port_halves(case: dict):
    """The port without a mesh computing what the ranks compute: each
    half's gradient in one process, the two averaged, then
    ``optimizer.apply``.  Returns (losses, grad norms, params, OptState)
    as numpy."""
    cfg = ranks.lm_config(case["arch"], case["overrides"])
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    ocfg = opt.OptConfig(**case["opt"])
    params = dict(model.named_parameters())
    state = opt.init(ocfg, params)
    losses, norms = [], []
    for batch in case["batches"]:
        halves = []
        for h in (slice(0, B // 2), slice(B // 2, B)):
            model.zero_grad(set_to_none=True)
            loss, _ = model.train_loss({k: torch.from_numpy(v[h])
                                        for k, v in batch.items()})
            loss.backward()
            halves.append((float(loss.detach()), {k: p.grad.clone()
                                         for k, p in params.items()}))
        grads = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in params}
        model.zero_grad(set_to_none=True)
        _, state, m = opt.apply(ocfg, state, params, grads)
        losses.append(np.mean([h[0] for h in halves]))
        norms.append(float(m["grad_norm"]))
    tree = convert.lm_train_tree(model, state)
    return (np.array(losses), np.array(norms),
            jax.tree.map(lambda t: t.numpy(), tree[0]),
            tree[1]._replace(step=tree[1].step.numpy(), mu=jax.tree.map(
                lambda t: t.numpy(), tree[1].mu), nu=jax.tree.map(
                lambda t: t.numpy(), tree[1].nu), error=jax.tree.map(
                lambda t: t.numpy(), tree[1].error)))


def _jc(arch, overrides=None):
    return dataclasses.replace(jcfg.smoke_config(jcfg.get_arch(arch)),
                               **(overrides or {}))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        cases, want = {}, {}
        for i, (name, (arch, over, fields, aux, mb)) in enumerate(CASES.items()):
            jc = _jc(arch, over)
            tree = _tree(jc, seed=i)
            batches = [_batch(jc.vocab_size, 10 * i + s) for s in range(STEPS)]
            f = {**OPT, **fields}
            cases[name] = {"arch": arch, "overrides": over, "tree": tree,
                           "batches": batches, "opt": f, "aux_weight": aux,
                           "microbatches": mb}
            want[name] = _reference(jc, tree, batches, f,
                                    0.01 if aux is None else aux)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as each rank runs
        try:
            port_want = {n: _port_halves(cases[n]) for n in COMPRESSED}
        finally:
            torch.set_num_threads(threads)
        # the checkpoint case: granite, CKPT_STEPS steps; the JAX state
        # after them saved by the JAX package (the one-process save)
        jc = _jc(GRANITE)
        tree = _tree(jc, seed=7)
        batches = [_batch(jc.vocab_size, 70 + s) for s in range(CKPT_STEPS)]
        ref = _reference(jc, tree, batches, OPT, 0.01)
        one_dir = str(tmp / "one")
        jckpt.save(one_dir, CKPT_STEPS, (jax.tree.map(jnp.asarray, ref[2]),
                                         jax.tree.map(jnp.asarray, ref[3])))
        ck = {"arch": GRANITE, "tree": tree, "batches": batches, "opt": OPT,
              "one_dir": one_dir}
    results = parallel.run_ranks(2, ranks.run_train_dp,
                                 {"cases": cases, "checkpoint": ck,
                                  "tmp": str(tmp)}, device=CPU, timeout=300.0)
    return {"ranks": [r.value for r in results], "cases": cases, "want": want,
            "port_want": port_want, "ckpt": ck, "ckpt_ref": ref, "tmp": tmp}


def _close(got, want, tol, what):
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[name]) - w).max())
        assert err <= tol * scale, (what, name, err / scale)


def _layout(case: dict, index: int):
    """The ZeRO-1 layout of the case's model on the (2, 1) mesh, as data
    rank ``index`` holds it."""
    cfg = ranks.lm_config(case["arch"], case.get("overrides"))
    named = dict(convert.Model(cfg, device="meta").named_parameters())
    return shardings.zero1_layout(named, AbstractMesh((2, 1), ("data", "model")),
                                  index=index)


def test_coords(world):
    assert [r["coord"] for r in world["ranks"]] == [(0, 0), (1, 0)]


def _want(world, name):
    """The case's reference: the JAX package's, or for the compressed
    case the port's one-process halves."""
    return world["port_want" if name in COMPRESSED else "want"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_grad_norms_match_repro(world, name):
    losses, norms, _, _ = _want(world, name)
    jlosses, jnorms, _, _ = world["want"][name]
    for r in world["ranks"]:
        got = r[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=LOSS_TOL)
        assert np.all(np.abs(got["grad_norms"] - norms) <= LOSS_TOL * norms)
        # every case's first step against the JAX package
        assert abs(got["losses"][0] - jlosses[0]) <= LOSS_TOL
        assert abs(got["grad_norms"][0] - jnorms[0]) <= LOSS_TOL * jnorms[0]


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_repro_and_ranks_bitwise(world, name):
    _, _, params, _ = _want(world, name)
    outs = [r[name]["params"] for r in world["ranks"]]
    want = convert.lm_named_from_tree(params)
    got = [convert.lm_named_from_tree(o) for o in outs]
    _close(got[0], want, PARAM_TOL, name)
    for k in want:
        assert parallel.bitwise_equal([g[k] for g in got]), k


@pytest.mark.parametrize("name", list(CASES))
def test_moment_slices_match_repro(world, name):
    """Each rank holds only its slice of each moment (none of a layer
    another rank owns), equal to that slice of the JAX package's."""
    _, _, _, state = _want(world, name)
    mu = _tensors(convert.lm_named_from_tree(state.mu))
    nu = convert.lm_named_from_tree(state.nu)
    case = world["cases"][name]
    for index, r in enumerate(world["ranks"]):
        lay = _layout(case, index)
        local = r[name]["mu_local"]
        held = {k for k in mu if lay.part(k, mu[k]) is not None}
        assert set(local) == held
        _close(local, {k: lay.part(k, mu[k]).numpy() for k in held},
               MOMENT_TOL, (name, index))
        _close(r[name]["mu"], mu, MOMENT_TOL, name)  # gathered whole
        _close(r[name]["nu"], nu, MOMENT_TOL, name)


@pytest.mark.parametrize("name", ["qwen3", "granite", "qwen3_three_layers",
                                  "granite_compress"])
def test_moment_bytes_are_the_reckoning(world, name):
    case = world["cases"][name]
    cfg = ranks.lm_config(case["arch"], case.get("overrides"))
    ocfg = opt.OptConfig(**case["opt"])
    want = dryrun.reckon(cfg, "train", B, S, AbstractMesh((2, 1),
                                                           ("data", "model")),
                         ocfg)["optimizer_bytes"]
    whole = sum(p.numel() * 4 for p in convert.Model(
        cfg, device="meta").parameters())
    extra = whole if ocfg.compress_grads else 0  # the whole residuals
    for r in world["ranks"]:
        assert r[name]["moment_bytes"] + 4 + extra == want
    assert want - 4 - extra < 2 * whole  # split: less than whole moments


def test_three_layer_moments_split_inside_the_leaf(world):
    lay = _layout(world["cases"]["qwen3_three_layers"], 0)
    assert lay.splits["layers.0.attn.wq"] == shardings.MomentSplit(0, None)
    lay4 = _layout(world["cases"]["qwen3"], 0)
    assert lay4.splits["layers.0.attn.wq"].owner == 0
    assert lay4.splits["layers.3.attn.wq"].owner == 1


def _tensors(named: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}


def _npy_bytes(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).glob("*.npy"))}


def test_checkpoint_bytes_match_a_one_process_save(world, tmp_path):
    """The ranks' save, restored in one process without a mesh and saved
    again, is byte for byte the same; the JAX package restores it."""
    tmp = world["tmp"]
    dp_dir = ckpt.latest_step(str(tmp / "dp"))
    assert dp_dir == CKPT_STEPS
    cfg = ranks.lm_config(GRANITE)
    model = convert.Model(cfg, device=CPU)
    state = opt.init(opt.OptConfig(**OPT), dict(model.named_parameters()))
    tree, _ = ckpt.restore(str(tmp / "dp"), convert.lm_train_like(model, state))
    state = convert.load_lm_train_tree(model, state, tree)
    ckpt.save(str(tmp_path / "one"), CKPT_STEPS,
              convert.lm_train_tree(model, state))
    step_dir = f"step_{CKPT_STEPS:09d}"
    assert _npy_bytes(tmp / "dp" / step_dir) == _npy_bytes(
        tmp_path / "one" / step_dir)
    # the JAX package's restore; the state is the ranks' (whole moments)
    ref_params, ref_state = world["ckpt_ref"][2], world["ckpt_ref"][3]
    like = (jax.tree.map(jnp.asarray, ref_params),
            jax.tree.map(jnp.asarray, ref_state))
    (jparams, jstate), _ = jckpt.restore(str(tmp / "dp"), like)
    r0 = world["ranks"][0]["checkpoint"]
    assert int(jstate.step) == CKPT_STEPS
    # close to the JAX package's own run of the same steps
    _close(convert.lm_named_from_tree(jax.tree.map(np.asarray, jparams)),
           convert.lm_named_from_tree(ref_params), PARAM_TOL, "ckpt params")
    _close(convert.lm_named_from_tree(jax.tree.map(np.asarray, jstate.mu)),
           convert.lm_named_from_tree(ref_state.mu), MOMENT_TOL, "ckpt mu")


def test_checkpoint_reverse_direction(world):
    """The JAX package's save restored on the 2 ranks: each holds its
    slices of the saved moments; their save again is byte for byte the
    JAX package's."""
    tmp = world["tmp"]
    mu = _tensors(convert.lm_named_from_tree(world["ckpt_ref"][3].mu))
    for index, r in enumerate(world["ranks"]):
        lay = _layout(world["ckpt"], index)
        local = r["checkpoint"]["reverse_mu_local"]
        for k, t in local.items():
            assert np.array_equal(np.asarray(t), lay.part(k, mu[k]).numpy()), k
    step_dir = f"step_{CKPT_STEPS:09d}"
    assert _npy_bytes(tmp / "again" / step_dir) == _npy_bytes(
        Path(world["ckpt"]["one_dir"]) / step_dir)


def test_elastic_survivor_restores_resliced(world):
    """``elastic_mesh`` drops rank 1; rank 0 restores the ranks' save on
    its mesh of one and holds every moment whole."""
    tmp = world["tmp"]
    r0 = world["ranks"][0]["checkpoint"]
    assert r0["dropped"] == [] and r0["mesh_ranks"] == [0]
    assert "survivor" not in world["ranks"][1]["checkpoint"]
    surv = r0["survivor"]
    assert surv["step"] == CKPT_STEPS
    cfg = ranks.lm_config(GRANITE)
    model = convert.Model(cfg, device=CPU)
    state = opt.init(opt.OptConfig(**OPT), dict(model.named_parameters()))
    tree, _ = ckpt.restore(str(tmp / "dp"), convert.lm_train_like(model, state))
    params, jstate = tree
    want = convert.lm_named_from_tree(params)
    got = convert.lm_named_from_tree(surv["params"])
    assert all(np.array_equal(got[k], want[k].numpy()) for k in want)
    wmu = convert.lm_named_from_tree(jstate.mu)
    assert set(surv["mu"]) == set(wmu)
    assert all(np.array_equal(surv["mu"][k], wmu[k].numpy()) for k in wmu)


def test_train_lm_on_two_ranks_matches_one_process(world, monkeypatch):
    """``train_lm`` in the world of 2 (torchrun's path) against one
    process: the same losses and grad norms; rank 0 alone saved, and the
    ranks held half of qwen3's four layers' moments each."""
    from repro_torch.launch import train

    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = train.train_lm(train.parse_args(ranks.TRAIN_LM_ARGS), CPU)
    finally:
        torch.set_num_threads(threads)
    for r in world["ranks"]:
        got = r["train_lm"]
        np.testing.assert_allclose(got["losses"], one.losses, rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norms"], one.grad_norms,
                                   rtol=LOSS_TOL)
        assert got["moments"] < len(one.opt_state.mu)
    assert ckpt.latest_step(str(world["tmp"] / "lm")) == 3
