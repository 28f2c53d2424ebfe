"""The port's train step in the training layout of a (2, 2) ("data",
"model") mesh, on one gloo world of 4 CPU ranks, against the JAX package
on its one CPU device.

Each rank holds its slice of every parameter under ``param_specs(...,
fsdp=True)``: heads, hidden dims, experts and a vocabulary that divides
split over "model", d_model split over "data" (FSDP) and gathered on use
(``models.sharding.read_param``).  The world is spawned once for the
module (``parallel.run_ranks``); every rank runs all cases
(``tests/torch_dist_ranks.run_train_tp``) in f32 compute from numpy trees
and batches shared with the JAX side.  The reference is what the JAX
package's mesh step computes, as in tests/test_torch_train_dp.py:
``jax.value_and_grad`` of ``model.train_loss`` on each data half of the
batch, the two averaged, then ``repro.train.optimizer.apply``, at eps
1e-3 for the reason that file gives.

Bars, f32 in both packages: losses 1e-4, grad norms 1e-4 relative, step
1's gradients (gathered whole) 1e-5 of each leaf's largest |g|, the
parameters after the steps 1e-5 and the moments 1e-4 of each leaf's
largest magnitude.  The compressed case is held to the JAX package at
step 1 (loss, grad norm, gradients) and otherwise to the port's
``optimizer.apply`` in one process fed the world's gradients gathered
whole: int8 rounding turns a last-bit difference of a gradient into a
whole quantum of max|g| / 127, and the model ranks' partial sums differ
from one process's in the last bits (measured against the port's
one-process halves after 3 steps: embed.table off by 1.5e-4 of its
largest magnitude).  Fed the same gradients, the sharded ``apply`` (each
slice quantised with its whole leaf's max|g|, the global clip norm,
ZeRO-1 on the slices) holds the one-process one at the bars.  Each rank's parameter and moment
bytes are ``shardings.tree_bytes`` under the specs; the world's
checkpoint is byte for byte a one-process save of the same tree and
restores on a (2, 1) mesh through ``fault.restore_on_mesh``.  In the
same world, a (1, 4) mesh puts all four ranks on "model": one head-sliced
Mamba2 mixer there (an uneven [z | x] exchange: rank 0 sends both its
column blocks to ranks 0 and 1) is held, forward and backward, to the
whole mixer at 1e-5.
"""
import concurrent.futures
import dataclasses
import functools
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
from repro_torch.launch import shardings
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.frontends import frontend_spec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

CPU = "cpu"
LOSS_TOL, GRAD_TOL, PARAM_TOL, MOMENT_TOL = 1e-4, 1e-5, 1e-5, 1e-4
B, S, STEPS = 4, 32, 3
QWEN, GRANITE = "qwen3-4b", "granite-moe-1b-a400m"
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=STEPS, eps=1e-3)
MESH = AbstractMesh(ranks.TP_MESH, ("data", "model"))
CASES = {  # (arch, config overrides, extra OptConfig fields, aux weight,
    #          microbatches)
    "qwen3": (QWEN, None, {}, None, 1),  # dense, vocabulary split
    # aux counted once per model rank: at weight 1.0 a sum over "model"
    # would double its gradient
    "granite_aux": (GRANITE, None, {}, 1.0, 1),
    # a vocabulary that does not divide by 2: the tables stay whole along
    # "model" and are gathered over "data" only
    "granite_vocab_511": (GRANITE, {"vocab_size": 511}, {}, None, 1),
    "deepseek_v2": ("deepseek-v2-236b", None, {}, None, 1),  # MLA, shared
    "whisper": ("whisper-small", None, {}, None, 1),  # cross attn, encoder
    # the Mamba2 mixer on the rank's heads: [z | x] exchanged into
    # head-aligned blocks, the gated norm's statistic summed over "model"
    "mamba2": ("mamba2-2.7b", None, {}, None, 1),
    # the hybrid: sliced mixers and the shared attention block, each group
    # under full remat
    "zamba2": ("zamba2-1.2b", None, {}, None, 1),
    # 3 SSM heads of 128 channels: the mixer's gather form
    "ssm_heads_not_dividing": ("mamba2-2.7b",
                               {"ssm_expand": 3, "ssm_headdim": 128}, {},
                               None, 1),
    "qwen3_microbatches": (QWEN, None, {}, None, 2),
    "granite_compress": (GRANITE, None, {"compress_grads": True}, None, 1),
}
COMPRESSED = ("granite_compress",)
CKPT_STEPS = 2
MIXER_TOL = 1e-5


def _jc(arch, overrides=None):
    return dataclasses.replace(jcfg.smoke_config(jcfg.get_arch(arch)),
                               **(overrides or {}))


def _batch(cfg, seed: int) -> dict:
    """Tokens, labels and the family's stub inputs, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    for name, (shape, _) in frontend_spec(cfg, B).items():
        out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _tree(jc, seed: int) -> dict:
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), jc))


@functools.lru_cache(maxsize=None)
def _grad(jc):
    """jit(value_and_grad) of the JAX package's loss, aux weight traced."""
    return jax.jit(jax.value_and_grad(
        lambda p, b, w: jmodel.train_loss(p, jc, b, aux_weight=w),
        has_aux=True))


def _reference(jc, tree, batches, fields, aux_weight):
    """The JAX package's mesh step: each half's gradient, averaged, then
    AdamW.  Returns (losses, grad norms, step 1's gradients, params,
    OptState) as numpy."""
    ocfg = jopt.OptConfig(**fields)
    apply = jax.jit(lambda st, p, g: jopt.apply(ocfg, st, p, g))
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(ocfg, params)
    losses, norms, first = [], [], None
    for batch in batches:
        outs = [_grad(jc)(params, {k: jnp.asarray(v[h])
                                   for k, v in batch.items()}, aux_weight)
                for h in (slice(0, B // 2), slice(B // 2, B))]
        g = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
        if first is None:
            first = jax.tree.map(np.asarray, g)
        params, state, m = apply(state, params, g)
        losses.append(np.mean([float(o[0][0]) for o in outs]))
        norms.append(float(m["grad_norm"]))
    return (np.array(losses), np.array(norms), first,
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))


def _port_apply(case: dict, grads: list):
    """The port's ``optimizer.apply`` without a mesh, in one process, fed
    the world's gradients of each step gathered whole.  Returns (None,
    grad norms, None, params, OptState) as numpy."""
    cfg = ranks.lm_config(case["arch"], case["overrides"])
    model = convert.lm_params_from_numpy(cfg, case["tree"], device=CPU)
    ocfg = opt.OptConfig(**case["opt"])
    params = dict(model.named_parameters())
    state = opt.init(ocfg, params)
    norms = []
    for g in grads:
        _, state, m = opt.apply(ocfg, state, params,
                                {k: torch.from_numpy(v) for k, v in g.items()})
        norms.append(float(m["grad_norm"]))
    params, st = ranks._np_tree(convert.lm_train_tree(model, state))
    return None, np.array(norms), None, params, st


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cases, refs = {}, {}
    for i, (name, (arch, over, fields, aux, mb)) in enumerate(CASES.items()):
        jc = _jc(arch, over)
        batches = [_batch(jc, 10 * i + s) for s in range(STEPS)]
        f = {**OPT, **fields}
        cases[name] = {"arch": arch, "overrides": over, "tree": _tree(jc, i),
                       "batches": batches, "opt": f, "aux_weight": aux,
                       "microbatches": mb, "keep_grads": name in COMPRESSED}
        refs[name] = (jc, f, 0.01 if aux is None else aux)
    jc = _jc(GRANITE)
    ck = {"arch": GRANITE, "tree": _tree(jc, 7), "opt": OPT,
          "batches": [_batch(jc, 70 + s) for s in range(CKPT_STEPS)]}
    mixer = _mixer_case()
    # the world runs while the JAX package computes its references
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        results = pool.submit(parallel.run_ranks, 4, ranks.run_train_tp,
                              {"cases": cases, "checkpoint": ck,
                               "tmp": str(tmp), "ssm_tp4": mixer},
                              device=CPU, timeout=300.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
            want = {name: _reference(jc, cases[name]["tree"],
                                     cases[name]["batches"], f, aux)
                    for name, (jc, f, aux) in refs.items()}
            ck_ref = _reference(jc, ck["tree"], ck["batches"], OPT, 0.01)
        outs = [r.value for r in results.result()]
    port_want = {n: _port_apply(cases[n], outs[0][n]["grads"])
                 for n in COMPRESSED}
    return {"ranks": outs, "cases": cases, "want": want,
            "port_want": port_want, "ckpt": ck, "ckpt_ref": ck_ref,
            "tmp": tmp, "mixer": mixer}


def _mixer_case() -> dict:
    """One Mamba2 mixer of mamba2's smoke config (16 heads of 16) from a
    JAX draw, its norm scale perturbed, an input of two ragged chunks and
    an upstream gradient, numpy."""
    jc = _jc("mamba2-2.7b")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5), jc))
    mixer = {k: np.asarray(v[0], np.float32)
             for k, v in tree["layers"]["ssm"].items() if k != "norm"}
    rng = np.random.default_rng(5)
    scale = np.asarray(tree["layers"]["ssm"]["norm"]["scale"][0], np.float32)
    mixer["norm"] = {"scale": scale * (1 + 0.1 * rng.standard_normal(
        scale.shape)).astype(np.float32)}
    shape = (2, 2 * jc.ssm_chunk - 5, jc.d_model)
    return {"arch": "mamba2-2.7b", "tree": mixer,
            "x": rng.standard_normal(shape).astype(np.float32),
            "gy": rng.standard_normal(shape).astype(np.float32)}


def _close(got, want, tol, what):
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[name]) - w).max())
        assert err <= tol * scale, (what, name, err / scale)


def _want(world, name):
    return world["port_want" if name in COMPRESSED else "want"][name]


def test_coords(world):
    assert [r["coord"] for r in world["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_grad_norms_match_repro(world, name):
    losses, norms, _, _, _ = world["want"][name]
    _, port_norms, _, _, _ = _want(world, name)
    for r in world["ranks"]:
        got = r[name]
        if name in COMPRESSED:  # the JAX package's first step only
            losses, norms = losses[:1], norms[:1]
            assert np.all(np.abs(got["grad_norms"] - port_norms)
                          <= LOSS_TOL * port_norms)
        n = len(losses)
        np.testing.assert_allclose(got["losses"][:n], losses, rtol=0,
                                   atol=LOSS_TOL)
        assert np.all(np.abs(got["grad_norms"][:n] - norms) <= LOSS_TOL * norms)


@pytest.mark.parametrize("name", list(CASES))
def test_step_one_gradients_match_repro(world, name):
    """Step 1's gradients, each rank's slices gathered whole: the JAX
    package's averaged halves (also for the compressed case, whose
    compression acts in ``apply``)."""
    want = convert.lm_named_from_tree(world["want"][name][2])
    for r in world["ranks"]:
        _close(r[name]["grads"][0], want, GRAD_TOL, name)


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_repro_and_ranks_bitwise(world, name):
    want = convert.lm_named_from_tree(_want(world, name)[3])
    got = [convert.lm_named_from_tree(r[name]["params"])
           for r in world["ranks"]]
    _close(got[0], want, PARAM_TOL, name)
    for k in want:
        assert parallel.bitwise_equal([g[k] for g in got]), k


@pytest.mark.parametrize("name", list(CASES))
def test_moments_match_repro(world, name):
    state = _want(world, name)[4]
    for field in ("mu", "nu"):
        want = convert.lm_named_from_tree(getattr(state, field))
        for r in world["ranks"]:
            got = convert.lm_named_from_tree(getattr(r[name]["state"], field))
            _close(got, want, MOMENT_TOL, (name, field))


@pytest.mark.parametrize("name", list(CASES))
def test_bytes_are_the_specs(world, name):
    """Each rank's parameter bytes are ``tree_bytes`` of the stacked f32
    tree under ``param_specs(fsdp=True)``, its moment bytes twice that
    of the moments under ``moment_specs``; both below whole."""
    case = world["cases"][name]
    cfg = ranks.lm_config(case["arch"], case["overrides"])
    model = convert.Model(cfg, device="meta")
    shapes = shardings.stacked_param_shapes(model)
    p_specs = shardings.param_specs(cfg, shapes, MESH, fsdp=True)
    want_p = shardings.tree_bytes(shapes, p_specs, MESH)
    want_m = 2 * shardings.tree_bytes(
        shapes, shardings.moment_specs(p_specs, shapes, MESH), MESH)
    whole = sum(p.numel() * 4 for p in model.parameters())
    for r in world["ranks"]:
        assert r[name]["param_bytes"] == want_p
        assert r[name]["moment_bytes"] == want_m
    assert want_p < whole and want_m < 2 * want_p


def test_uneven_exchange_at_tp4_matches_the_whole_mixer(world):
    """On the (1, 4) mesh each rank's head-sliced mixer gives the whole
    mixer's output and input gradient, and its leaves' gradients (its
    blocks of the split ones, the whole replicated ones) within 1e-5 of
    each's largest magnitude; one exchange and the norm's and w_out's
    sums forward, the inverse exchange backward."""
    from repro_torch.models import ssm as tssm

    case = world["mixer"]
    cfg = ranks.lm_config(case["arch"])
    node = ranks.lm_params(case["tree"])
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = tssm.ssm_train(node, cfg, x)
    (out * torch.from_numpy(case["gy"])).sum().backward()
    grads = {k: p.grad.numpy() for k, p in node.named_parameters()}
    for j, r in enumerate(world["ranks"]):
        got = r["ssm_tp4"]
        assert got["calls"]["all_to_all"] == 2
        assert got["calls"]["all_gather"] == 0
        _close({"out": got["out"], "dx": got["dx"]},
               {"out": out.detach().numpy(), "dx": x.grad.numpy()},
               MIXER_TOL, ("mixer", j))
        want = ranks.ssm_mixer_slice(grads, 4, j)
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            scale = float(np.abs(grads[k]).max())
            err = float(np.abs(g - want[k]).max())
            assert err <= MIXER_TOL * scale, (j, k, err / scale)


def test_model_drawn_in_its_layout_is_the_whole_models_slices(world):
    assert all(r["drawn_sliced_bitwise"] for r in world["ranks"])


@pytest.mark.parametrize("what", ["whole_under_tp", "prefill", "decode_step"])
def test_raises(world, what):
    """A whole model does not train under a "model" extent of 2; a model
    in its training layout does not serve."""
    for r in world["ranks"]:
        assert r[what] == "ValueError"


def _npy_bytes(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).glob("*.npy"))}


def test_checkpoint_bytes_match_a_one_process_save(world, tmp_path):
    """The world's save, restored in one process without a mesh and saved
    again, is byte for byte the same; the JAX package restores it close
    to its own run of the same steps."""
    tmp = world["tmp"]
    assert ckpt.latest_step(str(tmp / "tp")) == CKPT_STEPS
    cfg = ranks.lm_config(GRANITE)
    model = convert.Model(cfg, device=CPU)
    state = opt.init(opt.OptConfig(**OPT), dict(model.named_parameters()))
    tree, _ = ckpt.restore(str(tmp / "tp"), convert.lm_train_like(model, state))
    state = convert.load_lm_train_tree(model, state, tree)
    ckpt.save(str(tmp_path / "one"), CKPT_STEPS,
              convert.lm_train_tree(model, state))
    step_dir = f"step_{CKPT_STEPS:09d}"
    assert _npy_bytes(tmp / "tp" / step_dir) == _npy_bytes(
        tmp_path / "one" / step_dir)
    ref_params, ref_state = world["ckpt_ref"][3], world["ckpt_ref"][4]
    like = (jax.tree.map(jnp.asarray, ref_params),
            jax.tree.map(jnp.asarray, ref_state))
    (jparams, jstate), _ = jckpt.restore(str(tmp / "tp"), like)
    assert int(jstate.step) == CKPT_STEPS
    _close(convert.lm_named_from_tree(jax.tree.map(np.asarray, jparams)),
           convert.lm_named_from_tree(ref_params), PARAM_TOL, "ckpt params")
    _close(convert.lm_named_from_tree(jax.tree.map(np.asarray, jstate.mu)),
           convert.lm_named_from_tree(ref_state.mu), MOMENT_TOL, "ckpt mu")


def test_checkpoint_restores_on_a_2x1_mesh(world):
    """Ranks 0 and 1 restore the world's save on a (2, 1) mesh: each holds
    its (2, 1) slice of every saved parameter and its ZeRO-1 slice of
    that of every saved moment, bitwise; ranks 2 and 3 take no part."""
    cfg = ranks.lm_config(GRANITE)
    model = convert.Model(cfg, device=CPU)
    state = opt.init(opt.OptConfig(**OPT), dict(model.named_parameters()))
    (params, saved), _ = ckpt.restore(str(world["tmp"] / "tp"),
                                      convert.lm_train_like(model, state))
    params = convert.lm_named_from_tree(params)
    mu = convert.lm_named_from_tree(saved.mu)
    mesh21 = AbstractMesh((2, 1), ("data", "model"))
    assert world["ranks"][2]["checkpoint"] == {}
    assert world["ranks"][3]["checkpoint"] == {}
    for r in world["ranks"][:2]:
        out = r["checkpoint"]
        assert out["step"] == CKPT_STEPS
        d = out["coord"][0]
        lay = shardings.train_layout(cfg, mesh21, fsdp=True, index=(d, 0))
        zero = shardings.zero1_layout(lay.splits, mesh21, index=d, shards=lay)
        assert set(out["params"]) == set(params)
        for k, p in params.items():
            assert np.array_equal(out["params"][k], lay.local(k, p).numpy()), k
        parts = {k: zero.part(k, lay.local(k, m)) for k, m in mu.items()}
        parts = {k: v for k, v in parts.items() if v is not None}
        assert set(out["mu"]) == set(parts)
        for k, v in parts.items():
            assert np.array_equal(out["mu"][k], v.numpy()), k
