"""LM training in the port against the JAX package on the CPU, at
``smoke_config`` size, f32 (``COMPUTE_DTYPE`` patched to float32 in
both packages' ``layers`` and in ``repro``'s ``model``):

  * ``Model.train_loss`` gradients against ``jax.value_and_grad``, every
    leaf to 1e-5 of that leaf's largest |g|, in the seven families of the
    registry (dense, vlm, moe, MLA, ssm, hybrid, encdec); the losses to
    1e-6.  Measured here: at most 5.3e-6 (deepseek's MLA);
  * five steps of the port's ``dryrun.build_train_step`` against
    ``repro.launch.dryrun.build_train_step`` (no mesh) from one init tree
    and the same numpy batches: the losses to 1e-4, the gradient norms to
    1e-4 of their size (measured: 9.5e-7 and 1.2e-6).  Parameters after the steps are not compared:
    Adam's first updates are sign-like, so a gradient entry near zero
    whose sign differs in the last bits moves its parameter by 2 lr.

The JAX parameters are ``repro.models.model.init``'s, carried across by
``convert.lm_params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.launch import dryrun
from repro_torch.models import layers as tlayers
from repro_torch.models.frontends import frontend_spec
from repro_torch.train import optimizer as opt

FAMILIES = ["qwen3-4b", "llava-next-mistral-7b", "granite-moe-1b-a400m",
            "deepseek-v2-236b", "mamba2-2.7b", "zamba2-1.2b", "whisper-small"]
GRAD_TOL = 1e-5  # of each leaf's largest |g|
LOSS_TOL = 1e-4
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for these smoke-size models, restored after: the
    suite's parallel workers share the CPU, and a pool of threads per op
    turns seconds into minutes of contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)


def _configs(arch):
    return (jcfg.smoke_config(jcfg.get_arch(arch)),
            tcfg.smoke_config(tcfg.get_arch(arch)))


def _batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens, labels and the family's stub inputs, numpy, f32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    for name, (shape, _) in frontend_spec(cfg, b).items():
        out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _both(arch, seed=1):
    jc, tc = _configs(arch)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), jc))
    return jc, tc, tree, convert.lm_params_from_numpy(tc, tree, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_grads_match_jax(f32, arch):
    jc, tc, tree, model = _both(arch)
    batch = _batch(jc, 2, 64, seed=FAMILIES.index(arch))

    def loss_fn(p, b):
        return jmodel.train_loss(p, jc, b)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = model.train_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
    want = convert.lm_named_from_tree(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (name, err / scale)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_train_steps_match_repro(f32, monkeypatch, arch):
    # imported here, and XLA_FLAGS restored after the test: importing
    # repro.launch.dryrun asks for 512 host devices, which must reach
    # neither a JAX backend not yet started nor a child process
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as jdryrun

    jc, tc, tree, model = _both(arch, seed=3)
    fields = dict(lr=1e-3, warmup_steps=0, total_steps=STEPS)
    ocfg, jocfg = opt.OptConfig(**fields), jopt.OptConfig(**fields)
    state = opt.init(ocfg, dict(model.named_parameters()))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jocfg, jparams)
    jstep = jax.jit(jdryrun.build_train_step(jc, jocfg))
    step = dryrun.build_train_step(tc, ocfg)
    for i in range(STEPS):
        batch = _batch(jc, 2, 32, seed=100 + i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, m = step(model, state,
                               {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL, i
        gn, jgn = float(m["grad_norm"]), float(jm["grad_norm"])
        assert abs(gn - jgn) <= LOSS_TOL * jgn, i
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-9
    assert int(state.step) == int(jstate.step) == STEPS


def test_step_refuses_another_config():
    _, tc = _configs("qwen3-4b")
    other = dataclasses.replace(tc, num_layers=1)
    model = convert.Model(other, device="cpu")
    step = dryrun.build_train_step(tc, opt.OptConfig())
    with pytest.raises(ValueError, match="built for"):
        step(model, opt.init(opt.OptConfig(), dict(model.named_parameters())),
             {})
