"""The port's LM training loop on the CPU, at ``smoke_config`` size: the
remat policies, gradient accumulation, checkpointed resume and the
``--mode lm`` shell.

  * remat: ``"full"``, ``"dots"`` and ``"none"`` give the same loss and
    gradients bitwise in the dense, moe, hybrid and encdec families (a
    recompute repeats the forward's ops on the same inputs); "full"
    recomputes the products in the backward pass, "dots" keeps them;
  * ``dryrun.build_train_step`` with 4 microbatches against 1 (the port
    of tests/test_system.py's test, in bf16, at its rtol 5e-3 / atol
    3e-3 on the parameters after the step, rtol 1e-3 on the loss);
  * the ports of tests/test_system.py's resume (6 steps, then 9 from the
    step-6 checkpoint) and granite ``--compress-grads`` tests; the
    resumed run ends bitwise equal to an uninterrupted one (parameters,
    moments, losses).
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import dryrun, train
from repro_torch.models.model import Model
from repro_torch.models.frontends import synthetic_frontend
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

CPU = torch.device("cpu")
LM = ["--mode", "lm", "--arch", "qwen3-4b", "--smoke", "--device", "cpu",
      "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for these smoke-size models, restored after: the
    suite's parallel workers share the CPU, and a pool of threads per op
    turns seconds into minutes of contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.products += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg):
    model = Model(cfg, CPU, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
             **synthetic_frontend(gen, cfg, 2)}
    loss, _ = model.train_loss(batch)
    counter = _CountProducts()
    with counter:
        loss.backward()
    return (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
            counter.products)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "whisper-small"])
def test_remat_policies_move_no_value(arch):
    base = smoke_config(get_arch(arch))
    runs = {policy: _loss_and_grads(dataclasses.replace(base, remat_policy=policy))
            for policy in ("none", "full", "dots")}
    loss, grads, products = runs["none"]
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], loss), policy
        for name, g in grads.items():
            assert torch.equal(runs[policy][1][name], g), (policy, name)
    assert runs["full"][2] > products  # the forward's products again
    if arch != "zamba2-1.2b":  # the hybrid's group remats in full anyway
        assert runs["dots"][2] == products


def test_unknown_remat_policy_is_refused():
    cfg = dataclasses.replace(smoke_config(get_arch("qwen3-4b")),
                              remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        _loss_and_grads(cfg)


def test_microbatched_train_step_matches_full_batch():
    """Gradient accumulation (4 slices) == one batch; each slice's loss is
    a per-token mean over equal slices, so their mean is the batch's."""
    cfg = smoke_config(get_arch("qwen3-4b"))
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, clip_norm=1e9,
                         weight_decay=0.0)
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    out = {}
    for mb in (1, 4):
        model = Model(cfg, CPU, torch.Generator().manual_seed(0))
        state = opt.init(ocfg, dict(model.named_parameters()))
        model, state, m = dryrun.build_train_step(cfg, ocfg, microbatches=mb)(
            model, state, batch)
        assert all(p.grad is None for p in model.parameters())
        out[mb] = (float(m["loss"]), dict(model.named_parameters()))
    assert out[4][0] == pytest.approx(out[1][0], rel=1e-3)
    for name, p in out[1][1].items():
        torch.testing.assert_close(out[4][1][name], p, rtol=5e-3, atol=3e-3)
    with pytest.raises(ValueError, match="microbatches"):
        dryrun.build_train_step(cfg, ocfg, microbatches=3)(model, state, batch)


def test_lm_training_resumes_bitwise(tmp_path):
    """The port of tests/test_system.py's fault injection: 6 steps with a
    checkpoint every 3, then a rerun to 9 resumes from step 6; it ends
    bitwise where an uninterrupted 9-step run ends."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    first = train.train_lm(train.parse_args(LM + ["--steps", "6"] + ck), CPU)
    resumed = train.train_lm(train.parse_args(LM + ["--steps", "9"] + ck), CPU)
    assert ckpt.latest_step(str(tmp_path / "ck")) == 9
    assert (first.start, resumed.start, len(resumed.losses)) == (0, 6, 3)
    whole = train.train_lm(train.parse_args(LM + ["--steps", "9"]), CPU)
    assert whole.losses == first.losses + resumed.losses
    assert int(resumed.opt_state.step) == int(whole.opt_state.step) == 9
    want = dict(whole.model.named_parameters())
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, want[name]), name
        assert torch.equal(resumed.opt_state.mu[name], whole.opt_state.mu[name])
        assert torch.equal(resumed.opt_state.nu[name], whole.opt_state.nu[name])


def test_lm_training_with_grad_compression(capsys):
    assert train.main(["--mode", "lm", "--arch", "granite-moe-1b-a400m",
                       "--smoke", "--steps", "4", "--compress-grads",
                       "--log-every", "100", "--device", "cpu"]) == 0
    assert "final loss" in capsys.readouterr().out
