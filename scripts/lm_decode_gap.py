"""Decode against prefill in both packages: the JAX package's own gap.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_decode_gap.py \\
        --arch mamba2-2.7b --layers 16

Runs on the CPU.  Builds ``--arch`` at a mid size (d_model 512, vocab
2048, SSM state 64 in heads of 64, chunk 64; the hybrid 8 heads of 64,
d_ff 2048, attention every 6 layers) and ``--layers`` deep from one JAX
``model.init`` (seed 0), carried to the port by
``convert.lm_params_from_numpy``.  Both packages prefill a numpy prompt
of 2 x 256 tokens in bf16, take 4 greedy decode steps fed JAX's argmax,
and hold each step's logits against a prefill of the prompt and the
tokens fed so far: the reading of chip_smoke.py's hold (b),
max |decode - prefill| / (atol + rtol |prefill|) at rtol = atol = 6e-2
(tests/test_arch_smoke.py's bar), printed for each package.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jcfg
from repro.models import model as jmodel
from repro_torch import configs as tcfg
from repro_torch import convert

TOL = 6e-2
BATCH, PROMPT, STEPS = 2, 256, 4


def _mid(cfg, layers: int):
    extra = ({"num_heads": 8, "num_kv_heads": 8, "head_dim": 64,
              "d_ff": 2048, "attn_every": 6}
             if cfg.family == "hybrid" else {})
    return dataclasses.replace(cfg, num_layers=layers, d_model=512,
                               vocab_size=2048, ssm_state=64,
                               ssm_headdim=64, ssm_chunk=64, **extra)


def _bar_use(got, want) -> float:
    return float(np.max(np.abs(got - want) / (TOL + TOL * np.abs(want))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="scripts/lm_decode_gap.py")
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--layers", type=int, default=16)
    args = ap.parse_args(argv)
    jc = _mid(jcfg.get_arch(args.arch), args.layers)
    tc = _mid(tcfg.get_arch(args.arch), args.layers)
    tree = jax.tree.map(np.asarray, jax.jit(jmodel.init, static_argnums=1)(
        jax.random.PRNGKey(0), jc))
    params = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(tc, tree, device="cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size,
                                             (BATCH, PROMPT), dtype=np.int32)
    prefill = jax.jit(lambda p, t, ms: jmodel.prefill(
        p, jc, {"tokens": t}, max_seq=ms), static_argnums=2)
    decode = jax.jit(lambda p, st, t: jmodel.decode_step(p, jc, st, t))

    logits, state = prefill(params, jnp.asarray(toks), PROMPT + STEPS)
    fed, jax_use = [], 0.0
    for i in range(STEPS):
        fed.append(np.argmax(np.asarray(logits), -1)[:, None].astype(np.int32))
        logits, state = decode(params, state, jnp.asarray(fed[-1]))
        ref, _ = prefill(params, jnp.asarray(np.concatenate([toks] + fed, 1)),
                         PROMPT + i + 1)
        jax_use = max(jax_use, _bar_use(np.asarray(logits), np.asarray(ref)))

    port_use = 0.0
    with torch.no_grad():
        logits, st = model.prefill({"tokens": torch.from_numpy(toks)},
                                   max_seq=PROMPT + STEPS)
        for i in range(STEPS):
            logits, st = model.decode_step(st, torch.from_numpy(fed[i]))
            ref, _ = model.prefill({"tokens": torch.from_numpy(
                np.concatenate([toks] + fed[:i + 1], 1))})
            port_use = max(port_use, _bar_use(logits.numpy(), ref.numpy()))
    print(f"{args.arch} layers {args.layers}: bar use of decode against "
          f"prefill, repro {jax_use:.3f}, repro_torch {port_use:.3f}")


if __name__ == "__main__":
    main()
