"""Batched LM serving launcher: prefill a batch of prompts, then decode
greedily one token a step.  CPU-sized with --smoke.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --smoke --prompt-len 16 --gen 8 \\
      --batch 2 --device cpu

Runs on the CUDA card unless --device names another device; without a
card and without --device it exits with code 2 and the device rule's
message before printing anything.  Prints the prefill time, the decode
time with its tokens per second, and the generated tokens; on the card
the times are CUDA events.  The default --arch is granite-moe-1b-a400m,
as in the JAX package's launcher; every configuration of the registry
serves (whisper's stub frames come from ``synthetic_frontend``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.frontends import synthetic_frontend
from repro_torch.models.model import Model, ServeState


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (b, gen) greedy tokens
    logits: list  # (b, vocab) f32: prefill's last position, then each step's
    prefill_ms: float
    decode_ms: float
    state: ServeState  # the caches after the last step


def _timed(device: torch.device, fn):
    """(fn(), ms): CUDA events around it on the card, the host clock
    elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def generate(model: Model, batch: dict, gen: int) -> Generation:
    """Prefill ``batch`` into caches of prompt + ``gen`` positions, then
    ``gen`` greedy decode steps: token i is the argmax of logits i."""
    s = batch["tokens"].shape[1]
    (logits, state), prefill_ms = _timed(
        model.device, lambda: model.prefill(batch, max_seq=s + gen))

    def decode():
        out, toks = [logits], []
        tok = logits.argmax(dim=-1, keepdim=True)
        for _ in range(gen):
            toks.append(tok)
            step, _ = model.decode_step(state, tok)
            out.append(step)
            tok = step.argmax(dim=-1, keepdim=True)
        return out, toks

    (all_logits, toks), decode_ms = _timed(model.device, decode)
    if not bool(torch.isfinite(torch.stack(all_logits)).all()):
        raise FloatingPointError("serving produced non-finite logits")
    return Generation(tokens=torch.cat(toks, dim=1), logits=all_logits,
                      prefill_ms=prefill_ms, decode_ms=decode_ms, state=state)


def serve(args, device: torch.device) -> torch.Tensor:
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    rng = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, device, rng)
    b = args.batch
    pipe = TokenPipeline(cfg.vocab_size, b, args.prompt_len, args.seed)
    batch = {"tokens": pipe.batch_at(0, device)["tokens"]}
    batch.update(synthetic_frontend(rng, cfg, b))
    out = generate(model, batch, args.gen)
    decode_s = out.decode_ms / 1e3
    print(f"prefill {args.prompt_len} toks x{b}: {out.prefill_ms:.1f} ms")
    print(f"decode {args.gen} steps: {out.decode_ms:.1f} ms "
          f"({args.gen * b / max(decode_s, 1e-9):.1f} tok/s)")
    print("generated:", out.tokens.tolist())
    return out.tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"python -m repro_torch.launch.serve: {e}", file=sys.stderr)
        return 2
    serve(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
