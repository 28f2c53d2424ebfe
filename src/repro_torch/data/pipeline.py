"""Data pipelines.  Two streams feed the port:

  * TOKEN stream for the LM substrate: synthetic but deterministic.  The
    batch at step t is a pure function of (seed, t), and a data-parallel
    shard's rows a pure function of (seed, t, shard).
  * EDGE stream for SPED: uniform minibatches of incidence rows (the
    paper's stochastic optimization model, Sec. 3), same contract.

A resumed run seeks to its step instead of replaying the stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.laplacian import EdgeList
from repro_torch.device import resolve_device


def mixed_seed(seed: int, *index: int) -> int:
    """A 64-bit generator seed mixed from (seed, *index) by numpy's
    SeedSequence: distinct tuples give unrelated streams."""
    return int(np.random.SeedSequence([seed, *index]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Uniform random tokens in [0, vocab_size), drawn on the host from a
    generator seeded from (seed, step), so a batch is the same on every
    device; ``labels`` are the tokens rolled left by one."""

    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def _draw(self, rows: int, seed: int, device) -> dict:
        gen = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, self.vocab_size, (rows, self.seq_len),
                             generator=gen, dtype=torch.int32)
        toks = toks.to(resolve_device(device))
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

    def batch_at(self, step: int, device=None) -> dict:
        """The full global batch of ``step``."""
        return self._draw(self.global_batch, mixed_seed(self.seed, step),
                          device)

    def shard_batch_at(self, step: int, shard: int, num_shards: int,
                       device=None) -> dict:
        """Only shard ``shard``'s global_batch / num_shards rows, from a
        stream of their own seeded from (seed, step, shard): they are not
        a slice of ``batch_at(step)`` (nor are the JAX package's)."""
        if self.global_batch % num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split into {num_shards} shards")
        return self._draw(self.global_batch // num_shards,
                          mixed_seed(self.seed, step, shard), device)


@dataclasses.dataclass(frozen=True)
class EdgePipeline:
    """Uniform-with-replacement edge minibatches from a fixed graph."""

    graph: EdgeList
    batch_edges: int
    seed: int = 0

    def batch_at(self, step: int, sel: torch.Tensor | None = None) -> dict:
        """The batch of ``step``: B edge indices drawn on the graph's
        device from a generator seeded from (seed, step), or
        the injected ``sel``.  Returns the JAX package's four keys."""
        g = self.graph
        if sel is None:
            gen = torch.Generator(device=g.device).manual_seed(
                mixed_seed(self.seed, step))
            sel = torch.randint(0, g.num_edges, (self.batch_edges,),
                                generator=gen, device=g.device)
        sel = torch.as_tensor(sel, device=g.device).long()
        return {
            "src": g.src[sel],
            "dst": g.dst[sel],
            "weight": g.weight[sel],
            "num_edges_total": g.num_edges,
        }
