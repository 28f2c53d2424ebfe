"""The EDGE stream for SPED: uniform minibatches of incidence rows (the
paper's stochastic optimization model, Sec. 3).

The batch at step t is a pure function of (seed, t), so a resumed run
seeks to its step instead of replaying the stream.  The JAX package's
TOKEN stream feeds its LM substrate, which the port leaves out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.laplacian import EdgeList


def mixed_seed(seed: int, index: int) -> int:
    """A 64-bit generator seed mixed from (seed, index) by numpy's
    SeedSequence: distinct pairs give unrelated streams."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


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
