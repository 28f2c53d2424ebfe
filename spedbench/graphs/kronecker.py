"""Graph500 Kronecker generator, drawn on the device.

The specification's reference generator (``kronecker_generator``): each
of ``edgefactor * 2^SCALE`` edges picks one quadrant of the initiator
(A, B, C, D) per bit of its endpoints, its row bit with probability
C + D and its column bit with probability B / (A + B) or D / (C + D)
given the row bit; then the vertex ids are permuted and the edge list is
shuffled, both by random permutations.  The benchmark's conventions on
top of it: self loops are dropped, duplicate draws stay as parallel unit
edges, and isolated vertices stay as empty rows.

The quadrant draws and the vertex permutation take
``params["structure_seed"]``, and the edge shuffle the run's seed, so
every seed gets the same graph under the same ids, its edges in another
order (and so each row's entries of the SpMM's row CSR, and the jobs'
panels, differ by seed).  The work of a Kronecker graph's SpMM depends on
its draw and on where its hubs land among the ids: with both taken from
the run's seed, seeds differed by up to 6 % a job while runs of one seed
agreed within about 1 %, and with the draw fixed but the ids permuted by
the seed, still by 6 % (PERF.md).
"""
from __future__ import annotations

import torch


def generate(params: dict, seed: int, device) -> torch.Tensor:
    """Edges (E, 2) int32 on ``device``: the graph of ``structure_seed``,
    its edges shuffled by ``seed``."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    a, b, c = (float(x) for x in params["initiator"][:3])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(params["structure_seed"]))
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = torch.zeros(m, dtype=torch.int32, device=dev)
    jj = torch.zeros(m, dtype=torch.int32, device=dev)
    for bit in range(scale):
        ii_bit = torch.rand(m, generator=gen, device=dev) > ab
        thresh = torch.where(ii_bit, c_norm, a_norm)
        jj_bit = torch.rand(m, generator=gen, device=dev) > thresh
        ii += ii_bit.int() << bit
        jj += jj_bit.int() << bit
        del ii_bit, jj_bit, thresh
    perm = torch.randperm(n, generator=gen, device=dev).int()
    ii, jj = perm[ii.long()], perm[jj.long()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = torch.randperm(m, generator=gen, device=dev)
    ii, jj = ii[order], jj[order]
    keep = ii != jj
    return torch.stack([ii[keep], jj[keep]], dim=1).contiguous()
