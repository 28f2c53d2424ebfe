"""Planted-partition SBM drawn on the device, with the semantics of
``sparse_sbm_graph`` (the planted partition of the repository's
experiments): a binomial edge count per block pair, uniform endpoint
draws inside the two blocks, self loops dropped, duplicate pairs merged,
and every isolated node chained to the next node of its block
(:func:`blocks`).  :func:`generate` then permutes the node ids by a
seeded permutation, as real graphs do not arrive sorted by community.

The 465 binomial counts are drawn on the host from ``seed`` (exact in
int64); every per-edge array, and the permutation, is drawn on the
device by one ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch


def block_sizes(num_nodes: int, num_blocks: int) -> np.ndarray:
    """Equal blocks, the first ``num_nodes % num_blocks`` one node larger."""
    sizes = np.full((num_blocks,), num_nodes // num_blocks, dtype=np.int64)
    sizes[: num_nodes % num_blocks] += 1
    return sizes


def pair_counts(num_nodes: int, num_blocks: int, avg_degree_in: float,
                avg_degree_out: float, rng: np.random.Generator):
    """(block a, block b, edge count) for every pair a <= b: within a block
    Binomial(n_a (n_a - 1) / 2, d_in / (n_a - 1)), across blocks
    Binomial(n_a n_b, d_out / (n - n_a))."""
    sizes = block_sizes(num_nodes, num_blocks)
    rows = []
    for a in range(num_blocks):
        na = int(sizes[a])
        p_in = min(1.0, avg_degree_in / max(na - 1, 1))
        rows.append((a, a, int(rng.binomial(na * (na - 1) // 2, p_in))))
        p_out = min(1.0, avg_degree_out / max(num_nodes - na, 1))
        for b in range(a + 1, num_blocks):
            rows.append((a, b, int(rng.binomial(na * int(sizes[b]), p_out))))
    return np.asarray(rows, dtype=np.int64)


def blocks(params: dict, seed: int, gen: torch.Generator, device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(edges (E, 2) int64, block labels (n,) int64) on ``device``, the
    ids in block order; the per-edge draws come from ``gen``."""
    n = int(params["num_nodes"])
    nb = int(params["num_blocks"])
    dev = torch.device(device)
    sizes = block_sizes(n, nb)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    pairs = pair_counts(n, nb, float(params["avg_degree_in"]),
                        float(params["avg_degree_out"]),
                        np.random.default_rng(seed))

    counts = torch.as_tensor(pairs[:, 2], device=dev)
    which = torch.repeat_interleave(torch.arange(len(pairs), device=dev), counts)
    lo_a = torch.as_tensor(starts[pairs[:, 0]], device=dev)[which]
    lo_b = torch.as_tensor(starts[pairs[:, 1]], device=dev)[which]
    size_a = torch.as_tensor(sizes[pairs[:, 0]], device=dev)[which]
    size_b = torch.as_tensor(sizes[pairs[:, 1]], device=dev)[which]
    m = which.shape[0]
    del which
    i = lo_a + (torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
                * size_a).long()
    j = lo_b + (torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
                * size_b).long()
    del lo_a, lo_b, size_a, size_b
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.unique(torch.minimum(i, j) * n + torch.maximum(i, j))
    del i, j, keep
    lo, hi = key // n, key % n

    # chain each isolated node to the next node of its block
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    present[lo] = True
    present[hi] = True
    iso = torch.nonzero(~present).flatten()
    labels = torch.repeat_interleave(torch.arange(nb, device=dev),
                                     torch.as_tensor(sizes, device=dev))
    if iso.numel():
        blk = labels[iso]
        st = torch.as_tensor(starts[:-1], device=dev)[blk]
        sz = torch.as_tensor(sizes, device=dev)[blk]
        nxt = torch.where(sz > 1, st + (iso - st + 1) % sz, (iso + 1) % n)
        lo = torch.cat([lo, torch.minimum(iso, nxt)])
        hi = torch.cat([hi, torch.maximum(iso, nxt)])

    return torch.stack([lo, hi], dim=1), labels


def generate(params: dict, seed: int, device) -> torch.Tensor:
    """Edges (E, 2) int32 on ``device``: :func:`blocks` under a seeded
    permutation of the node ids."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    edges, _ = blocks(params, seed, gen, dev)
    perm = torch.randperm(int(params["num_nodes"]), generator=gen, device=dev)
    return perm[edges].int().contiguous()
