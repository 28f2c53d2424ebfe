"""The device generators, drawn on the CPU at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from spedbench.graphs import kronecker, planted_partition as pp

SBM = {"num_nodes": 6000, "num_blocks": 30, "avg_degree_in": 16,
       "avg_degree_out": 1}
G500 = {"scale": 12, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05],
        "structure_seed": 22}


def _pairs(edges: torch.Tensor, n: int) -> torch.Tensor:
    lo = torch.minimum(edges[:, 0], edges[:, 1]).long()
    hi = torch.maximum(edges[:, 0], edges[:, 1]).long()
    return lo * n + hi


def test_block_sizes_differ_by_at_most_one():
    sizes = pp.block_sizes(4194304, 30)
    assert sizes.sum() == 4194304 and sizes.max() - sizes.min() == 1


def test_pair_counts_follow_the_expected_edge_count():
    n, nb = 4194304, 30
    counts = pp.pair_counts(n, nb, 16.0, 1.0, np.random.default_rng(3))
    assert counts.shape == (nb * (nb + 1) // 2, 3)
    within = counts[counts[:, 0] == counts[:, 1], 2].sum()
    across = counts[counts[:, 0] != counts[:, 1], 2].sum()
    # n d_in / 2 within, n d_out / 2 across, binomial spread ~ sqrt
    assert abs(within - n * 8) < 5 * np.sqrt(n * 8)
    assert abs(across - n / 2) < 5 * np.sqrt(n / 2)


def _blocks(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return pp.blocks(params, seed, gen, "cpu")


def test_planted_partition_edges():
    n = 60000  # blocks of 2,000: few self loops and duplicates to drop
    edges, labels = _blocks({**SBM, "num_nodes": n}, 7)
    assert labels.shape == (n,) and edges.shape[1] == 2
    assert int(edges.min()) >= 0 and int(edges.max()) < n
    assert not bool((edges[:, 0] == edges[:, 1]).any())
    keys = _pairs(edges, n)
    assert torch.unique(keys).numel() == keys.numel()  # duplicates merged
    deg = torch.bincount(edges.reshape(-1).long(), minlength=n)
    assert int(deg.min()) >= 1  # isolated nodes chained
    # the degree statistics of d_in = 16, d_out = 1 (a Poisson(17) row)
    assert abs(float(deg.float().mean()) - 17.0) < 0.5
    assert abs(float(deg.float().var()) - 17.0) < 3.0
    same = labels[edges[:, 0].long()] == labels[edges[:, 1].long()]
    assert abs(float(same.float().mean()) - 16 / 17) < 0.01
    np.testing.assert_array_equal(
        np.bincount(labels.numpy(), minlength=30), pp.block_sizes(n, 30))


def test_the_committed_sbm_has_the_production_edge_count():
    """sbm4m's degrees give n (d_in + d_out) / 2 = 2^26 edges at its 16:1
    in:out ratio."""
    from spedbench import cell as cells

    cfg = cells.load("sbm4m.limit251").config
    d_in, d_out = cfg["avg_degree_in"], cfg["avg_degree_out"]
    assert cfg["num_nodes"] * (d_in + d_out) / 2 == pytest.approx(2 ** 26)
    assert d_in / d_out == pytest.approx(16.0)


def test_planted_partition_permutation_is_a_bijection():
    n = SBM["num_nodes"]
    plain, labels = _blocks(SBM, 11)
    perm = pp.generate(SBM, 11, "cpu")
    assert perm.dtype == torch.int32 and perm.shape == plain.shape
    # unpermuted ids arrive sorted by block; permuted ones do not
    assert bool((labels[1:] >= labels[:-1]).all())
    # the same edges under one relabelling of the ids: the map from each
    # plain id to its permuted id is a function and a bijection
    ids = torch.full((n,), -1, dtype=torch.long)
    ids[plain.reshape(-1)] = perm.reshape(-1).long()
    assert torch.equal(ids[plain], perm.long())
    assert torch.equal(torch.sort(ids).values, torch.arange(n))
    assert not torch.equal(ids, torch.arange(n))
    # so the block structure is kept, now scattered over the ids
    permuted = torch.empty_like(labels)
    permuted[ids] = labels
    assert not bool((permuted[1:] >= permuted[:-1]).all())
    same_plain = labels[plain[:, 0]] == labels[plain[:, 1]]
    same_perm = permuted[perm[:, 0].long()] == permuted[perm[:, 1].long()]
    assert torch.equal(same_plain, same_perm)


def test_planted_partition_is_seeded():
    a = pp.generate(SBM, 5, "cpu")
    b = pp.generate(SBM, 5, "cpu")
    c = pp.generate(SBM, 6, "cpu")
    assert torch.equal(a, b)
    assert not (a.shape == c.shape and torch.equal(a, c))


def test_planted_partition_takes_a_large_seed():
    edges = pp.generate({**SBM, "num_nodes": 600}, 2**31 + 12345, "cpu")
    assert edges.shape[0] > 0


def test_kronecker_edges():
    n = 1 << G500["scale"]
    m = G500["edgefactor"] * n
    edges = kronecker.generate(G500, 9, "cpu")
    assert edges.dtype == torch.int32 and edges.shape[1] == 2
    assert int(edges.min()) >= 0 and int(edges.max()) < n
    assert not bool((edges[:, 0] == edges[:, 1]).any())  # self loops dropped
    # only self loops are dropped: P(same bit) = A + D per bit
    loops = m - edges.shape[0]
    assert 0 <= loops < 0.05 * m
    keys = _pairs(edges, n)
    assert torch.unique(keys).numel() < keys.numel()  # duplicates kept
    deg = torch.bincount(edges.reshape(-1).long(), minlength=n)
    assert int((deg == 0).sum()) > 0  # isolated vertices kept
    assert float(deg.float().mean()) == pytest.approx(2 * edges.shape[0] / n)
    assert int(deg.max()) > 50 * float(deg.float().mean())  # skewed: hubs


def test_kronecker_quadrant_probabilities():
    """Two laws of the initiator that the vertex permutation keeps: an
    edge's endpoints agree on a bit with probability A + D, so a draw is a
    self loop with probability (A + D)^SCALE; and the vertex with every bit
    0 has expected degree m ((A + B)^SCALE + (A + C)^SCALE), the largest."""
    scale, m = G500["scale"], G500["edgefactor"] << G500["scale"]
    a, b, c, d = G500["initiator"]
    loops, top = [], []
    for seed in range(4):
        edges = kronecker.generate({**G500, "structure_seed": seed}, 0, "cpu")
        loops.append(m - edges.shape[0])
        top.append(int(torch.bincount(edges.reshape(-1).long()).max()))
    want_loops = m * (a + d) ** scale
    assert abs(np.mean(loops) - want_loops) < 3 * np.sqrt(want_loops / 4)
    want_top = m * ((a + b) ** scale + (a + c) ** scale)
    assert abs(np.mean(top) - want_top) < 0.05 * want_top


def test_kronecker_is_seeded():
    a = kronecker.generate(G500, 4, "cpu")
    b = kronecker.generate(G500, 4, "cpu")
    assert torch.equal(a, b)


def test_kronecker_seeds_shuffle_one_graph():
    """Every run seed gets the structure seed's graph, its edges in another
    order: the same multiset of edges under the same ids."""
    a = kronecker.generate(G500, 4, "cpu")
    c = kronecker.generate(G500, 5, "cpu")
    other = kronecker.generate({**G500, "structure_seed": 23}, 4, "cpu")
    n = 1 << G500["scale"]
    assert not torch.equal(a, c)
    assert torch.equal(torch.sort(_pairs(a, n)).values,
                       torch.sort(_pairs(c, n)).values)
    assert not torch.equal(torch.bincount(a.reshape(-1).long(), minlength=n),
                           torch.bincount(other.reshape(-1).long(), minlength=n))
