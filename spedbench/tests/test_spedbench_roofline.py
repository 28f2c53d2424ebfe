"""Each byte and operation count of ``spedbench.roofline`` against a count
by hand."""
from __future__ import annotations

import pytest
import torch

from spedbench import roofline as rl


def test_bound_takes_the_larger_time():
    assert rl.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert rl.bound_s(0, 67e12) == pytest.approx(1.0)
    assert rl.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_k2_bytes_by_hand():
    # 10 half-edges: 10 ids + 10 weights = 80 B; 5 row pointers = 20 B;
    # a 4 x 2 panel in and out = 2 * 32 B
    assert rl.k2_bytes(10, 4, 2) == 80 + 20 + 64
    # the production shape of sbm4m: 71.3 M half-edges, n = 2^22, k = 32
    h, n, k = 71_299_936, 1 << 22, 32
    assert rl.k2_bytes(h, n, k) == h * 8 + (n + 1) * 4 + 2 * n * k * 4
    assert rl.bound_s(rl.k2_bytes(h, n, k), rl.k2_flops(h, n, k)) == \
        pytest.approx(0.4958e-3, rel=1e-3)


def test_k2_flops_by_hand():
    # 10 half-edges x 2 columns, a multiply and an add each = 40; the
    # epilogue 4 per element of the 4 x 2 panel = 32
    assert rl.k2_flops(10, 4, 2) == 40 + 32


def test_k1_bytes_by_hand():
    # 3 drawn edges x (2 ids + 1 weight) = 36 B; 5 touched rows of 2
    # floats = 40 B; the 4 x 2 output panel = 32 B
    assert rl.k1_bytes(3, 5, 4, 2) == 36 + 40 + 32
    assert rl.k1_flops(3, 4, 2) == 2 * 6 * 2 + 4 * 8


def test_eg_bytes_and_flops_by_hand():
    n, k = 6, 2
    assert rl.eg_bytes(n, k) == 5 * 12 * 4
    # K3: (2k)(2k + 1) / 2 = 10 entries x 2 x n; K4: 2 products of k x k
    # per row x 2 = 2 * 2 * 4 * n; the column scale n k
    assert rl.eg_flops(n, k) == 10 * 2 * n + 2 * 2 * 4 * n + n * k
    assert rl.mu_eg_step_bytes(n, k) == 3 * 12 * 4


def test_expected_touched_rows():
    # a path 0-1-2: degrees 1, 2, 1 of E = 2 edges; one draw touches two
    # rows for sure, so node 1 with probability 1, nodes 0 and 2 each 1/2
    deg = torch.tensor([1.0, 2.0, 1.0])
    assert rl.expected_touched_rows(deg, 1) == pytest.approx(2.0)
    # many draws touch every row
    assert rl.expected_touched_rows(deg, 200) == pytest.approx(3.0)
    # against a draw: 2^10 edges of a random graph, 300 draws
    gen = torch.Generator().manual_seed(0)
    n = 500
    edges = torch.randint(0, n, (1024, 2), generator=gen)
    edges = edges[edges[:, 0] != edges[:, 1]]
    d = torch.bincount(edges.reshape(-1), minlength=n).float()
    seen = []
    for _ in range(200):
        sel = torch.randint(0, edges.shape[0], (300,), generator=gen)
        seen.append(torch.unique(edges[sel].reshape(-1)).numel())
    assert rl.expected_touched_rows(d, 300) == pytest.approx(
        sum(seen) / len(seen), rel=0.01)


def test_step_bound_sums_the_factors_and_the_update():
    shapes = {"n": 1 << 22, "k": 32, "half_edges": 71_299_936, "degree": 251,
              "estimation": "exact_edges"}
    n, k, h = shapes["n"], shapes["k"], shapes["half_edges"]
    want = rl.bound_s(251 * rl.k2_bytes(h, n, k) + 3 * n * k * 4,
                      251 * rl.k2_flops(h, n, k) + rl.eg_flops(n, k))
    assert rl.step_bound_s(shapes) == pytest.approx(want)
    mb = {**shapes, "estimation": "minibatch", "batch_edges": 262144,
          "touched_rows": 491147.0}
    fb, ff = rl.factor_cost(mb)
    assert fb == pytest.approx(rl.k1_bytes(262144, 491147.0, n, k))
    assert rl.step_bound_s(mb) < rl.step_bound_s(shapes)
