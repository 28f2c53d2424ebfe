"""The reference's k-means, which takes its distances a block of rows at a
time, held bit for bit to the whole-broadcast form it replaced.  That
form is kept here alone, as the oracle: the same seeding draws, centres,
labels and inertia, on the float32 path and the TF32 control's, and no
distance temporary past ``pipeline.BLOCK_BYTES``."""
from __future__ import annotations

import pytest
import torch

from spedbench.reference import pipeline


def _broadcast_sq_dists(x, c):
    return torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)


def broadcast_plusplus(generator, x, k):
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    c = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c[0] = x[first[0]]
    for i in range(1, k):
        d2 = torch.min(_broadcast_sq_dists(x, c[:i]), dim=1).values
        total = torch.sum(d2)
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            torch.full_like(d2, 1.0 / n))
        c[i] = x[torch.multinomial(probs, 1, generator=generator)[0]]
    return c


def broadcast_lloyd(x, c, tf32):
    k = c.shape[0]
    for _ in range(pipeline.KMEANS_ITERS):
        labels = torch.argmin(_broadcast_sq_dists(x, c), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = pipeline.matmul(onehot.T, x, tf32)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1)[:, None], c)
    d2 = _broadcast_sq_dists(x, c)
    labels = torch.argmin(d2, dim=1)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    return c, labels, inertia


def broadcast_kmeans(generator, x, k, restarts, tf32):
    best_labels, best_inertia = None, None
    for _ in range(restarts):
        _, labels, inertia = broadcast_lloyd(
            x, broadcast_plusplus(generator, x, k), tf32)
        if best_inertia is None or bool(inertia < best_inertia):
            best_labels, best_inertia = labels, inertia
    return best_labels


def embedding(n, k, d, seed, device="cpu"):
    """Rows near k planted directions, normalised as the pipeline's
    embedding is."""
    g = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn((k, d), generator=g, device=device)
    member = torch.randint(0, k, (n,), generator=g, device=device)
    x = centres[member] + 0.5 * torch.randn((n, d), generator=g,
                                            device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _gens(seed, device="cpu"):
    return (torch.Generator(device=device).manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed))


def _budget(rows, d):
    """The budget that gives the seeding blocks of ``rows`` rows of d
    float32 columns, and Lloyd's passes over k centres rows // k."""
    return 2 * rows * d * 4


# (n, k, d, rows of a seeding block, or None for the committed budget)
SHAPES = [
    pytest.param(3000, 30, 30, None, id="one-block"),
    pytest.param(3001, 30, 30, 210, id="blocks-not-dividing-n"),
    pytest.param(400, 12, 30, 1, id="one-row-blocks"),
    pytest.param(2000, 1, 30, 64, id="k1"),
    pytest.param(1500, 20, 70, 640, id="d70"),
]


@pytest.mark.parametrize("tf32", [False, True], ids=["f32", "tf32"])
@pytest.mark.parametrize("n,k,d,rows", SHAPES)
def test_blocks_give_the_broadcast_bits(n, k, d, rows, tf32, monkeypatch):
    if rows is not None:
        monkeypatch.setattr(pipeline, "BLOCK_BYTES", _budget(rows, d))
    x = embedding(n, k, d, seed=n + k + d)
    # every seeding draw: the same centres, the generator left alike
    g_new, g_old = _gens(1234)
    c = pipeline.plusplus(g_new, x, k)
    assert torch.equal(c, broadcast_plusplus(g_old, x, k))
    assert torch.equal(g_new.get_state(), g_old.get_state())
    # Lloyd's passes from those seeds: centres, labels, inertia
    for got, want in zip(pipeline.lloyd(x, c, tf32),
                         broadcast_lloyd(x, c, tf32)):
        assert torch.equal(got, want)
    # the whole k-means, two restarts
    g_new, g_old = _gens(99)
    assert torch.equal(pipeline.kmeans(g_new, x, k, 2, tf32),
                       broadcast_kmeans(g_old, x, k, 2, tf32))
    assert torch.equal(g_new.get_state(), g_old.get_state())


def test_labels_give_the_broadcast_labels_of_a_panel(monkeypatch):
    """``labels`` as the harness calls it, on blocks of 5 rows."""
    monkeypatch.setattr(pipeline, "BLOCK_BYTES", _budget(30, 6))
    v = torch.randn((800, 8), generator=torch.Generator().manual_seed(3))
    clustering = {"drop_trivial": True, "kmeans_restarts": 3}
    emb = v[:, 1:7] / torch.clamp(
        torch.linalg.vector_norm(v[:, 1:7], dim=1, keepdim=True), min=1e-12)
    want = broadcast_kmeans(torch.Generator().manual_seed(42), emb, 6, 3,
                            False)
    assert torch.equal(pipeline.labels(v, clustering, 6, 41), want)


def test_distances_stay_in_the_block_budget(monkeypatch):
    """No call sees an (n, m, d) tensor past the budget, and each seeding
    draw takes the distances of its one new centre only."""
    n, k, d, restarts = 2000, 10, 30, 2
    budget = _budget(64 * k, d)
    monkeypatch.setattr(pipeline, "BLOCK_BYTES", budget)
    seen = []
    real = pipeline._sq_dists

    def recorded(x, c):
        seen.append((x.shape[0], c.shape[0]))
        return real(x, c)

    monkeypatch.setattr(pipeline, "_sq_dists", recorded)
    x = embedding(n, k, d, seed=5)
    pipeline.kmeans(torch.Generator().manual_seed(1), x, k, restarts, False)
    assert all(2 * rows * m * d * 4 <= budget for rows, m in seen)
    assert all(rows < n for rows, _ in seen)
    one = [(rows, m) for rows, m in seen if m == 1]
    lloyd = [(rows, m) for rows, m in seen if m == k]
    assert len(one) + len(lloyd) == len(seen)
    # one pass over the rows a draw, k - 1 draws a restart
    assert sum(rows for rows, _ in one) == (k - 1) * restarts * n
    assert sum(rows for rows, _ in lloyd) == (
        (pipeline.KMEANS_ITERS + 1) * restarts * n)


@pytest.mark.parametrize("n,row_bytes", [(10, 4), (1000, 8), (1001, 3),
                                         (5, 1 << 40), (1 << 22, 7200)])
def test_row_blocks_cover_the_rows_within_the_budget(n, row_bytes,
                                                     monkeypatch):
    monkeypatch.setattr(pipeline, "BLOCK_BYTES", 1000)
    blocks = pipeline.row_blocks(n, row_bytes)
    sizes = [b.stop - b.start for b in blocks]
    assert blocks[0].start == 0 and blocks[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    most = max(1, 1000 // (2 * row_bytes))
    assert max(sizes) <= most
    assert len(blocks) == -(-n // most)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(1 << 22, 30, 30), (1 << 17, 125, 125)],
                         ids=["cells-2^22x30x30", "d125"])
def test_blocks_give_the_broadcast_bits_on_the_card(n, k, d):
    """At the two cells' k-means shape (and at d = 125, where torch sums
    in lanes of 32), with the committed budget, against the whole
    broadcast on the card; the blocks' peak stays within the budget and
    the (n, k) one-hot of the centre update."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    pipeline._no_tf32()
    x = embedding(n, k, d, seed=7, device="cuda")
    for tf32 in (False, True):
        g_new, g_old = _gens(2024, "cuda")
        c = pipeline.plusplus(g_new, x, k)
        assert torch.equal(c, broadcast_plusplus(g_old, x, k))
        assert torch.equal(g_new.get_state(), g_old.get_state())
        for got, want in zip(pipeline.lloyd(x, c, tf32),
                             broadcast_lloyd(x, c, tf32)):
            assert torch.equal(got, want)
        g_new, g_old = _gens(31, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = pipeline.kmeans(g_new, x, k, 2, tf32)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        assert torch.equal(got, broadcast_kmeans(g_old, x, k, 2, tf32))
        # the budget, the one-hot in int64 and float32, and (n,) vectors
        assert grew <= pipeline.BLOCK_BYTES + 12 * n * k + 64 * n + (1 << 24)
