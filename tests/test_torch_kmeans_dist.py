"""k-means' nearest-centre search (``kernels/kmeans_dist``) on the CPU.

The ``ops`` routes of CPU tensors are the plain twin, bitwise the
broadcast min / argmin; k-means and its k-means++ seeding through them
give the same tensors, bit for bit, as the broadcast k-means they
replaced (frozen below).  tests/test_torch_cuda.py holds the CUDA kernel
to the twin on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import kmeans as km
from repro_torch.kernels.kmeans_dist import kernel, ops, ref


def _sq_dists(x, c):
    return torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)


def _old_plusplus_init(generator, x, k):
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first[0]]
    for i in range(1, k):
        d2 = torch.min(_sq_dists(x, centroids[:i]), dim=1).values
        total = torch.sum(d2)
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            torch.full_like(d2, 1.0 / n))
        idx = torch.multinomial(probs, 1, generator=generator)
        centroids[i] = x[idx[0]]
    return centroids


def _old_lloyd(x, centroids, iters):
    k = centroids.shape[0]
    c = centroids
    for _ in range(iters):
        labels = torch.argmin(_sq_dists(x, c), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ x
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1)[:, None], c)
    d2 = _sq_dists(x, c)
    return c, torch.argmin(d2, dim=1), torch.sum(torch.min(d2, dim=1).values)


def _old_kmeans(generator, x, k, iters=25, restarts=8):
    results = [_old_lloyd(x, _old_plusplus_init(generator, x, k), iters)
               for _ in range(restarts)]
    best = torch.argmin(torch.stack([r[2] for r in results]))
    return tuple(torch.stack([r[i] for r in results])[best] for i in range(3))


def _points(seed: int, n: int, d: int, blobs: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if blobs:
        x = 0.2 * x + 4.0 * rng.normal(size=(blobs, d))[rng.integers(0, blobs, n)]
    return torch.from_numpy(x.astype(np.float32))


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("n,m,d", [(1000, 3, 4), (513, 1, 64), (4097, 37, 5),
                                   (2000, 30, 30), (7, 9, 1), (300, 5, 65)])
def test_cpu_route_is_the_broadcast_min_and_argmin(n, m, d):
    x = _points(n + m, n, d)
    c = _points(d, m, d)
    d2 = _sq_dists(x, c)
    got_min, got_arg = ops.nearest(x, c)
    _same(got_min, torch.min(d2, dim=1).values)
    _same(got_arg, torch.argmin(d2, dim=1))
    _same(ops.running_min(x, c, None), torch.min(d2, dim=1).values)


def test_cpu_route_breaks_ties_at_the_lowest_centre():
    x = torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, 0.0]])
    c = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [1.0, 2.0]])
    got_min, got_arg = ops.nearest(x, c)
    _same(got_arg, torch.tensor([0, 0, 0]))
    _same(got_min, torch.tensor([1.0, 1.0, 1.0]))


@pytest.mark.parametrize("m,d", [(8, 3), (30, 30)])
def test_running_min_is_the_min_over_every_centre(m, d):
    x = _points(5, 3000, d)
    c = _points(6, m, d)
    run = None
    for j in range(m):
        run = ops.running_min(x, c[j:j + 1], run)
    _same(run, torch.min(_sq_dists(x, c), dim=1).values)
    half = ops.running_min(x, c[: m // 2], None)
    _same(ops.running_min(x, c[m // 2:], half), run)


@pytest.mark.parametrize("seed,n,d,k", [(0, 500, 3, 3), (1, 2000, 8, 8),
                                        (2, 1500, 30, 30)])
def test_plusplus_init_is_what_it_was(seed, n, d, k):
    x = _points(seed, n, d, blobs=k)
    want = _old_plusplus_init(torch.Generator().manual_seed(seed), x, k)
    got = km._plusplus_init(torch.Generator().manual_seed(seed), x, k)
    _same(got, want)


@pytest.mark.parametrize("seed,n,d,k,restarts", [(3, 600, 4, 4, 3),
                                                 (4, 1200, 30, 30, 2),
                                                 (5, 800, 2, 5, 8)])
def test_kmeans_is_what_it_was(seed, n, d, k, restarts):
    x = _points(seed, n, d, blobs=k)
    want = _old_kmeans(torch.Generator().manual_seed(seed), x, k,
                       restarts=restarts)
    got = km.kmeans(torch.Generator().manual_seed(seed), x, k,
                    restarts=restarts)
    for g, w in zip((got.centroids, got.labels, got.inertia), want):
        _same(g, w)


def test_kernel_refuses_cpu_tensors_and_counts_nothing():
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.kmeans_dist(torch.zeros(4, 2), torch.zeros(1, 2))
    assert kernels.launch_counts()["kmeans_dist"] == 0


def test_twin_is_the_sum_of_squared_differences():
    x = torch.tensor([[1.0, 2.0, 3.0]])
    c = torch.tensor([[1.0, 0.0, 0.0], [0.0, 2.0, 1.0]])
    _same(ref.sq_dists(x, c), torch.tensor([[13.0, 5.0]]))
    got_min, got_arg = ref.nearest(x, c)
    _same(got_min, torch.tensor([5.0]))
    _same(got_arg, torch.tensor([1]))
