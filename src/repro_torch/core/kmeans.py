"""k-means (Lloyd's + k-means++ init, best of several restarts): the final
hard-clustering step of spectral clustering (paper Sec. 1/2.1).

Restarts run one after another, not batched, which keeps the
(n, k, d) distance tensor of one restart the peak memory at n = 2^20.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import spans


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    labels: torch.Tensor  # (n,) int64
    inertia: torch.Tensor  # scalar


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)


@spans.span("sped.kmeans.init")
def _plusplus_init(generator: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding, drawn with ``torch.multinomial``."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first[0]]
    for i in range(1, k):
        d2 = torch.min(_sq_dists(x, centroids[:i]), dim=1).values
        total = torch.sum(d2)
        # all points on chosen centroids: draw uniformly instead
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            torch.full_like(d2, 1.0 / n))
        idx = torch.multinomial(probs, 1, generator=generator)
        centroids[i] = x[idx[0]]
    return centroids


@spans.span("sped.kmeans.lloyd")
def _lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int) -> KMeansResult:
    k = centroids.shape[0]
    c = centroids
    for _ in range(iters):
        labels = torch.argmin(_sq_dists(x, c), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (n, k)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ x
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1)[:, None], c)
    d2 = _sq_dists(x, c)
    labels = torch.argmin(d2, dim=1)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    return KMeansResult(centroids=c, labels=labels, inertia=inertia)


def kmeans(generator: torch.Generator, x: torch.Tensor, k: int,
           iters: int = 25, restarts: int = 8) -> KMeansResult:
    """Best-of-`restarts` k-means; the generator lives on x's device."""
    results = [_lloyd(x, _plusplus_init(generator, x, k), iters)
               for _ in range(restarts)]
    best = torch.argmin(torch.stack([r.inertia for r in results]))
    return KMeansResult(
        centroids=torch.stack([r.centroids for r in results])[best],
        labels=torch.stack([r.labels for r in results])[best],
        inertia=torch.stack([r.inertia for r in results])[best],
    )


def cluster_agreement(labels, truth, k: int) -> torch.Tensor:
    """Greedy-matching clustering accuracy in [0, 1] (label-permutation
    invariant, adequate for well-separated test graphs)."""
    labels = torch.as_tensor(labels).long()
    truth = torch.as_tensor(truth, device=labels.device).long()
    conf = torch.zeros((k, k), dtype=torch.float32, device=labels.device)
    conf.index_put_((labels, truth),
                    torch.ones_like(labels, dtype=torch.float32),
                    accumulate=True)
    acc = torch.zeros((), dtype=torch.float32, device=labels.device)
    for _ in range(k):
        idx = torch.argmax(conf)
        i, j = idx // k, idx % k
        acc = acc + conf[i, j]
        conf[i, :] = -1.0
        conf[:, j] = -1.0
    return acc / labels.shape[0]
