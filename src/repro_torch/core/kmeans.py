"""k-means (Lloyd's + k-means++ init, best of several restarts): the final
hard-clustering step of spectral clustering (paper Sec. 1/2.1).

Every nearest-centre search is one pass of ``kernels.kmeans_dist`` (its
plain twin on the CPU): distances, minimum and argmin, with no (n, k, d)
tensor.  The seeding keeps a running minimum, so each draw reads x once
against its one new centre.  Restarts run one after another.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels.kmeans_dist import ops as dist_ops


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    labels: torch.Tensor  # (n,) int64
    inertia: torch.Tensor  # scalar


@spans.span("sped.kmeans.init")
def _plusplus_init(generator: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding, drawn with ``torch.multinomial``; d2 is the
    running minimum over the centres drawn so far."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first[0]]
    d2 = None
    for i in range(1, k):
        d2 = dist_ops.running_min(x, centroids[i - 1:i], d2)
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
        _, labels = dist_ops.nearest(x, c)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (n, k)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ x
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1)[:, None], c)
    d2, labels = dist_ops.nearest(x, c)
    inertia = torch.sum(d2)
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
