"""Stable cluster ids across re-solves.

k-means labels are defined up to permutation, and every re-solve can
permute them.  :class:`LabelTracker` matches each new labelling to the
previous one by greedy maximum-overlap assignment (the greedy of
``kmeans.cluster_agreement``, returning the permutation instead of the
score) and relabels accordingly.
"""
from __future__ import annotations

import numpy as np
import torch


def overlap_matrix(ref: torch.Tensor, new: torch.Tensor, k: int) -> torch.Tensor:
    """(k, k) float32 counts: [i, j] = #nodes with ref label i and new
    label j (exact in fp32 up to 2^24 nodes)."""
    m = torch.zeros((k, k), dtype=torch.float32, device=new.device)
    m.index_put_((ref.long(), new.long()),
                 torch.ones(new.shape, dtype=torch.float32, device=new.device),
                 accumulate=True)
    return m


def _greedy_perm(conf: torch.Tensor) -> torch.Tensor:
    """perm[j] = stable id for new label j, by repeatedly taking the
    largest remaining overlap cell (the first in row-major order among
    ties, as JAX's argmax); each pick eliminates one row and column, so k
    picks give a permutation."""
    k = conf.shape[0]
    conf = conf.clone()
    perm = torch.zeros((k,), dtype=torch.int64, device=conf.device)
    for _ in range(k):
        idx = torch.argmax(conf)
        i, j = idx // k, idx % k
        perm[j] = i
        conf[i, :] = -1.0
        conf[:, j] = -1.0
    return perm


def match_labels(ref: torch.Tensor, new: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Permute ``new``'s label ids to maximize (greedy) overlap with
    ``ref``.  Returns (relabelled, perm) with relabelled = perm[new]."""
    perm = _greedy_perm(overlap_matrix(ref, new, k))
    return perm[new.long()], perm


def label_churn(prev, new) -> float:
    """Fraction of nodes whose STABLE id changed between two servings of
    the same node set (successive :meth:`LabelTracker.update` outputs)."""
    prev = prev.cpu().numpy() if isinstance(prev, torch.Tensor) else np.asarray(prev)
    new = new.cpu().numpy() if isinstance(new, torch.Tensor) else np.asarray(new)
    if prev.shape != new.shape:
        raise ValueError(f"label shapes differ: {prev.shape} vs {new.shape}")
    if prev.size == 0:
        return 0.0
    return float(np.mean(prev != new))


class LabelTracker:
    """Per-session label continuity: feed each fresh labelling through
    :meth:`update`, read back stable ids."""

    def __init__(self, num_clusters: int):
        self.k = num_clusters
        self.ref: torch.Tensor | None = None

    def update(self, labels: torch.Tensor) -> torch.Tensor:
        labels = torch.as_tensor(labels)
        if self.ref is None:
            self.ref = labels
            return labels
        stable, _ = match_labels(self.ref, labels, self.k)
        self.ref = stable
        return stable
