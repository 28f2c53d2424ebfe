"""Common-neighbors link prediction (paper App. A.1).

Pipeline: drop edges w.p. p, score the missing pairs by their number of
common neighbors (Martinez et al. 2016), normalize the scores over the
missing pairs into probabilities, and return the completed WEIGHTED
graph whose Laplacian SPED then clusters (Fig. 5 setting).

The whole computation is host numpy, copied from the JAX package, so the
dropped edges and predicted weights come out bitwise the same; only the
returned EdgeList moves to the graph's device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.laplacian import EdgeList, make_edge_list


def common_neighbors_scores(adj: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """score(i, j) = |N(i) ∩ N(j)| computed via the squared adjacency."""
    a2 = adj @ adj
    return a2[pairs[:, 0], pairs[:, 1]]


def complete_graph(g: EdgeList, drop_prob: float = 0.2, seed: int = 0) -> EdgeList:
    """Drop edges, predict them back with common-neighbors probabilities.
    The result lies on the graph's device."""
    rng = np.random.default_rng(seed)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    w = g.weight.cpu().numpy()
    n = g.num_nodes

    keep = rng.random(len(src)) >= drop_prob
    kept = np.stack([src[keep], dst[keep]], axis=1)
    dropped = np.stack([src[~keep], dst[~keep]], axis=1)

    adj = np.zeros((n, n), dtype=np.float64)
    adj[kept[:, 0], kept[:, 1]] = w[keep]
    adj[kept[:, 1], kept[:, 0]] = w[keep]

    if len(dropped) == 0:
        return make_edge_list(kept, n, weights=w[keep], device=g.device)

    scores = common_neighbors_scores(adj, dropped).astype(np.float64)
    total = scores.sum()
    if total <= 0:
        probs = np.full(len(dropped), 1.0 / len(dropped))
    else:
        probs = scores / total
    # scale so the predicted mass matches the dropped mass (keeps the
    # degree distribution comparable to the original graph)
    pred_w = probs * float(w[~keep].sum())

    all_edges = np.concatenate([kept, dropped], axis=0)
    all_w = np.concatenate([w[keep], pred_w])
    pos = all_w > 1e-12
    return make_edge_list(all_edges[pos], n, weights=all_w[pos], device=g.device)
