"""Graph generators of the paper's experiments (Sec. 5, App. A).

Host-side numpy, a copy of the JAX package's generators: the same seed
gives the same edges, node for node.  Each returns an EdgeList on the
requested device (``None`` = the CUDA card) plus the ground-truth labels
as a numpy array where the family has them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.laplacian import EdgeList, make_edge_list


def clique_graph(num_nodes: int, num_cliques: int, seed: int = 0,
                 max_short_circuit: int = 25, *, device=None):
    """k cliques of ~n/k nodes + 0..25 random cross edges per clique pair.

    Paper Sec. 5.4.  Returns (EdgeList, labels).
    """
    rng = np.random.default_rng(seed)
    sizes = np.full((num_cliques,), num_nodes // num_cliques, dtype=np.int64)
    sizes[: num_nodes % num_cliques] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    labels = np.zeros((num_nodes,), dtype=np.int32)
    for k in range(num_cliques):
        lo, hi = int(starts[k]), int(starts[k + 1])
        labels[lo:hi] = k
        members = np.arange(lo, hi)
        iu = np.triu_indices(len(members), k=1)
        edges.append(np.stack([members[iu[0]], members[iu[1]]], axis=1))
    # short circuits between every pair of cliques
    seen = set()
    cross = []
    for a in range(num_cliques):
        for b in range(a + 1, num_cliques):
            m = int(rng.integers(0, max_short_circuit + 1))
            for _ in range(m):
                i = int(rng.integers(starts[a], starts[a + 1]))
                j = int(rng.integers(starts[b], starts[b + 1]))
                if (i, j) not in seen:
                    seen.add((i, j))
                    cross.append((i, j))
    if cross:
        edges.append(np.asarray(cross, dtype=np.int64))
    all_edges = np.concatenate(edges, axis=0).astype(np.int32)
    return make_edge_list(all_edges, num_nodes, device=device), labels


def sbm_graph(num_nodes: int, num_blocks: int, p_in: float = 0.5,
              p_out: float = 0.01, seed: int = 0, *, device=None):
    """Stochastic block model (Holland et al. 1983).  Returns (EdgeList, labels)."""
    rng = np.random.default_rng(seed)
    labels = np.sort(rng.integers(0, num_blocks, size=num_nodes)).astype(np.int32)
    iu = np.triu_indices(num_nodes, k=1)
    same = labels[iu[0]] == labels[iu[1]]
    p = np.where(same, p_in, p_out)
    mask = rng.random(len(p)) < p
    edges = np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int32)
    # ensure no isolated nodes (attach to the next node)
    present = np.zeros(num_nodes, bool)
    present[edges.ravel()] = True
    extra = []
    for v in np.nonzero(~present)[0]:
        u = (v + 1) % num_nodes
        extra.append((min(u, v), max(u, v)))
    if extra:
        edges = np.concatenate([edges, np.asarray(extra, np.int32)], axis=0)
    return make_edge_list(edges, num_nodes, device=device), labels


def sparse_sbm_graph(num_nodes: int, num_blocks: int,
                     avg_degree_in: float = 8.0, avg_degree_out: float = 0.5,
                     seed: int = 0, *, device=None):
    """Memory-light SBM for large n: a binomial edge COUNT per block pair,
    then endpoint draws, so cost is O(E).  Returns (EdgeList, labels)."""
    rng = np.random.default_rng(seed)
    sizes = np.full((num_blocks,), num_nodes // num_blocks, dtype=np.int64)
    sizes[: num_nodes % num_blocks] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    labels = np.repeat(np.arange(num_blocks), sizes).astype(np.int32)
    chunks = []
    for a in range(num_blocks):
        na = int(sizes[a])
        # within-block: n_a * deg_in / 2 edges in expectation
        pairs_in = na * (na - 1) // 2
        p_in = min(1.0, avg_degree_in / max(na - 1, 1))
        m = rng.binomial(pairs_in, p_in)
        if m:
            i = rng.integers(starts[a], starts[a + 1], size=m)
            j = rng.integers(starts[a], starts[a + 1], size=m)
            chunks.append(np.stack([i, j], axis=1))
        for b in range(a + 1, num_blocks):
            nb = int(sizes[b])
            p_out = min(1.0, avg_degree_out / max(num_nodes - na, 1))
            m = rng.binomial(na * nb, p_out)
            if m:
                i = rng.integers(starts[a], starts[a + 1], size=m)
                j = rng.integers(starts[b], starts[b + 1], size=m)
                chunks.append(np.stack([i, j], axis=1))
    edges = (np.concatenate(chunks, axis=0) if chunks
             else np.zeros((0, 2), np.int64))
    edges = edges[edges[:, 0] != edges[:, 1]]  # drop self loops
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    edges = np.unique(np.stack([lo, hi], axis=1), axis=0)
    # ensure no isolated nodes (chain to the next node in the same block;
    # a size-1 block chains to its global neighbour instead)
    present = np.zeros(num_nodes, bool)
    present[edges.ravel()] = True
    extra = []
    for v in np.nonzero(~present)[0]:
        blk = labels[v]
        if int(sizes[blk]) > 1:
            u = int(starts[blk]) + (v - int(starts[blk]) + 1) % int(sizes[blk])
        else:
            u = (v + 1) % num_nodes
        extra.append((min(u, v), max(u, v)))
    if extra:
        edges = np.concatenate([edges, np.asarray(extra, np.int64)], axis=0)
    return (make_edge_list(edges.astype(np.int32), num_nodes, device=device),
            labels)


def power_law_graph(num_nodes: int, avg_degree: float = 8.0,
                    alpha: float = 2.5, seed: int = 0, dedup: bool = True,
                    *, device=None) -> EdgeList:
    """Chung-Lu style power-law graph (Pareto(alpha - 1) node weights), the
    skewed-degree regime the chunked node blocking exists for.
    ``dedup=False`` keeps duplicate draws as parallel unit-weight edges.
    Self loops are dropped.  Returns an EdgeList (no planted labels)."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(max(alpha - 1.0, 1e-3), size=num_nodes) + 1.0
    p = w / w.sum()
    m = max(int(num_nodes * avg_degree / 2), 1)
    src = rng.choice(num_nodes, size=m, p=p)
    dst = rng.choice(num_nodes, size=m, p=p)
    keep = src != dst
    lo = np.minimum(src[keep], dst[keep]).astype(np.int64)
    hi = np.maximum(src[keep], dst[keep]).astype(np.int64)
    edges = np.stack([lo, hi], axis=1)
    if dedup:
        edges = np.unique(edges, axis=0)
    if len(edges) == 0:  # degenerate tiny draw: keep the graph non-empty
        edges = np.asarray([[0, min(1, num_nodes - 1)]], np.int64)
    return make_edge_list(edges, num_nodes, device=device)


def ring_of_cliques(num_cliques: int, clique_size: int, *, device=None):
    """Deterministic well-clustered graph for exact tests."""
    n = num_cliques * clique_size
    edges = []
    labels = np.zeros((n,), dtype=np.int32)
    for k in range(num_cliques):
        lo = k * clique_size
        labels[lo: lo + clique_size] = k
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((lo + i, lo + j))
        nxt = ((k + 1) % num_cliques) * clique_size
        edges.append((min(lo, nxt), max(lo, nxt)))
    return (make_edge_list(np.asarray(edges, np.int32), n, device=device),
            labels)
