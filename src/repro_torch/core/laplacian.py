"""Graph Laplacian construction and matrix-free operators.

L = D - A = X^T W X, where X is the edge incidence matrix: the row of
edge e = (i, j), i < j, has +1 at i and -1 at j (paper Sec. 2).  Edge
lists are int32 ``src``/``dst`` with src <= dst (canonicalized on
construction) and fp32 weights, all on one device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class EdgeList(NamedTuple):
    """Canonical edge representation: src < dst per row, fp32 weights."""

    src: torch.Tensor  # (E,) int32, src < dst
    dst: torch.Tensor  # (E,) int32
    weight: torch.Tensor  # (E,) float32
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x)  # a copy: buffers handed over may be read-only
    return torch.as_tensor(x, dtype=dtype, device=device)


def make_edge_list(edges, num_nodes: int, weights=None,
                   *, device=None) -> EdgeList:
    """Canonicalize an (E, 2) array of node pairs into an EdgeList."""
    dev = resolve_device(device)
    edges = _as_tensor(edges, torch.int32, dev)
    src = torch.minimum(edges[:, 0], edges[:, 1]).contiguous()
    dst = torch.maximum(edges[:, 0], edges[:, 1]).contiguous()
    if weights is None:
        weights = torch.ones((edges.shape[0],), dtype=torch.float32, device=dev)
    else:
        weights = _as_tensor(weights, torch.float32, dev)
    return EdgeList(src=src, dst=dst, weight=weights, num_nodes=int(num_nodes))


def pad_edge_list(g: EdgeList, capacity: int) -> EdgeList:
    """Pad to a fixed edge capacity with inert zero-weight slots (0, 0)."""
    e = g.num_edges
    if capacity < e:
        raise ValueError(f"capacity {capacity} < num_edges {e}")
    if capacity == e:
        return g
    pad = capacity - e
    zi = torch.zeros((pad,), dtype=torch.int32, device=g.device)
    return EdgeList(
        src=torch.cat([g.src, zi]),
        dst=torch.cat([g.dst, zi]),
        weight=torch.cat([g.weight, torch.zeros((pad,), dtype=torch.float32,
                                                device=g.device)]),
        num_nodes=g.num_nodes,
    )


def incidence_matrix(g: EdgeList) -> torch.Tensor:
    """Dense incidence matrix X (E x N): +1 at src, -1 at dst (written
    second, so a self loop's row holds a single -1, as in the JAX
    package)."""
    rows = torch.arange(g.num_edges, device=g.device)
    x = torch.zeros((g.num_edges, g.num_nodes), dtype=torch.float32,
                    device=g.device)
    x[rows, g.src.long()] = 1.0
    x[rows, g.dst.long()] = -1.0
    return x


def adjacency_dense(g: EdgeList) -> torch.Tensor:
    n = g.num_nodes
    a = torch.zeros((n * n,), dtype=torch.float32, device=g.device)
    s, d = g.src.long(), g.dst.long()
    a.index_add_(0, s * n + d, g.weight)
    a.index_add_(0, d * n + s, g.weight)
    return a.view(n, n)


def degrees(g: EdgeList) -> torch.Tensor:
    d = torch.zeros((g.num_nodes,), dtype=torch.float32, device=g.device)
    d.index_add_(0, g.src, g.weight)
    d.index_add_(0, g.dst, g.weight)
    return d


def laplacian_dense(g: EdgeList) -> torch.Tensor:
    """L = D - A, symmetric PSD."""
    a = adjacency_dense(g)
    return torch.diag(a.sum(dim=1)) - a


def normalized_laplacian_dense(g: EdgeList, eps: float = 1e-12) -> torch.Tensor:
    """I - D^-1/2 A D^-1/2; isolated nodes keep a zero row and column of
    D^-1/2 A D^-1/2."""
    a = adjacency_dense(g)
    d = a.sum(dim=1)
    inv_sqrt = torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=eps)),
                           torch.zeros_like(d))
    return (torch.eye(g.num_nodes, device=g.device)
            - (inv_sqrt[:, None] * a) * inv_sqrt[None, :])


def edge_matvec_arrays(src: torch.Tensor, dst: torch.Tensor,
                       weight: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Raw-array Laplacian matvec sum_e w_e x_e (x_e^T v): a gather of both
    endpoints and two ``index_add_`` scatters.  ``v`` is (n,) or (n, k);
    zero-weight slots are inert."""
    src, dst = src.long(), dst.long()  # int64 indices take the fast path
    diff = v.index_select(0, src) - v.index_select(0, dst)  # X @ v
    wdiff = weight * diff if diff.dim() == 1 else weight[:, None] * diff
    out = torch.zeros_like(v)
    out.index_add_(0, src, wdiff)
    out.index_add_(0, dst, -wdiff)
    return out


def laplacian_matvec(g: EdgeList, v: torch.Tensor) -> torch.Tensor:
    """L @ v computed edge-wise; never materializes L."""
    return edge_matvec_arrays(g.src, g.dst, g.weight, v)


def minibatch_laplacian_matvec(src: torch.Tensor, dst: torch.Tensor,
                               weight: torch.Tensor, v: torch.Tensor,
                               num_edges_total: int) -> torch.Tensor:
    """Unbiased estimate of L @ v from a minibatch of B edges.

    E[(E_total / B) * sum_{e in batch} w_e x_e x_e^T v] = L v when the
    edges are drawn uniformly with replacement: the stochastic
    optimization model of the paper (Sec. 3).  ``v`` is (n,) or (n, k).
    """
    scaled = weight * (num_edges_total / src.shape[0])
    return edge_matvec_arrays(src, dst, scaled, v)


def spectral_radius_upper_bound(g: EdgeList) -> torch.Tensor:
    """lambda_max(L) <= 2 * max weighted degree (paper Sec. 5.4)."""
    return 2.0 * torch.max(degrees(g))


# ---------------------------------------------------------------------------
# Edge incidence graph (Sec. 4.3, Table 1).
# ---------------------------------------------------------------------------

def edge_inner_product(si, di, sj, dj) -> torch.Tensor:
    """x_ei^T x_ej per Table 1 of the paper.

    repeated -> 2; serial (one shared node at opposite signs) -> -1;
    converging/diverging (one shared node at the same sign) -> +1;
    disconnected -> 0.  Signs follow the min/max encoding: +1 at src,
    -1 at dst.
    """
    si, di, sj, dj = (torch.as_tensor(a) for a in (si, di, sj, dj))
    return ((si == sj).float()  # +1 * +1
            + (di == dj).float()  # -1 * -1
            - (si == dj).float()  # +1 * -1
            - (di == sj).float())  # -1 * +1


class EdgeIncidence(NamedTuple):
    """Padded adjacency of the edge incidence graph.

    Node u of this graph is edge u of the original graph.  Two edges are
    adjacent iff they share an endpoint; every edge also has a self loop
    (paper footnote 1).  ``nbrs[e, :deg[e]]`` lists the neighbours, padded
    with ``e`` itself (never sampled: slots are drawn below ``deg``).
    """

    nbrs: torch.Tensor  # (E, max_deg) int32
    deg: torch.Tensor  # (E,) int32, incidence degree (self loop included)
    ip: torch.Tensor  # (E, max_deg) float32, x_e^T x_nbr per slot
    deg_star_inc: int  # upper bound 2 deg* - 1 on the incidence degree


def build_edge_incidence(g: EdgeList) -> EdgeIncidence:
    """Host-side (numpy) construction of the padded incidence-graph
    adjacency, on the graph's device.  The JAX package's builder, copied
    so that its arrays come out bitwise equal; like it, an edgeless graph
    raises (``max`` of no neighbour lists)."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    e = src.shape[0]
    n = g.num_nodes
    node2edges: list[list[int]] = [[] for _ in range(n)]
    for idx in range(e):
        node2edges[src[idx]].append(idx)
        node2edges[dst[idx]].append(idx)
    nbr_lists = []
    for idx in range(e):
        s = set(node2edges[src[idx]]) | set(node2edges[dst[idx]])
        s.add(idx)  # self loop
        nbr_lists.append(sorted(s))
    max_deg = max(len(l) for l in nbr_lists)
    nbrs = np.full((e, max_deg), 0, dtype=np.int32)
    deg = np.zeros((e,), dtype=np.int32)
    for idx, l in enumerate(nbr_lists):
        nbrs[idx, : len(l)] = l
        deg[idx] = len(l)
        nbrs[idx, len(l):] = idx  # pad with self (never sampled)
    nb = torch.from_numpy(nbrs).long()
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    ip = edge_inner_product(s_t[:, None], d_t[:, None], s_t[nb], d_t[nb])
    node_deg = np.zeros((n,), np.int64)
    np.add.at(node_deg, src, 1)
    np.add.at(node_deg, dst, 1)
    deg_star = int(node_deg.max()) if e else 1
    return EdgeIncidence(
        nbrs=torch.from_numpy(nbrs).to(g.device),
        deg=torch.from_numpy(deg).to(g.device),
        ip=ip.to(g.device), deg_star_inc=2 * deg_star - 1)
