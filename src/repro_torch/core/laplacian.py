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


def spectral_radius_upper_bound(g: EdgeList) -> torch.Tensor:
    """lambda_max(L) <= 2 * max weighted degree (paper Sec. 5.4)."""
    return 2.0 * torch.max(degrees(g))
