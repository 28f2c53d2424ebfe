"""Wrappers of the limit-series step on a dense L and on edge lists.

The tensor's device picks the path: a CUDA tensor goes through the
hand-written kernel (``kernel.py``) or the call raises; a CPU tensor goes
through the plain PyTorch twin (``ref.py``).  Inputs are cast to fp32
first, so a bf16 L works on both.  Unlike the JAX package, nothing is
padded to 256-row blocks or 128 lanes: the kernel masks its ragged edge.

``poly_step_edges`` and ``limit_series_apply_edges`` are the same step on
an edge-list graph: the node-blocked SpMM (K2) with the AXPY in its
epilogue, ``alpha = -c, beta = 1``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.kernels.laplacian_poly import kernel, ref


def _fp32(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous()


def poly_step(l_mat: torch.Tensor, u: torch.Tensor, c) -> torch.Tensor:
    """out = U - c (L @ U), fp32, any n."""
    l_mat, u = _fp32(l_mat), _fp32(u)
    if u.device.type == "cuda":
        return kernel.poly_step(l_mat, u, float(c))
    return ref.poly_step(l_mat, u, c)


def dense_matvec_panel(l_mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """L @ U, fp32: the unfused product K5 is measured against."""
    l_mat, u = _fp32(l_mat), _fp32(u)
    if u.device.type == "cuda":
        return kernel.dense_matvec_panel(l_mat, u)
    return ref.dense_matvec_panel(l_mat, u)


def poly_step_edges(blocking: es_ops.NodeBlocking, u: torch.Tensor,
                    c) -> torch.Tensor:
    """out = U - c (L @ U) on edge-list operands: one node-blocked SpMM
    with the AXPY folded into its epilogue."""
    return es_ops.edge_spmm_blocked(blocking, u, alpha=-c, beta=1.0)


def limit_series_apply_edges(blocking: es_ops.NodeBlocking, v: torch.Tensor,
                             *, degree: int,
                             scale: float = 1.0) -> torch.Tensor:
    """-(I - scale L / degree)^degree @ V, matrix-free, one fused
    node-blocked step per degree, over the blocking's row CSR built once."""
    if v.shape[0] != blocking.num_nodes:
        raise ValueError(f"panel rows {v.shape[0]} != blocking num_nodes "
                         f"{blocking.num_nodes}")
    c = scale / degree
    rows = es_ops.blocking_rows(blocking)
    u = v
    for _ in range(degree):
        u = es_ops.edge_spmm_rows_nb(rows, u, alpha=-c, beta=1.0)
    return -u


def limit_series_apply(l_mat: torch.Tensor, v: torch.Tensor, *, degree: int,
                       scale: float = 1.0) -> torch.Tensor:
    """-(I - scale L / degree)^degree @ V with one fused K5 per step."""
    l_mat, u = _fp32(l_mat), _fp32(v)
    c = scale / degree
    for _ in range(degree):
        u = poly_step(l_mat, u, c)
    return -u
