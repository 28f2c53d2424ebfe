"""ctypes wrappers of the incidence SpMM kernels (``csrc/edge_spmm.cu``).

K1 ``edge_spmm`` replaces ``repro/kernels/edge_spmm/kernel.py:94`` (the
one-hot MXU SpMM) with an fp32-atomic edge scatter; K2 ``edge_spmm_nb``
replaces ``repro/kernels/edge_spmm/kernel.py:151`` (the node-blocked
SpMM) with one thread block per node-block that walks only that block's
real chunks and gathers ``V[other]`` itself.  The source file says what
bounds each and how the design answers it.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch failed.  Its
``launches`` attribute counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM, check_tensor


def edge_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              v: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """K1: alpha * (sum_e w_e x_e x_e^T V) + beta * V on the card."""
    if v.device.type != "cuda":
        raise ValueError("kernel.edge_spmm needs CUDA tensors")
    n, k = v.shape
    e = src.shape[0]
    for name, t, dt, shp in (("src", src, torch.int32, (e,)),
                             ("dst", dst, torch.int32, (e,)),
                             ("w", w, torch.float32, (e,)),
                             ("v", v, torch.float32, (n, k))):
        check_tensor(t, name, dt, shp, v.device)
    if e * k >= 2 ** 62 or n * k >= 2 ** 62:
        raise ValueError("edge_spmm: problem too large")
    out = torch.empty_like(v)
    lib = _build.library()
    _build.check(lib.edge_spmm_launch(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), v.data_ptr(),
        out.data_ptr(), float(alpha), float(beta), e, n, k, _build.stream()),
        "edge_spmm")
    edge_spmm.launches += 1
    return out


edge_spmm.launches = 0


def edge_spmm_nb(u_local: torch.Tensor, other: torch.Tensor, w: torch.Tensor,
                 block_chunks: torch.Tensor, deg: torch.Tensor,
                 v: torch.Tensor, alpha: float, beta: float,
                 *, block_n: int, block_e: int) -> torch.Tensor:
    """K2: node-blocked alpha * (L V) + beta * V over the CSR chunk layout.

    ``block_chunks`` is the (NB+1,) block -> first-chunk offset array;
    block b walks chunks ``[block_chunks[b], block_chunks[b+1])`` only.
    ``v`` is the unpadded (n, k) panel; ``deg`` is row-padded to NB*block_n.
    """
    if v.device.type != "cuda":
        raise ValueError("kernel.edge_spmm_nb needs CUDA tensors")
    n, k = v.shape
    slots = u_local.shape[0]
    nb = block_chunks.shape[0] - 1
    for name, t, dt, shp in (("u_local", u_local, torch.int32, (slots,)),
                             ("other", other, torch.int32, (slots,)),
                             ("w", w, torch.float32, (slots,)),
                             ("block_chunks", block_chunks, torch.int32, (nb + 1,)),
                             ("deg", deg, torch.float32, (nb * block_n,)),
                             ("v", v, torch.float32, (n, k))):
        check_tensor(t, name, dt, shp, v.device)
    if nb < 1 or n > nb * block_n or slots % block_e:
        raise ValueError(
            f"edge_spmm_nb: layout of {nb} blocks x {block_n} rows and "
            f"{slots} slots does not fit a panel of {n} rows")
    if block_n * k * 4 > MAX_SMEM:
        raise ValueError(
            f"edge_spmm_nb: a ({block_n}, {k}) fp32 accumulator needs "
            f"{block_n * k * 4} B of shared memory, more than {MAX_SMEM}")
    if slots * k >= 2 ** 31 or n * k >= 2 ** 62:
        raise ValueError("edge_spmm_nb: layout too large for 32-bit work "
                         "indices")
    out = torch.empty_like(v)
    lib = _build.library()
    _build.check(lib.edge_spmm_nb_launch(
        u_local.data_ptr(), other.data_ptr(), w.data_ptr(),
        block_chunks.data_ptr(), deg.data_ptr(), v.data_ptr(),
        out.data_ptr(), float(alpha), float(beta), n, k, nb, block_n,
        block_e, _build.stream()), "edge_spmm_nb")
    edge_spmm_nb.launches += 1
    return out


edge_spmm_nb.launches = 0
