"""ctypes wrappers of the dense panel kernels (``csrc/laplacian_poly.cu``).

K5 ``poly_step`` replaces ``repro/kernels/laplacian_poly/kernel.py:44``
(U - c L U with the AXPY in the epilogue) and K6 ``dense_matvec_panel``
replaces ``repro/kernels/laplacian_poly/kernel.py:80`` (the plain L U).
Both stream each row strip of L once with fp32 FMA on the CUDA cores; the
source file says what bounds them and how the design answers it.

Each wrapper takes contiguous fp32 CUDA tensors only, checks them,
allocates the output with ``torch.empty``, launches on the current stream,
raises if the launch failed, and counts its launches in ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor


def _check(l_mat: torch.Tensor, u: torch.Tensor, name: str) -> tuple[int, int]:
    if u.device.type != "cuda":
        raise ValueError(f"kernel.{name} needs CUDA tensors")
    if u.dim() != 2:
        raise ValueError(f"{name}: U must be an (n, k) panel")
    n, k = u.shape
    check_tensor(u, "u", torch.float32, (n, k), u.device)
    check_tensor(l_mat, "l_mat", torch.float32, (n, n), u.device)
    if n * n >= 2 ** 62 or n >= 2 ** 31:
        raise ValueError(f"{name}: problem too large")
    return n, k


def poly_step(l_mat: torch.Tensor, u: torch.Tensor, c: float) -> torch.Tensor:
    """K5: U - c (L @ U) on the card, c as fp32."""
    n, k = _check(l_mat, u, "poly_step")
    out = torch.empty_like(u)
    lib = _build.library()
    _build.check(lib.poly_step_launch(
        l_mat.data_ptr(), u.data_ptr(), out.data_ptr(), float(c), n, k,
        _build.stream()), "poly_step")
    poly_step.launches += 1
    return out


poly_step.launches = 0


def dense_matvec_panel(l_mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K6: L @ U on the card."""
    n, k = _check(l_mat, u, "dense_matvec_panel")
    out = torch.empty_like(u)
    lib = _build.library()
    _build.check(lib.dense_matvec_panel_launch(
        l_mat.data_ptr(), u.data_ptr(), out.data_ptr(), n, k,
        _build.stream()), "dense_matvec_panel")
    dense_matvec_panel.launches += 1
    return out


dense_matvec_panel.launches = 0
