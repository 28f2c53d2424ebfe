"""ctypes wrappers of the incidence SpMM kernels (``csrc/edge_spmm.cu``).

K1 ``edge_spmm`` replaces ``repro/kernels/edge_spmm/kernel.py:94`` (the
one-hot MXU SpMM) and K2 ``edge_spmm_nb`` replaces
``repro/kernels/edge_spmm/kernel.py:151`` (the node-blocked SpMM).  Both
launch the same row-gather body over a destination-sorted half-edge CSR
(``ops.EdgeRows``) built on the card; the kernel path names the launch K1
for n <= 4096 and K2 past it, as the JAX package picks its kernel.  The
source file says what bounds it and how the design answers it.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches once on
``torch.cuda.current_stream()`` and raises if the launch failed.  Its
``launches`` attribute counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor


def _row_gather(name: str, row_ptr: torch.Tensor, other: torch.Tensor,
                weight: torch.Tensor, hub_rows: torch.Tensor, v: torch.Tensor,
                alpha: float, beta: float, hub_threshold: int,
                v_self: torch.Tensor | None) -> torch.Tensor:
    if v.device.type != "cuda":
        raise ValueError(f"kernel.{name} needs CUDA tensors")
    if v.dim() != 2:
        raise ValueError(f"{name}: v must be an (n, k) panel, got {tuple(v.shape)}")
    if v_self is None:
        v_self = v
    n_in, k = v.shape
    n = v_self.shape[0]
    slots = other.shape[0]
    for arg, t, dt, shp in (("row_ptr", row_ptr, torch.int32, (n + 1,)),
                            ("other", other, torch.int32, (slots,)),
                            ("weight", weight, torch.float32, (slots,)),
                            ("hub_rows", hub_rows, torch.int32,
                             (hub_rows.shape[0],)),
                            ("v", v, torch.float32, (n_in, k)),
                            ("v_self", v_self, torch.float32, (n, k))):
        check_tensor(t, arg, dt, shp, v.device)
    if hub_rows.shape[0] < 1:
        raise ValueError(f"{name}: hub_rows must end with the sentinel n")
    if slots >= 2 ** 31 or max(n, n_in) * k >= 2 ** 62:
        raise ValueError(f"{name}: layout too large for 32-bit entry indices")
    out = torch.empty_like(v_self)
    _build.check(_build.library().edge_spmm_rows_launch(
        row_ptr.data_ptr(), other.data_ptr(), weight.data_ptr(),
        hub_rows.data_ptr(), v.data_ptr(), v_self.data_ptr(), out.data_ptr(),
        float(alpha), float(beta), n, k, hub_rows.shape[0],
        int(hub_threshold), _build.stream()), name)
    return out


def edge_spmm(row_ptr: torch.Tensor, other: torch.Tensor,
              weight: torch.Tensor, hub_rows: torch.Tensor, v: torch.Tensor,
              alpha: float, beta: float, *, hub_threshold: int,
              v_self: torch.Tensor | None = None) -> torch.Tensor:
    """K1: alpha * (L V) + beta * V over an edge list's row CSR (see
    :func:`edge_spmm_nb` for ``v_self``)."""
    out = _row_gather("edge_spmm", row_ptr, other, weight, hub_rows, v,
                      alpha, beta, hub_threshold, v_self)
    edge_spmm.launches += out.numel() > 0  # an empty panel launches nothing
    return out


edge_spmm.launches = 0


def edge_spmm_nb(row_ptr: torch.Tensor, other: torch.Tensor,
                 weight: torch.Tensor, hub_rows: torch.Tensor,
                 v: torch.Tensor, alpha: float, beta: float,
                 *, hub_threshold: int,
                 v_self: torch.Tensor | None = None) -> torch.Tensor:
    """K2: alpha * (L V) + beta * V over a NodeBlocking's row CSR.

    The rectangular launch: ``v_self`` (n, k) holds the rows' own terms
    and ``row_ptr`` has n + 1 entries, while ``v`` is the (n_in, k) panel
    the neighbours index, so row i is ``alpha * (deg_i v_self[i] - sum w
    v[other]) + beta * v_self[i]``: a panel shard's owned rows.  ``None``
    is ``v`` itself."""
    out = _row_gather("edge_spmm_nb", row_ptr, other, weight, hub_rows, v,
                      alpha, beta, hub_threshold, v_self)
    edge_spmm_nb.launches += out.numel() > 0
    return out


edge_spmm_nb.launches = 0
