"""ctypes wrapper of k-means' nearest-centre search (``csrc/kmeans_dist.cu``).

``kmeans_dist`` replaces no Pallas kernel (``repro``'s k-means is plain
jnp).  It runs fp32 on the CUDA cores, summing each distance from the
differences in the order ``torch.sum`` takes on the card, and is bound
by FP32 throughput (n m d subtractions, multiplies and adds, each rounded on
its own) rather than by its one read of x; the source file says how its
design answers that.  A row writes its minimum and argmin only: no (n, m) or
(n, m, d) tensor exists.

The wrapper takes CUDA f32 tensors only (every caller passes f32),
checks them, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch failed, and counts its calls in
``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor


def kmeans_dist(x: torch.Tensor, c: torch.Tensor,
                prev: torch.Tensor | None = None, labels: bool = True):
    """(min_j |x_i - c_j|^2, argmin_j) over the rows of x (n, d) and the
    centres c (m, d); with ``prev`` (n,) the minimum is also taken with
    it.  The argmin is None where ``labels`` is False."""
    if x.device.type != "cuda":
        raise ValueError("kmeans_dist needs CUDA tensors")
    n, d = x.shape
    m = c.shape[0]
    check_tensor(x, "x", torch.float32, (n, d), x.device)
    check_tensor(c, "c", torch.float32, (m, d), x.device)
    if prev is not None:
        check_tensor(prev, "prev", torch.float32, (n,), x.device)
    if m < 1 or d < 1:
        raise ValueError(f"kmeans_dist: needs a centre and a column, got "
                         f"m = {m}, d = {d}")
    if n >= 2 ** 31 or m >= 2 ** 31 or n * d >= 2 ** 62:
        raise ValueError("kmeans_dist: input too large")
    out_min = torch.empty((n,), dtype=torch.float32, device=x.device)
    out_arg = (torch.empty((n,), dtype=torch.int64, device=x.device)
               if labels else None)
    lib = _build.library()
    _build.check(lib.kmeans_dist_launch(
        x.data_ptr(), c.data_ptr(),
        None if prev is None else prev.data_ptr(), out_min.data_ptr(),
        None if out_arg is None else out_arg.data_ptr(), n, m, d,
        _build.stream()), "kmeans_dist")
    kmeans_dist.launches += 1
    return out_min, out_arg


kmeans_dist.launches = 0
