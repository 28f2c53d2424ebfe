"""k-means' nearest-centre search.

The tensor's device picks the path: CUDA tensors go through the kernel
(``kernel.py``) or raise; CPU tensors go through the plain twin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans_dist import kernel, ref


def nearest(x: torch.Tensor, c: torch.Tensor):
    """(min_j |x_i - c_j|^2, argmin_j) for each row i of x; ties take the
    lowest j."""
    if x.device.type == "cuda":
        return kernel.kmeans_dist(x.contiguous(), c.contiguous())
    return ref.nearest(x, c)


def running_min(x: torch.Tensor, c: torch.Tensor,
                prev: torch.Tensor | None) -> torch.Tensor:
    """min_j |x_i - c_j|^2 for each row i, or its elementwise min with
    ``prev``: the minimum over every centre seen, one read of x."""
    if x.device.type == "cuda":
        return kernel.kmeans_dist(
            x.contiguous(), c.contiguous(),
            None if prev is None else prev.contiguous(), labels=False)[0]
    return ref.running_min(x, c, prev)
