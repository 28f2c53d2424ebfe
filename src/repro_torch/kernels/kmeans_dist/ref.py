"""Plain PyTorch twin of ``kmeans_dist``: the broadcast (n, m, d)
differences, squared and summed, then ``torch.min`` / ``torch.argmin``."""
from __future__ import annotations

import torch


def sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances of the rows of x to the centres c."""
    return torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)


def nearest(x: torch.Tensor, c: torch.Tensor):
    """(min_j |x_i - c_j|^2, argmin_j) for each row i."""
    d2 = sq_dists(x, c)
    return torch.min(d2, dim=1).values, torch.argmin(d2, dim=1)


def running_min(x: torch.Tensor, c: torch.Tensor,
                prev: torch.Tensor | None) -> torch.Tensor:
    """min_j |x_i - c_j|^2, or its elementwise min with ``prev``."""
    new = torch.min(sq_dists(x, c), dim=1).values
    return new if prev is None else torch.minimum(prev, new)
