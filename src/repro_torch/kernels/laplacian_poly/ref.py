"""Plain PyTorch versions of the dense limit-series kernels (the twins)."""
import numpy as np
import torch


def _fp32(c) -> float:
    # c is held as fp32, as the TPU kernel casts it
    return float(np.float32(float(c)))


def poly_step(l_mat: torch.Tensor, u: torch.Tensor, c) -> torch.Tensor:
    """U - c (L @ U)."""
    return u - _fp32(c) * (l_mat @ u)


def dense_matvec_panel(l_mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return l_mat @ u


def limit_series_apply(l_mat: torch.Tensor, v: torch.Tensor, degree: int,
                       scale: float = 1.0) -> torch.Tensor:
    """-(I - scale L / degree)^degree @ V by the recurrence."""
    c = scale / degree
    u = v
    for _ in range(degree):
        u = poly_step(l_mat, u, c)
    return -u
