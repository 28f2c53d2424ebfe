"""Fused mu-EigenGame update: two panel passes (K3 gram, K4 mix) around
O(k^3) coefficient algebra on k x k matrices, which stays plain PyTorch.

The tensor's device picks the path: CUDA tensors go through the kernels
(``kernel.py``) or raise; CPU tensors go through the plain twins.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.eg_update import kernel, ref


def gram2k(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """S = [V|AV]^T [V|AV], (2k, 2k)."""
    if v.device.type == "cuda":
        return kernel.gram2k(v.float().contiguous(), av.float().contiguous())
    return ref.gram2k(v, av)


def panel_mix(v: torch.Tensor, av: torch.Tensor, m1: torch.Tensor,
              m2: torch.Tensor, colscale: torch.Tensor) -> torch.Tensor:
    """V' = (V @ M1 + AV @ M2) * colscale."""
    if v.device.type == "cuda":
        return kernel.panel_mix(v.float().contiguous(), av.float().contiguous(),
                                m1.contiguous(), m2.contiguous(),
                                colscale.contiguous())
    return ref.panel_mix(v, av, m1, m2, colscale)


def mu_eg_update(v: torch.Tensor, av: torch.Tensor, lr: float) -> torch.Tensor:
    """Fused mu-EG step, equal to ``ref.mu_eg_update``: two panel passes."""
    k = v.shape[1]
    s2 = gram2k(v, av)
    m1, m2, colscale = ref.coefficient_matrices(s2, k, lr)
    return panel_mix(v, av, m1, m2, colscale)
