"""ctypes wrappers of the fused mu-EG panel passes (``csrc/eg_update.cu``).

K3 ``gram2k`` replaces ``repro/kernels/eg_update/kernel.py:40`` and K4
``panel_mix`` replaces ``repro/kernels/eg_update/kernel.py:64``.  Both
run fp32 FMA on the CUDA cores (no tensor cores, so no TF32); the source
file says what bounds each and how the design answers it.

Each wrapper takes CUDA tensors only, checks them, allocates its output
and scratch with ``torch.empty``, launches on the current stream, raises
if the launch failed, and counts its launches in ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DEFAULT_SMEM, MAX_SMEM, check_tensor

GRAM_TILE_ROWS = 32  # kGramTileRows in csrc/eg_update.cu
GRAM_MAX_PARTS = 1024  # row slices of the first gram launch
GRAM_MIN_ROWS = 256  # fewest rows a slice is given
MIX_ROWS = 64  # kMixRows in csrc/eg_update.cu


def _check_panels(v: torch.Tensor, av: torch.Tensor) -> tuple[int, int]:
    if v.device.type != "cuda":
        raise ValueError("eg_update kernels need CUDA tensors")
    n, k = v.shape
    check_tensor(v, "v", torch.float32, (n, k), v.device)
    check_tensor(av, "av", torch.float32, (n, k), v.device)
    if n * k >= 2 ** 62:
        raise ValueError("panel too large")
    return n, k


def gram2k_parts(n: int) -> int:
    """Row slices of the first gram launch for an n-row panel."""
    return min(GRAM_MAX_PARTS, max(1, -(-n // GRAM_MIN_ROWS)))


def gram2k(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """K3: S = [V|AV]^T [V|AV], (2k, 2k), deterministic two-launch sum."""
    n, k = _check_panels(v, av)
    if GRAM_TILE_ROWS * 2 * k * 4 > DEFAULT_SMEM:
        raise ValueError(f"gram2k: k = {k} exceeds the kernel's tile")
    parts = gram2k_parts(n)
    # one partial upper triangle of S per row slice
    partial = torch.empty((parts, k * (2 * k + 1)), dtype=torch.float32,
                          device=v.device)
    out = torch.empty((2 * k, 2 * k), dtype=torch.float32, device=v.device)
    lib = _build.library()
    _build.check(lib.gram2k_launch(
        v.data_ptr(), av.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, k, parts, _build.stream()), "gram2k")
    gram2k.launches += 1
    return out


gram2k.launches = 0


def panel_mix(v: torch.Tensor, av: torch.Tensor, m1: torch.Tensor,
              m2: torch.Tensor, colscale: torch.Tensor) -> torch.Tensor:
    """K4: V' = (V @ M1 + AV @ M2) * colscale, one pass over the panels."""
    n, k = _check_panels(v, av)
    check_tensor(m1, "m1", torch.float32, (k, k), v.device)
    check_tensor(m2, "m2", torch.float32, (k, k), v.device)
    check_tensor(colscale, "colscale", torch.float32, (k,), v.device)
    if (2 * k * k + k + 2 * MIX_ROWS * k) * 4 > MAX_SMEM:
        raise ValueError(f"panel_mix: k = {k} exceeds shared memory")
    out = torch.empty_like(v)
    lib = _build.library()
    _build.check(lib.panel_mix_launch(
        v.data_ptr(), av.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        colscale.data_ptr(), out.data_ptr(), n, k, _build.stream()), "panel_mix")
    panel_mix.launches += 1
    return out


panel_mix.launches = 0
