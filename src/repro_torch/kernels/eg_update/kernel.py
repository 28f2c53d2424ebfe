"""ctypes wrappers of the fused mu-EG panel passes (``csrc/eg_update.cu``).

K3 ``gram2k`` replaces ``repro/kernels/eg_update/kernel.py:40`` and K4
``panel_mix`` replaces ``repro/kernels/eg_update/kernel.py:64``.  Both
run fp32 FMA on the CUDA cores (no tensor cores, so no TF32), and both
are bound by the bytes of V and AV; the source file says how each design
answers that.

K3 streams each block's contiguous row range through a four-stage
``cp.async`` ring (16-byte copies wherever the panel allows) into
register-tiled 4x4 sums of the gram's upper triangle.  Its grid is sized
to the card, ``GRAM_BLOCKS_PER_SM`` blocks per SM, by ``gram2k_parts``,
and a second launch from the same C call sums the per-block partials in
block order, so the result is bitwise the same from run to run.

K4 is one register pass: a thread per row loads its rows of V and AV
straight into registers with the widest loads the panels' alignment
allows, mixes them with M1, M2 and colscale staged once per block in
shared memory, and streams its output row out; the grid fills the card
once and walks the rows.  It takes any k (wide panels in 16-column
groups).

Each wrapper takes CUDA tensors only, checks them, allocates its output
and scratch with ``torch.empty``, launches on the current stream, raises
if the launch failed, and counts its calls in ``launches`` (one per call;
a K3 call is two device launches).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor

GRAM_TILE_FLOATS = 1280  # kGramTileFloats in csrc/eg_update.cu
GRAM_BLOCKS_PER_SM = 4  # row slices of the first gram launch per SM
GRAM_MAX_K = 192  # widest panel K3 takes


def _check_panels(v: torch.Tensor, av: torch.Tensor) -> tuple[int, int]:
    if v.device.type != "cuda":
        raise ValueError("eg_update kernels need CUDA tensors")
    n, k = v.shape
    check_tensor(v, "v", torch.float32, (n, k), v.device)
    check_tensor(av, "av", torch.float32, (n, k), v.device)
    if n * k >= 2 ** 62:
        raise ValueError("panel too large")
    return n, k


def gram2k_tile_rows(k: int) -> int:
    """Rows of one staged tile of K3 (``GRAM_TILE_FLOATS`` floats of V)."""
    return max(1, GRAM_TILE_FLOATS // k)


def gram2k_parts(n: int, k: int, sms: int) -> tuple[int, int]:
    """(row slices, rows per slice) of the first gram launch for an n-row,
    k-column panel on a card with ``sms`` SMs: at most
    ``GRAM_BLOCKS_PER_SM`` slices per SM, each whole tiles and none empty."""
    tile_rows = gram2k_tile_rows(k)
    tiles = max(1, -(-n // tile_rows))
    per_part = -(-tiles // min(tiles, GRAM_BLOCKS_PER_SM * sms))
    return -(-tiles // per_part), per_part * tile_rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gram2k(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """K3: S = [V|AV]^T [V|AV], (2k, 2k), deterministic two-launch sum."""
    n, k = _check_panels(v, av)
    if not 1 <= k <= GRAM_MAX_K:
        raise ValueError(
            f"gram2k: k = {k} is outside the kernel's 1..{GRAM_MAX_K}")
    parts, rows_per_part = gram2k_parts(n, k, _sm_count(v.device.index))
    # one partial per upper-triangle entry of S and row slice, entry-major
    partial = torch.empty((k * (2 * k + 1), parts), dtype=torch.float32,
                          device=v.device)
    out = torch.empty((2 * k, 2 * k), dtype=torch.float32, device=v.device)
    lib = _build.library()
    _build.check(lib.gram2k_launch(
        v.data_ptr(), av.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, k, parts, rows_per_part, gram2k_tile_rows(k), _build.stream()),
        "gram2k")
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
    out = torch.empty_like(v)
    lib = _build.library()
    _build.check(lib.panel_mix_launch(
        v.data_ptr(), av.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        colscale.data_ptr(), out.data_ptr(), n, k, _build.stream()), "panel_mix")
    panel_mix.launches += 1
    return out


panel_mix.launches = 0
