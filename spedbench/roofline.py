"""Peaks of the card and the bytes and operations each piece of a job
needs, computed from the cell's shapes.

Each input byte is counted once and each output byte once, whatever an
implementation reads again, so a count reads the same work whatever
implements it.  ``bound_s`` is the least time: the larger of the bytes
at the HBM rate and the operations at the fp32 rate (no tensor cores:
the port's kernels run fp32 FMA).
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

F32 = 4
I32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for ``nbytes`` moved and ``flops`` computed."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def k2_bytes(half_edges: int, n: int, k: int) -> int:
    """One exact-edges factor (K2): the row CSR's neighbour and weight per
    half-edge, its row pointers, the panel in and the panel out."""
    return half_edges * (I32 + F32) + (n + 1) * I32 + 2 * n * k * F32


def k2_flops(half_edges: int, n: int, k: int) -> int:
    """A multiply and an add per gathered element, and the epilogue's
    ``alpha (deg v - A v) + beta v`` (4 per element)."""
    return 2 * half_edges * k + 4 * n * k


def k1_bytes(batch: int, touched_rows: float, n: int, k: int) -> float:
    """One drawn factor (K1): the batch's edges (two ids and a weight),
    the panel rows its endpoints touch, and the panel out."""
    return batch * (2 * I32 + F32) + touched_rows * k * F32 + n * k * F32


def k1_flops(batch: int, n: int, k: int) -> int:
    return 2 * (2 * batch) * k + 4 * n * k


def eg_bytes(n: int, k: int) -> int:
    """K3 (gram of [V | AV]: reads both) and K4 (reads both, writes V')."""
    return 5 * n * k * F32


def eg_flops(n: int, k: int) -> int:
    """K3: the upper triangle of the (2k, 2k) gram, a multiply and an add
    per entry and row; K4: V M1 + AV M2 (2k products a column) and the
    column scale."""
    return 2 * k * (2 * k + 1) * n + 2 * (2 * k) * k * n + n * k


def mu_eg_step_bytes(n: int, k: int) -> int:
    """The step's own least traffic: V and AV read once, V' written once."""
    return 3 * n * k * F32


def expected_touched_rows(degrees: torch.Tensor, batch: int) -> float:
    """Expected distinct endpoints of ``batch`` edges drawn uniformly with
    replacement: node v is an endpoint of a drawn edge with probability
    d_v / E, so it is touched with probability 1 - (1 - d_v / E)^batch."""
    d = degrees.double()
    e = float(d.sum()) / 2
    return float((1.0 - torch.pow(1.0 - d / e, batch)).sum())


def factor_cost(shapes: dict) -> tuple[float, float]:
    """(bytes, flops) of one series factor in the cell's estimation mode."""
    n, k = shapes["n"], shapes["k"]
    if shapes["estimation"] == "minibatch":
        b = shapes["batch_edges"]
        return (k1_bytes(b, shapes["touched_rows"], n, k), k1_flops(b, n, k))
    h = shapes["half_edges"]
    return k2_bytes(h, n, k), k2_flops(h, n, k)


def step_bound_s(shapes: dict) -> float:
    """Least seconds of one solver step: ``degree`` factors and the mu-EG
    update, bytes and operations summed over the step."""
    fb, ff = factor_cost(shapes)
    n, k, d = shapes["n"], shapes["k"], shapes["degree"]
    return bound_s(d * fb + mu_eg_step_bytes(n, k), d * ff + eg_flops(n, k))
