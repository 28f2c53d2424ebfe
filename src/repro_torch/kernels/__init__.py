"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

``KERNELS`` lists each kernel wrapper by name; a wrapper's ``launches``
attribute counts the calls that launched its kernel on the card, and a
replayed CUDA graph adds the launches it holds.
"""
from __future__ import annotations

from repro_torch.kernels.edge_spmm import kernel as _es
from repro_torch.kernels.eg_update import kernel as _eg
from repro_torch.kernels.kmeans_dist import kernel as _km
from repro_torch.kernels.laplacian_poly import kernel as _lp

KERNELS = {
    "edge_spmm": _es.edge_spmm,
    "edge_spmm_nb": _es.edge_spmm_nb,
    "gram2k": _eg.gram2k,
    "panel_mix": _eg.panel_mix,
    "poly_step": _lp.poly_step,
    "dense_matvec_panel": _lp.dense_matvec_panel,
    "kmeans_dist": _km.kmeans_dist,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add per-kernel counts: a CUDA graph's replay adds the launches the
    graph holds (``core.operators.CapturedOperator``)."""
    for name, c in counts.items():
        KERNELS[name].launches += c
