"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

``KERNELS`` lists each kernel wrapper by name; a wrapper's ``launches``
attribute counts the calls that launched its kernel on the card.
"""
from __future__ import annotations

from repro_torch.kernels.edge_spmm import kernel as _es
from repro_torch.kernels.eg_update import kernel as _eg

KERNELS = {
    "edge_spmm": _es.edge_spmm,
    "edge_spmm_nb": _es.edge_spmm_nb,
    "gram2k": _eg.gram2k,
    "panel_mix": _eg.panel_mix,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
