"""PyTorch and CUDA port of SPED for one NVIDIA H100.

A package of its own beside the JAX package ``repro``: it imports torch
and numpy only.  Entry points default to the CUDA card (``device=None``)
and raise without one; pass ``device="cpu"`` for the plain PyTorch path.
"""
from repro_torch.core import (  # noqa: F401
    BACKENDS,
    ClusteringConfig,
    EdgeList,
    NodeBlocking,
    SolverConfig,
    SolverState,
    build_node_blocking,
    build_series,
    exact_cluster_reference,
    make_edge_list,
    resolve_backend,
    run_solver,
    spectral_cluster,
)
from repro_torch.device import resolve_device  # noqa: F401
