"""Spectral probing and dilation planning (the auto-tuned path).

``probes`` estimates the Laplacian's spectrum matrix-free (Lanczos with
full reorthogonalization, stochastic Lanczos quadrature, Hutchinson
trace, a counting-function bottom-edge localizer); ``plan`` turns the
estimate into a transform family, degree, strength and reversal shift.

Entry points: ``probe_and_plan(g, k)`` here,
``repro_torch.core.operators.planned_operator`` for a ready solver
operator, and ``ClusteringConfig(transform="auto")`` for the pipeline.
"""
from repro_torch.spectral.plan import (  # noqa: F401
    TAU_GRID,
    DilationPlan,
    plan_dilation,
    probe_and_plan,
    series_from_plan,
    wanted_decay_cap,
)
from repro_torch.spectral.probes import (  # noqa: F401
    ProbeResult,
    bottom_edge,
    eigenvalue_count,
    hutchinson_trace,
    lanczos,
    probe_edge_arrays,
    probe_from_eigenvalues,
    probe_graph,
    probe_sharded_edge_arrays,
    slq_probe,
    spectral_density,
)
