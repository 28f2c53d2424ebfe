"""SPED core of the port: the exact-edges spectral-clustering path."""
from repro_torch.core.laplacian import (  # noqa: F401
    EdgeList,
    adjacency_dense,
    degrees,
    edge_matvec_arrays,
    laplacian_dense,
    laplacian_matvec,
    make_edge_list,
    pad_edge_list,
    spectral_radius_upper_bound,
)
from repro_torch.core.series import (  # noqa: F401
    SpectralSeries,
    cheb_log,
    cheb_neg_exp,
    chebyshev,
    identity_series,
    limit_neg_exp,
    taylor_log,
    taylor_neg_exp,
    with_lambda_star,
)
from repro_torch.core.backend import (  # noqa: F401
    BACKENDS,
    NodeBlocking,
    build_node_blocking,
    resolve_backend,
)
from repro_torch.core.solvers import (  # noqa: F401
    SolverConfig,
    SolverState,
    Trace,
    init_from_panel,
    init_state,
    make_step_fn,
    mu_eg_step,
    mu_eg_step_from_gram,
    mu_eg_step_fused,
    oja_step,
    panel_gram2k,
    run_solver,
    steps_to_streak,
    steps_to_tolerance,
)
from repro_torch.core.clustering import (  # noqa: F401
    ClusteringConfig,
    build_series,
    exact_cluster_reference,
    spectral_cluster,
)
from repro_torch.core.program import (  # noqa: F401
    apply_solver_step,
    run_chunk,
    run_program,
)
