"""Streaming clustering of the port: the multi-tenant service and the
state below it.

service
    The multi-tenant ``StreamingService``: admission with spectral
    probes and dilation plans, edge updates with first-order eigen
    updates and drift fallback, batched ticks of each (capacity class,
    degree) group through one ``core.program.TickProgram`` (one K1/K2
    launch per dilation factor for the whole group on the card,
    replayed as CUDA graphs), the residual-decay tick scheduler, stable
    labels, eviction and resume.

graph_store
    Mutable edge store: padded capacity classes (powers of two),
    fixed-size batched insert/delete/reweight upserts looked up by sorted
    key (O(capacity) per batch, no (B, capacity) match), lazy degrees,
    a cached row CSR for K1/K2 (``edge_rows``) and the fused step over it
    (``fused_step``), EdgeList views.
warm
    Warm-started solver sessions: the restart-vs-continue test by the old
    panel's residual under the new operator, and the chunked
    run-to-tolerance loop (``program.run_chunk``).
updates
    Dhanjal-style first-order incremental eigen-updates from realized
    edge-weight deltas, with the drift bound that triggers a fallback to a
    full warm re-solve.
tracking
    Stable cluster ids across re-solves: greedy maximum-overlap matching.

sharded
    The sharded serving policies (``ServiceConfig(mesh=...)``): every
    rank runs the service.  Edge sharding splits the edge buffers, with
    one all_reduce per dilation matvec, and ``balanced_capacity`` keeps
    every capacity a multiple of the shard count.  Panel sharding
    (``model_axes=...``) splits the panels' rows: one K2 launch per
    factor on the rank's owned rows and one fused rows + gram all_reduce
    per mu-EG step.
"""
from repro_torch.stream.graph_store import (  # noqa: F401
    CAPACITY_CLASSES,
    BatchStats,
    EdgeBatch,
    GraphStore,
    apply_edge_batch,
    as_edge_list,
    capacity_class,
    coalesce_batch,
    edge_rows,
    from_edge_list,
    fused_step,
    grow,
    make_edge_batch,
    model_shard_rows,
    model_sharded_blocking,
    num_edges,
    refresh_degrees,
    shard_edge_rows,
    sharded_node_blocking,
)
from repro_torch.stream.sharded import (  # noqa: F401
    balanced_capacity,
    build_tick_model_sharded,
    num_model_shards,
)
from repro_torch.stream.service import (  # noqa: F401
    ServiceConfig,
    StreamingService,
    UnknownSessionError,
    node_capacity_class,
    panel_labels,
)
from repro_torch.stream.tracking import (  # noqa: F401
    LabelTracker,
    label_churn,
    match_labels,
)
from repro_torch.stream.updates import (  # noqa: F401
    EigenEstimate,
    UpdateConfig,
    anchor_estimate,
    anchor_estimate_arrays,
    estimate_from_panel,
    first_order_update,
    should_fallback,
)
from repro_torch.stream.warm import (  # noqa: F401
    WarmConfig,
    reconverge,
    run_to_tolerance,
    warm_start_state,
)
