"""spmm_calls_per_step (series): edge-SpMM launches (K1 ``edge_spmm`` and
K2 ``edge_spmm_nb``) a solver step over the traced window, from the
program's launch counter (``repro_torch.kernels.launch_counts``; a
replayed CUDA graph adds the launches it holds)."""
KERNELS = ("edge_spmm", "edge_spmm_nb")


def read(ctx):
    steps = ctx.steps_run
    calls = sum(ctx.launches.get(k, 0) for k in KERNELS)
    return calls / steps if steps and calls else None
