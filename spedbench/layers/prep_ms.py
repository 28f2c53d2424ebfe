"""prep_ms (pipeline): ms a job from the start of the benchmark's job span
around ``spectral_cluster`` to the job's first edge-SpMM kernel: the
spectral-radius bound, the series, the operator (the row CSR build on
the card), the initial panel and the first factor's launch."""
SPMM = r"row_gather_kernel"


def read(ctx):
    tl = ctx.timeline
    spmm = tl.kernels(SPMM)
    vals = []
    for job in tl.jobs:
        ks = tl.in_job(spmm, job)
        if ks:
            vals.append((ks[0][1] - job[0]) / 1e6)
    return sum(vals) / len(vals) if vals else None
