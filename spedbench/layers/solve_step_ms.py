"""solve_step_ms (solve loop): ms a solver step, from a job's first
edge-SpMM kernel to the end of its last ``panel_mix`` kernel over the
job's steps; the evaluations between steps are inside."""
SPMM = r"row_gather_kernel"
MIX = r"panel_mix"


def read(ctx):
    tl = ctx.timeline
    spmm, mix = tl.kernels(SPMM), tl.kernels(MIX)
    vals = []
    for job in tl.jobs:
        a, b = tl.in_job(spmm, job), tl.in_job(mix, job)
        if a and b:
            vals.append((max(k[2] for k in b) - a[0][1]) / 1e6
                        / ctx.shapes["steps"])
    return sum(vals) / len(vals) if vals else None
