"""step_roofline (solve loop): the whole solver step's share of its least
time, in %.  The least time is ``degree`` series factors (K2's bytes in
exact_edges, K1's in minibatch) plus the mu-EG step's own 3 n k floats,
at the card's peak (``roofline.step_bound_s``); the step's time is
solve_step_ms's.  A gain from fusing or removing a kernel stays bounded
by it."""
from spedbench import roofline

SPMM = r"row_gather_kernel"
MIX = r"panel_mix"


def read(ctx):
    tl = ctx.timeline
    spmm, mix = tl.kernels(SPMM), tl.kernels(MIX)
    total, jobs = 0.0, 0
    for job in tl.jobs:
        a, b = tl.in_job(spmm, job), tl.in_job(mix, job)
        if a and b:
            total += (max(k[2] for k in b) - a[0][1]) / 1e9
            jobs += 1
    if not jobs:
        return None
    step_s = total / jobs / ctx.shapes["steps"]
    return 100.0 * roofline.step_bound_s(ctx.shapes) / step_s
