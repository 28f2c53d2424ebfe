"""spmm_roofline (kernels): the edge SpMM's share of its roofline, in %:
one factor's least time (``roofline.factor_cost``: K2's row CSR, row
pointers and two panels in exact_edges; K1's batch, touched rows and
output panel in minibatch) over the mean device time of a
``row_gather_kernel`` launch (the one body K1 and K2 launch) in the
window's jobs."""
from spedbench import roofline

SPMM = r"row_gather_kernel"


def read(ctx):
    tl = ctx.timeline
    spmm = tl.kernels(SPMM)
    ks = [k for job in tl.jobs for k in tl.in_job(spmm, job)]
    if not ks:
        return None
    mean_s = sum(k[2] - k[1] for k in ks) / len(ks) / 1e9
    return 100.0 * roofline.bound_s(*roofline.factor_cost(ctx.shapes)) / mean_s
