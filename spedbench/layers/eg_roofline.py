"""eg_roofline (kernels): the mu-EG kernels' share of their roofline, in
%: K3 ``gram2k`` (its partial and reduce launches) and K4 ``panel_mix``,
5 n k floats and their operations (``roofline.eg_bytes``,
``roofline.eg_flops``) over their summed device time a step."""
from spedbench import roofline

EG = r"gram2k|panel_mix"


def read(ctx):
    tl = ctx.timeline
    eg = tl.kernels(EG)
    ks = [k for job in tl.jobs for k in tl.in_job(eg, job)]
    if not ks or not ctx.steps_run:
        return None
    per_step_s = sum(k[2] - k[1] for k in ks) / 1e9 / ctx.steps_run
    n, k = ctx.shapes["n"], ctx.shapes["k"]
    bound = roofline.bound_s(roofline.eg_bytes(n, k), roofline.eg_flops(n, k))
    return 100.0 * bound / per_step_s
