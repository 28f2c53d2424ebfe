"""post_ms (pipeline): ms a job from the end of its last ``panel_mix``
kernel (the last solver step) to the end of the job span: the
row-normalised embedding and k-means, and the job's last host reads."""
MIX = r"panel_mix"


def read(ctx):
    tl = ctx.timeline
    mix = tl.kernels(MIX)
    vals = []
    for job in tl.jobs:
        ks = tl.in_job(mix, job)
        if ks:
            vals.append((job[1] - max(k[2] for k in ks)) / 1e6)
    return sum(vals) / len(vals) if vals else None
