"""kmeans_dist_calls_per_job (pipeline): launches of k-means' nearest-centre
kernel (``kmeans_dist``) a traced job, from the program's launch counter
(``repro_torch.kernels.launch_counts``): each restart's k-means++ draws
and Lloyd passes (8 x (29 + 26) = 440 at 30 clusters).  A program
without the kernel leaves nothing to read."""
KERNEL = "kmeans_dist"


def read(ctx):
    jobs = len(ctx.timeline.jobs)
    calls = (ctx.launches or {}).get(KERNEL, 0)
    return calls / jobs if jobs and calls else None
