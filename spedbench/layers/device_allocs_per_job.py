"""device_allocs_per_job (device): the caching allocator's ``cudaMalloc``
and ``cudaFree`` calls a job (``num_device_alloc`` + ``num_device_free``
of ``torch.cuda.memory_stats()`` over the job's ``sped.cluster`` span,
which holds the release of the job's operator and graph pool), read from
the program's span log (``spedbench.program_spans``)."""
from spedbench import program_spans


def read(ctx):
    def calls(recs):
        allocs = [r.allocs for r in recs if r.name == program_spans.JOB]
        if None in allocs:
            return None
        return sum(a["num_device_alloc"] + a["num_device_free"]
                   for a in allocs)

    return program_spans.mean_over_jobs(ctx, calls)
