"""captures_per_job (series): CUDA-graph captures a job, read from the
program's span log (``spedbench.program_spans``): its ``sped.capture``
spans (``operators.capture_graph``, which every capture in the program
passes through)."""
from spedbench import program_spans


def read(ctx):
    return program_spans.mean_over_jobs(
        ctx, lambda recs: sum(r.name == "sped.capture" for r in recs))
