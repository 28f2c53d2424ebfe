"""eval_ms (solve loop): device ms a job of all the program's
``sped.eval`` spans (``subspace_error`` and ``eigenvector_streak`` at
each evaluation of ``run_program``), read from the program's span log
(``spedbench.program_spans``)."""
from spedbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "sped.eval")
