"""prep_span_ms (pipeline): device ms a job of the program's ``sped.prep``
span, read from the program's span log (``spedbench.program_spans``):
the radius bound, the series and the operator (the row CSR on the kernel
path).  The in-program counterpart of ``prep_ms``, without the initial
panel, which ``sped.solve`` holds."""
from spedbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "sped.prep")
