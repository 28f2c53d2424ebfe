"""post_span_ms (pipeline): device ms a job of the program's ``sped.post``
span, read from the program's span log (``spedbench.program_spans``):
the row-normalised embedding and k-means.  The in-program counterpart of
``post_ms``, without the solver's last evaluation."""
from spedbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "sped.post")
