"""kmeans_lloyd_ms (pipeline): device ms a job of all the program's
``sped.kmeans.lloyd`` spans (each restart's Lloyd iterations and final
assignment), read from the program's span log
(``spedbench.program_spans``)."""
from spedbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "sped.kmeans.lloyd")
