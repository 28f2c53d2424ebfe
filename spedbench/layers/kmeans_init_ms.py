"""kmeans_init_ms (pipeline): device ms a job of all the program's
``sped.kmeans.init`` spans (each restart's k-means++ seeding), read from
the program's span log (``spedbench.program_spans``)."""
from spedbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "sped.kmeans.init")
