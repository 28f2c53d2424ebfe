"""step_span_ms (solve loop): device ms a solver step, read from the
program's span log (``spedbench.program_spans``): the ``sped.solve`` span
(the initial panel, the steps, the capture of the series at the first)
less its ``sped.eval`` children, over the job's steps.  The in-program
counterpart of ``solve_step_ms``, without the evaluations."""
from spedbench import program_spans

SOLVE, EVAL = "sped.solve", "sped.eval"


def read(ctx):
    def per_step(recs):
        solve = program_spans.device_ms(recs, SOLVE)
        ids = {r.index for r in recs if r.name == SOLVE}
        evals = [r.device_ms for r in recs
                 if r.name == EVAL and r.parent in ids]
        if solve is None or None in evals:
            return None
        return (solve - sum(evals)) / ctx.shapes["steps"]

    return program_spans.mean_over_jobs(ctx, per_step)
