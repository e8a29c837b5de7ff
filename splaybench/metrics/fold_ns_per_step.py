"""F's device ns a step over the traced slice: the fold kernel's traced
time over the steps the program counted inside it (``fold.steps``)."""

from splaybench import program_trace

TRACE = program_trace.arm()


def read(ctx):
    c = program_trace.slice_counts(TRACE, ctx)
    if not c or not c.get("fold.steps"):
        return None
    t = ctx["summary"].kernel_s("fold")
    return 1e9 * t / c["fold.steps"] if t > 0 else None
