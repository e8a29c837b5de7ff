"""F's steps a walk over the traced slice, from the program's counters:
successor reads (``fold.steps``) over weighted entries visited or ops
run (``fold.walks``)."""

from splaybench import program_trace

TRACE = program_trace.arm()


def read(ctx):
    c = program_trace.slice_counts(TRACE, ctx)
    if not c or not c.get("fold.walks"):
        return None
    return c.get("fold.steps", 0) / c["fold.walks"]
