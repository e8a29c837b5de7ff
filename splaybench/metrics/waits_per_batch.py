"""The program's host waits on the device a batch, over the traced
slice: the sum of its ``waits.<site>`` counters."""

from splaybench import program_trace

TRACE = program_trace.arm()


def read(ctx):
    c = program_trace.slice_counts(TRACE, ctx)
    if c is None:
        return None
    n = sum(v for k, v in c.items() if k.startswith("waits."))
    return n / ctx["summary"].batches if n else None
