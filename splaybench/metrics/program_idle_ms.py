"""Ms a batch the card sat idle inside the program's serving call
(``splay.serving``), over the traced slice: for each call, between the
first and the last activity it enqueued, on the device's clock."""

from splaybench import program_trace

program_trace.arm()        # the program opens its spans only while tracing


def read(ctx):
    s = ctx["summary"]
    if s is None or not s.batches or not s.device:
        return None
    idle = program_trace.idle_inside_s(s, "splay.serving")
    return None if idle is None else 1e3 * idle / s.batches
