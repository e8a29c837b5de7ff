"""Device ms a batch of the plane refresh: the activities enqueued inside
the program's ``splay.refresh`` spans over the traced slice."""

from splaybench import program_trace

program_trace.arm()        # the program opens its spans only while tracing


def read(ctx):
    return program_trace.span_dev_ms(ctx, "splay.refresh")
