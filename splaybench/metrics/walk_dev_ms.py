"""Device ms a batch of the walk kernel, from the trace."""

from splaybench.yardstick import dev_ms


def read(ctx):
    return dev_ms(ctx, "walk")
