"""Device ms a batch of everything but the hand-written kernels: the
torch ops of the refresh, the fold list, the clone and the rebuild."""

from splaybench.yardstick import dev_ms


def read(ctx):
    return dev_ms(ctx, "torch")
