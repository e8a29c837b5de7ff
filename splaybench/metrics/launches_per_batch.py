"""Kernel launches a batch over the window, from the program's launch
counters (``repro_torch.kernels.ops.launch_counts``)."""


def read(ctx):
    n = sum(ctx["launches"].values())
    return n / ctx["batches"] if n else None
