"""Host waits on the card a batch (``cudaStreamSynchronize`` and the
like), inside the serving call and its answers' copy, over the traced
slice."""


def read(ctx):
    s = ctx["summary"]
    if s is None or not s.batches:
        return None
    n = s.syncs_in("bench.serve")
    return n / s.batches if n else None
