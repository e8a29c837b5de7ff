"""The card's idle share of the traced slice: one less the union of its
device activities over the slice's length."""


def read(ctx):
    s = ctx["summary"]
    if s is None or s.window_s <= 0 or not s.device:
        return None
    return 1.0 - s.busy_s() / s.window_s
