"""The fold kernel's share of its roofline, from the trace and the
yardstick's count of its work."""

from splaybench.yardstick import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fold")
