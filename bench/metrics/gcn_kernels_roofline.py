"""The port's GCN kernels (K1, K2's transform and aggregations): the sum of
each launch's bound over the sum of its device time, in %."""
from families.gcn.kernels import roofline_percent


def read(ctx):
    return None if ctx.trace is None else roofline_percent(ctx.trace)
