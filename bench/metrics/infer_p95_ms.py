"""The 95th percentile (nearest rank) of every window request's latency,
from the request's start to its answer on the host, in ms."""


def read(ctx):
    w = ctx.window
    if w is None or w.kind != "request" or not w.completed:
        return None
    return w.percentile(95.0) * 1e3
