"""Model FLOPs of a request (step) over its mean traced time, as a share of
the card's fp32 peak, in %."""
from benchlib.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx)
