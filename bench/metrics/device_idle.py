"""Share of the traced window in which no operation ran on the device, %."""
from benchlib.readers import device_idle_percent


def read(ctx):
    return device_idle_percent(ctx)
