"""Seconds from the process's start to the window's start: imports, the
device, inputs, the program's set-up, warm-up, and a build on a cold
checkout."""


def read(ctx):
    return ctx.setup_s
