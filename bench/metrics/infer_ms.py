"""The window's seconds over the requests it completed, in ms."""


def read(ctx):
    w = ctx.window
    if w is None or w.kind != "request" or not w.completed:
        return None
    return w.seconds / w.completed * 1e3
