"""The window's seconds over the training steps it completed, in ms."""


def read(ctx):
    w = ctx.window
    if w is None or w.kind != "step" or not w.completed:
        return None
    return w.seconds / w.completed * 1e3
