"""Mean host ms a request (step) spends inside the program's ``sync.*``
spans: where the host waits for the device in the middle of the work."""
from benchlib.traceread import union_us


def read(ctx):
    view = ctx.trace
    if view is None:
        return None
    syncs = [o for o in view.host if o.name.startswith("sync.")]
    if not syncs:
        return None
    total = sum(union_us((max(o.start, s.start), min(o.end, s.end)) for o in ops)
                for s, ops in zip(view.spans, view.per_span(syncs)))
    return total / len(view.spans) / 1e3
