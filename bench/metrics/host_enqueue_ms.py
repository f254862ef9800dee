"""Mean host ms from a request's (step's) start until its last kernel launch
returned, from the benchmark's spans and the profiler's launch calls."""
from benchlib.readers import host_enqueue_ms


def read(ctx):
    return host_enqueue_ms(ctx)
