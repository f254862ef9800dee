"""Device operations put down to the program's own spans.

The program opens its spans (`repro_torch.obs.trace.span`, named
``layer.operation``) as `torch.profiler.record_function` annotations while
a profiler runs, so they lie in the trace beside the benchmark's own
``bench.*`` spans and the launch calls, all on the host's clock.

The device's timestamps are not on that clock: in the H100's traces the
device operations drift against the host's calls, early or late, by up to
several ms over a 4 s window, and the profiler now and then records a call
whose operation it lost (the profiler's correlation ids show both). So an
operation's own start does not tell which span launched it. Their order
does: the port runs one stream, so the enqueue calls (kernel launches,
asynchronous copies and sets: `cudaLaunchKernel` and its kin, and their
``cu*`` counterparts) launch the device operations in the order the calls
start.

The calls are cut into units, one a benchmark span (``bench.request`` /
``bench.step``): those from its start to the next one's. Walking on from
the window's start, a unit of n calls takes the next n operations, where
each pair agrees in kind (a copy's call with a copy, a set's with a set, a
launch with a kernel). Every benchmark span ends in a copy back to the
host and its sync, so a unit with a lost operation, or an operation whose
call the profiler lost, no longer agrees with its calls, nor a unit taken
a place or a few off. Such a unit is left out, and the walk resumes at the
nearest place, within `SLACK` operations of where it is due, where one of
the next `SKIP` units agrees with its calls.

The window's first and last units may be left out (the profiler's start
and the window's end cut their operations). Of the others, at most one in
a hundred, and one at the least, may be: past that the pairing reads
`None`, not what the units that paired would say. The count of units that
paired goes to standard error once a trace.

A device operation belongs to a benchmark span, and to a program span,
when its enqueue call starts inside it, on any thread: the autograd
engine's device thread launches the backward while the caller waits
inside ``train.backward``.
"""
from __future__ import annotations

import bisect
import sys
import weakref

from benchlib.traceread import LAUNCH_CALLS, Op

ENQUEUE_CALLS = frozenset(LAUNCH_CALLS + (
    "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset", "cudaMemcpy2DAsync",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoDAsync_v2",
    "cuMemsetD8Async", "cuMemsetD16Async", "cuMemsetD32Async",
))


SLACK = 64      # operations lost, or found without a call, in one unit
SKIP = 4        # units in a row that may fail to pair
_PAIRED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()   # a trace's pairing, read by every metric


def _kind(name: str, call: bool) -> str:
    if call:
        return "copy" if "Memcpy" in name else "set" if "Memset" in name else "kernel"
    return "copy" if name.startswith("Memcpy") else "set" if name.startswith("Memset") else "kernel"


def _resume(kinds, want, p, k):
    """``(place, unit)``: the nearest place, within `SLACK` of where it is
    due, at which one of the `SKIP` units after unit k (begun at place p)
    agrees with its calls; None where none does."""
    due = p
    for j in range(k + 1, min(k + 1 + SKIP, len(want))):
        due += len(want[j - 1])
        m = len(want[j])
        for d in (0, *(s for i in range(1, SLACK + 1) for s in (-i, i))):
            q = due + d
            if q >= p and kinds[q:q + m] == want[j]:
                return q, j
    return None


def paired_units(view) -> dict[int, list[tuple[Op, Op]]] | None:
    """``{k: [(call, operation), ...]}`` for each benchmark span k of
    ``view`` (a `TraceView`) whose unit of calls pairs exactly with the
    device's operations; None where too few pair (see the module
    docstring)."""
    if view in _PAIRED:
        return _PAIRED[view]
    starts = [s.start for s in view.spans]
    units: list[list[Op]] = [[] for _ in starts]
    for o in view.host:
        if o.name in ENQUEUE_CALLS and o.start >= starts[0]:
            units[bisect.bisect_right(starts, o.start) - 1].append(o)
    ops = view.device
    kinds = [_kind(o.name, False) for o in ops]
    want = [[_kind(c.name, True) for c in u] for u in units]
    out: dict[int, list[tuple[Op, Op]]] = {}
    p, k = 0, 0
    while k < len(units):
        n = len(want[k])
        if kinds[p:p + n] == want[k]:
            out[k] = list(zip(units[k], ops[p:p + n]))
            p, k = p + n, k + 1
            continue
        at = _resume(kinds, want, p, k)
        if at is None:
            break
        p, k = at
    total = len(units)
    inner = sum(1 for k in range(1, total - 1) if k not in out)
    print(f"spans: {len(out)} of {total} {view.unit}s pair their enqueue calls with device operations",
          file=sys.stderr)
    _PAIRED[view] = out if inner <= max(1, total // 100) else None
    return _PAIRED[view]


def device_ops_in(view, name: str) -> list[list[Op]] | None:
    """For each benchmark span of ``view`` that pairs (`paired_units`), in
    order, the device operations whose enqueue call started inside it and
    inside a program span called ``name``. None where the window holds no
    such span (a program without it) or too few benchmark spans pair."""
    merged: list[list[float]] = []
    for o in view.host:                       # sorted by start
        if o.name != name:
            continue
        if merged and o.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], o.end)
        else:
            merged.append([o.start, o.end])
    units = paired_units(view) if merged else None
    if not units:
        return None
    starts = [a for a, _ in merged]
    out = []
    for k in sorted(units):
        end = view.spans[k].end
        inside = []
        for call, op in units[k]:
            i = bisect.bisect_right(starts, call.start) - 1
            if call.start < end and i >= 0 and call.start <= merged[i][1]:
                inside.append(op)
        out.append(inside)
    return out


def device_ms(ctx, name: str) -> float | None:
    """Mean device ms a request (step) spends in operations enqueued inside
    the program's ``name`` spans (`device_ops_in`); None where nothing can
    be attributed."""
    view = ctx.trace
    per = None if view is None else device_ops_in(view, name)
    if per is None:
        return None
    return sum(o.end - o.start for ops in per for o in ops) / len(per) / 1e3
