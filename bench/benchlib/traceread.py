"""A profiler window read into what the per-layer metrics need.

The device's busy time is the union of its operations' intervals (kernels,
copies and sets) inside the traced window, as
`repro_torch.obs.trace.device_time_summary` takes it (copied here, so the
yardstick does not move with the program). The window runs from the first
request's (or step's) span start to the last one's end. A window in which
the device recorded no kernel is an error, not an idle share of 1.
"""
from __future__ import annotations

import bisect
import dataclasses

import torch

ANNOTATION_PREFIX = "bench."
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


class EmptyTrace(RuntimeError):
    pass


@dataclasses.dataclass
class Op:
    name: str
    start: float   # µs
    end: float     # µs


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def union_us(intervals) -> float:
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    return busy


class TraceView:
    """``spans``: the benchmark's own spans around each request or step, in
    order; ``device``: device operations in the window; ``host``: every
    other host-side event in the window."""

    def __init__(self, events, span_name: str, unit: str, context: dict):
        cuda = torch.autograd.DeviceType.CUDA
        spans, device, host = [], [], []
        for e in events:
            op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == cuda:
                if not (e.name.startswith(ANNOTATION_PREFIX) or e.name.startswith("ProfilerStep")
                        or getattr(e, "is_user_annotation", False)):
                    device.append(op)
            elif e.name == span_name:
                spans.append(op)
            else:
                host.append(op)
        if not spans:
            raise EmptyTrace(f"the trace holds no {span_name!r} span")
        spans.sort(key=lambda o: o.start)
        self.unit, self.context, self.spans = unit, context, spans
        self.start, self.end = spans[0].start, spans[-1].end
        self.device = sorted((o for o in device if self.start <= o.start < self.end), key=lambda o: o.start)
        self.host = sorted((o for o in host if o.end > self.start and o.start < self.end), key=lambda o: o.start)
        self.kernels = [o for o in self.device if _is_kernel(o.name)]
        if not self.kernels:
            raise EmptyTrace(f"the trace recorded no device kernel in {len(spans)} {unit}s")

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((o.start, min(o.end, self.end)) for o in self.device) / 1e6

    def per_span(self, ops: list[Op]) -> list[list[Op]]:
        """``ops`` (sorted by start) grouped by the span their start lies in."""
        starts = [o.start for o in ops]
        out = []
        for s in self.spans:
            lo, hi = bisect.bisect_left(starts, s.start), bisect.bisect_left(starts, s.end)
            out.append(ops[lo:hi])
        return out

    # ------------------------------------------------------------ breakdown
    def top_device_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for o in self.device:
            total[o.name] = total.get(o.name, 0.0) + (o.end - o.start) / 1e6
        return [[name[:200], s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Device idle time inside the window, by the innermost host event
        running at each gap's middle (summed over gaps of one name)."""
        gaps, last = [], self.start
        for o in sorted(self.device, key=lambda o: o.start):
            if o.start > last:
                gaps.append((last, o.start))
            last = max(last, o.end)
        if self.end > last:
            gaps.append((last, self.end))
        host = self.host + self.spans
        host.sort(key=lambda o: o.start)
        starts = [o.start for o in host]
        total: dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = "host: no event"
            for j in range(i, max(-1, i - 400), -1):
                if host[j].end >= mid:
                    label = host[j].name
                    break
            total[label] = total.get(label, 0.0) + (b - a) / 1e6
        return [[name[:200], s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
