"""Readings shared by the metric files: each takes the run's context and
returns a number, or None where the run has nothing to read."""
from __future__ import annotations

from benchlib.peaks import H100_SXM
from benchlib.traceread import LAUNCH_CALLS


def host_enqueue_ms(ctx) -> float | None:
    """Mean host time from a request's (step's) start until its last kernel
    launch returned: what the host spends before the card can finish."""
    view = ctx.trace
    if view is None:
        return None
    launches = [o for o in view.host if o.name in LAUNCH_CALLS]
    spans = [(s, ops) for s, ops in zip(view.spans, view.per_span(launches)) if ops]
    if not spans:
        return None
    return sum(max(o.end for o in ops) - s.start for s, ops in spans) / len(spans) / 1e3


def device_idle_percent(ctx) -> float | None:
    view = ctx.trace
    return None if view is None else 100.0 * (1.0 - view.busy_s / view.window_s)


def other_kernels_ms(ctx) -> float | None:
    """Device ms a request (step) spends in kernels that are not the
    program's own CUDA kernels."""
    view = ctx.trace
    if view is None:
        return None
    is_port = view.context["is_port_kernel"]
    spans = view.per_span(view.kernels)
    total = sum((o.end - o.start) for ops in spans for o in ops if not is_port(o.name))
    return total / len(spans) / 1e3


def mfu_percent(ctx, peak: float = H100_SXM["fp32_flop_per_s"]) -> float | None:
    """Model FLOPs of a request (step) over its mean time in the traced
    window, as a share of the card's fp32 peak."""
    view = ctx.trace
    if view is None:
        return None
    per_unit_s = view.window_s / len(view.spans)
    return 100.0 * view.context["model_flops"] / per_unit_s / peak
