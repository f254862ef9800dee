"""Shared ``--trace`` / ``--metrics`` wiring for the launch drivers — twin
of `repro.launch.obsflags`.

Every `repro_torch.launch` driver (train, serve, distributed_gcn) accepts
the same two flags:

    --metrics out.json   enable `repro_torch.obs.metrics`, write the
                         deterministic registry snapshot on exit
    --trace out.json     enable `repro_torch.obs.trace`, write Chrome
                         trace-event JSON (load in chrome://tracing or
                         ui.perfetto.dev)

`add_obs_args` registers the flags; `obs_session` is a context manager that
enables whichever were requested, runs the driver body, and exports on the
way out (also on exceptions: a crashing run still leaves its telemetry).
Neither flag given → everything stays on the disabled fast path. A driver
whose work runs in rank processes (`repro_torch.launch.distributed_gcn`)
installs rank 0's registry and recorder as the defaults before the
session exports them.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs import metrics, trace

__all__ = ["add_obs_args", "obs_session"]


def add_obs_args(ap) -> None:
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="enable the metrics registry; write its snapshot here on exit")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable span tracing; write Chrome trace-event JSON here on exit")


@contextlib.contextmanager
def obs_session(args):
    """Enable obs per the parsed ``args``; export to the given paths on exit."""
    if getattr(args, "metrics", None):
        metrics.enable(metrics.MetricsRegistry())
    if getattr(args, "trace", None):
        trace.set_default_tracer(trace.TraceRecorder())
    try:
        yield
    finally:
        if getattr(args, "metrics", None):
            metrics.to_json(args.metrics)
            print(f"metrics snapshot → {args.metrics}")
        if getattr(args, "trace", None):
            trace.export(args.trace)
            print(f"chrome trace → {args.trace} (open in ui.perfetto.dev)")
