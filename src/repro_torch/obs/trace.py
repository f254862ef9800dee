"""Span tracing with Chrome trace-event export (Perfetto-loadable) — twin of
`repro.obs.trace`, and a bridge to `torch.profiler`.

A span goes to whatever is listening while its block runs:

* a :class:`TraceRecorder` installed as the process-global tracer
  (`enable_tracing`, or ``--trace OUT.json`` through
  `repro_torch.launch.obsflags`) collects *complete* events (``ph == "X"``)
  with microsecond timestamps relative to the recorder's creation, plus
  instant (``"i"``) and metadata (``"M"``) events, exported in the Chrome
  trace-event JSON object form::

      {"traceEvents": [...], "displayTimeUnit": "ms"}

  which chrome://tracing and https://ui.perfetto.dev load directly;
* a running `torch.profiler` (or `torch.autograd.profiler`) session gets a
  `torch.profiler.record_function` over the block: the profiler stamps the
  span on its own clock, beside the kernels and the launch calls, on
  whichever thread opened it (the autograd engine's device thread
  included);
* both, or neither: with no recorder and no profiler, `span` returns one
  shared no-op context (two global reads, no allocation).

Two honesty mechanisms for the recorder under the card's asynchronous
launches:

* **Sync points at span edges** — ``span(..., sync=x)`` (or setting
  ``handle.sync`` inside the block) calls ``torch.cuda.synchronize`` before
  recording the span end when ``x`` holds a CUDA tensor, so a span around
  launched work measures device work, not just Python dispatch time. Off
  by default: un-synced spans measure dispatch. A profiler needs no such
  wait (it records the device's own timestamps), so a span seen only by a
  profiler never waits.
* **Raw complete events** — :meth:`TraceRecorder.complete` records a span
  from explicit start/duration, for work timed elsewhere.

Thread-safe: several threads may record concurrently. Each OS thread gets a small stable ``tid`` plus a
``thread_name`` metadata event; logical tracks (e.g. ``wire``) get their
own tids the same way. Span names follow ``layer.operation`` —
see docs/observability_torch.md for the catalog.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "TraceRecorder",
    "SpanHandle",
    "default_tracer",
    "set_default_tracer",
    "tracing_enabled",
    "enable_tracing",
    "disable_tracing",
    "span",
    "instant",
    "export",
    "device_time_summary",
    "torch_profiler_trace",
]


class SpanHandle:
    """Mutable handle yielded by :meth:`TraceRecorder.span`.

    ``handle.sync = value`` arranges a wait for the card (when ``value``
    holds a CUDA tensor) before the span end is recorded; ``handle.args.update(...)`` attaches
    key/values shown in the Perfetto args pane."""

    __slots__ = ("sync", "args")

    def __init__(self, sync=None, args=None):
        self.sync = sync
        self.args = dict(args) if args else {}


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, or lists, tuples
    and dicts of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def _block(x) -> None:
    """Wait until the card has finished the work that produced ``x``."""
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)


class TraceRecorder:
    """Collects Chrome trace events; timestamps are µs since construction."""

    def __init__(self, pid: int = 1, process_name: str = "repro_torch"):
        self.pid = pid
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._t0 = time.perf_counter_ns()
        self._tids: dict[object, int] = {}
        self._meta(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_name}}
        )

    # ------------------------------------------------------------- plumbing
    def _meta(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _tid_for(self, key, label: str) -> int:
        with self._lock:
            tid = self._tids.get(key)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[key] = tid
                self._events.append(
                    {"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "args": {"name": label}}
                )
            return tid

    def _thread_tid(self) -> int:
        t = threading.current_thread()
        return self._tid_for(t.ident, t.name)

    def track_tid(self, name: str) -> int:
        """tid for a named logical track (e.g. ``wire``) rather than an OS
        thread — lets async device work live on its own timeline row."""
        return self._tid_for(("track", name), name)

    # --------------------------------------------------------------- events
    def complete(self, name: str, ts_us: float, dur_us: float,
                 tid: int | None = None, args: dict | None = None) -> None:
        """Record a complete ("X") event from explicit start + duration."""
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": max(dur_us, 0.0),
              "pid": self.pid, "tid": self._thread_tid() if tid is None else tid}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, args: dict | None = None) -> None:
        ev = {"name": name, "ph": "i", "ts": self.now_us(), "pid": self.pid,
              "tid": self._thread_tid(), "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, sync=None, args: dict | None = None,
             track: str | None = None):
        """Context manager recording one complete event around the block.

        ``sync`` (or ``handle.sync`` set inside) is waited for on the card
        before the end timestamp, attributing device time to the span. ``track`` places the span on a named
        logical track instead of the calling thread's row. A running
        profiler also records the span (`record_function`)."""
        handle = SpanHandle(sync=sync, args=args)
        with _profiled(name):
            t_start = self.now_us()
            try:
                yield handle
            finally:
                if handle.sync is not None:
                    _block(handle.sync)
                t_end = self.now_us()
                tid = self.track_tid(track) if track else self._thread_tid()
                self.complete(name, t_start, t_end - t_start, tid=tid,
                              args=handle.args or None)

    # --------------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # A recorder pickles without its lock, so that a rank process can hand
    # its events to the process that exports them.
    def __getstate__(self) -> dict:
        with self._lock:
            return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()


# ============================================================ module fast path
_DEFAULT: TraceRecorder | None = None


def default_tracer() -> TraceRecorder | None:
    return _DEFAULT


def set_default_tracer(tr: TraceRecorder | None) -> TraceRecorder | None:
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, tr
    return old


def tracing_enabled() -> bool:
    return _DEFAULT is not None


def enable_tracing() -> TraceRecorder:
    """Install (or return) the process-global recorder."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TraceRecorder()
    return _DEFAULT


def disable_tracing() -> None:
    global _DEFAULT
    _DEFAULT = None


class _NullSpan:
    """Disabled-path context manager: no recorder, no event, near-zero cost.

    A single module-level instance is reused; the handle it yields still
    accepts ``.sync``/``.args`` writes (they go nowhere)."""

    __slots__ = ("_handle",)

    def __init__(self):
        self._handle = SpanHandle()

    def __enter__(self):
        return self._handle

    def __exit__(self, *exc):
        self._handle.sync = None
        return False


_NULL_SPAN = _NullSpan()


def _profiled(name: str):
    """`record_function(name)` while a profiler session runs, else a
    no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _profiler_span(name: str):
    with torch.profiler.record_function(name):
        yield SpanHandle()


def span(name: str, sync=None, args: dict | None = None, track: str | None = None):
    """A span over the block for the installed recorder and a running
    profiler (see the module docstring); the shared no-op context when
    neither listens. Yields a :class:`SpanHandle` either way."""
    if _DEFAULT is not None:
        return _DEFAULT.span(name, sync=sync, args=args, track=track)
    if _autograd_profiler._is_profiler_enabled:
        return _profiler_span(name)
    return _NULL_SPAN


def instant(name: str, args: dict | None = None) -> None:
    if _DEFAULT is not None:
        _DEFAULT.instant(name, args)


def export(path: str) -> bool:
    """Export the global recorder's events; False if tracing is disabled."""
    if _DEFAULT is None:
        return False
    _DEFAULT.export(path)
    return True


def device_time_summary(events, steps: int = 1, top: int = 20) -> dict:
    """Device time of a `torch.profiler` window: ``events`` is
    ``list(prof.events())`` of a profile with the CUDA activity on.

    The device's busy time is the union of its kernels' intervals (the
    ``ProfilerStep#`` marks a scheduled profile also puts on the device
    timeline, and the device-side copies of `record_function` annotations
    such as `span`'s, are not kernels and are left out); the window spans every
    recorded event, host and device. Returns per-step window and busy ms,
    the idle share (``"not measured"`` when no device event was recorded),
    the device-event count, and the ``top`` kernels by device time with
    their launches per step."""
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep") and not getattr(e, "is_user_annotation", False)]
    busy, last = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) if events else 0.0
    by_name: dict[str, list] = {}          # kernel name → [µs, launches]
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        device_kernel_events=len(kernels), window_ms_per_step=window / steps / 1e3,
        device_busy_ms_per_step=busy / steps / 1e3,
        device_idle_share=(1.0 - busy / window) if kernels and window > 0 else "not measured",
        top_kernels=[dict(name=name[:160], ms_per_step=us / steps / 1e3, launches_per_step=n / steps)
                     for name, (us, n) in ranked])


@contextlib.contextmanager
def torch_profiler_trace(log_dir: str):
    """`torch.profiler` over the block, its trace written into ``log_dir``
    (TensorBoard's profiler plugin layout, ``*.pt.trace.json``, which
    Perfetto also loads) — the counterpart of the reference's
    ``jax_profiler_trace``. It records the host and, where a CUDA card is
    present, the card's kernels; it has no fallback: a profiler that cannot
    start raises. Yields the running `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
