"""Span tracing with Chrome trace-event export (Perfetto-loadable) — twin of
`repro.obs.trace`.

A :class:`TraceRecorder` collects *complete* events (``ph == "X"``) with
microsecond timestamps relative to the recorder's creation, plus counter
(``"C"``), instant (``"i"``) and metadata (``"M"``) events. The export
format is the Chrome trace-event JSON object form::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

which chrome://tracing and https://ui.perfetto.dev load directly.

Two honesty mechanisms for the card's asynchronous launches:

* **Sync points at span edges** — ``span(..., sync=x)`` (or setting
  ``handle.sync`` inside the block) calls ``torch.cuda.synchronize`` before
  recording the span end when ``x`` holds a CUDA tensor, so a span around
  launched work measures device work, not just Python dispatch time. Off
  by default: un-synced spans measure dispatch.
* **Raw complete events** — :meth:`TraceRecorder.complete` records a span
  from explicit start/duration, for work timed elsewhere.

Thread-safe: several threads may record concurrently. Each OS thread gets a small stable ``tid`` plus a
``thread_name`` metadata event; logical tracks (e.g. ``wire``) get their
own tids the same way. Span names follow ``layer.operation`` —
see docs/observability.md for the catalog.

When tracing is disabled the module-level helpers are no-ops on the same
fast-path contract as `repro_torch.obs.metrics`.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time

import torch

__all__ = [
    "TraceRecorder",
    "SpanHandle",
    "default_tracer",
    "set_default_tracer",
    "tracing_enabled",
    "enable_tracing",
    "disable_tracing",
    "span",
    "traced",
    "instant",
    "counter",
    "export",
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

    def counter(self, name: str, values: dict) -> None:
        """Counter ("C") event — renders as a stacked area track."""
        ev = {"name": name, "ph": "C", "ts": self.now_us(), "pid": self.pid,
              "tid": 0, "args": {k: float(v) for k, v in values.items()}}
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, sync=None, args: dict | None = None,
             track: str | None = None):
        """Context manager recording one complete event around the block.

        ``sync`` (or ``handle.sync`` set inside) is waited for on the card
        before the end timestamp, attributing device time to the span. ``track`` places the span on a named
        logical track instead of the calling thread's row."""
        handle = SpanHandle(sync=sync, args=args)
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

    def traced(self, name: str | None = None, sync_result: bool = False):
        """Decorator form of :meth:`span`. ``sync_result=True`` blocks on
        the wrapped function's return value before closing the span."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label) as h:
                    out = fn(*a, **kw)
                    if sync_result:
                        h.sync = out
                    return out

            return wrapper

        return deco

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


def span(name: str, sync=None, args: dict | None = None, track: str | None = None):
    if _DEFAULT is None:
        return _NULL_SPAN
    return _DEFAULT.span(name, sync=sync, args=args, track=track)


def traced(name: str | None = None, sync_result: bool = False):
    """Decorator that records through whatever tracer is installed at call
    time (so enabling tracing after import still takes effect)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tr = _DEFAULT
            if tr is None:
                return fn(*a, **kw)
            with tr.span(label) as h:
                out = fn(*a, **kw)
                if sync_result:
                    h.sync = out
                return out

        return wrapper

    return deco


def instant(name: str, args: dict | None = None) -> None:
    if _DEFAULT is not None:
        _DEFAULT.instant(name, args)


def counter(name: str, values: dict) -> None:
    if _DEFAULT is not None:
        _DEFAULT.counter(name, values)


def export(path: str) -> bool:
    """Export the global recorder's events; False if tracing is disabled."""
    if _DEFAULT is None:
        return False
    _DEFAULT.export(path)
    return True
