"""Process-local metrics registry: labeled counters, gauges, histograms —
twin of `repro.obs.metrics` (pure Python; the port keeps its own copy).

The instrumented layers of the port (so far `repro_torch.train.loop`) fold
their numbers into one registry with a deterministic snapshot
(docs/observability.md has the catalog).

Design constraints, in order:

1. **True no-op when disabled.** Hot loops call the module-level helpers
   (:func:`inc`, :func:`set_gauge`, :func:`observe`) unconditionally; with
   the registry disabled each call is one global read + an early return —
   no dict, no tuple, no instrument lookup, no allocation. Call sites that
   must build a label tuple or compute a value should guard with
   :func:`enabled` first.
2. **Deterministic snapshots.** :meth:`MetricsRegistry.snapshot` sorts
   series keys and carries no wall-clock state, so two identical runs
   produce byte-identical :meth:`MetricsRegistry.to_json` output — the
   property that makes metrics dumps diffable CI artifacts
   (`tools/bench_check.py` treats bench JSONs the same way).
3. **Fixed-bucket histograms.** :class:`Histogram` uses static upper
   bounds (default: :func:`exponential_buckets`), counts + sum + exact
   min/max; :meth:`Histogram.percentile` linearly interpolates inside the
   bucket, so its error is bounded by one bucket width (pinned against a
   numpy oracle).

Instruments are identified by ``(name, labels)`` where ``labels`` is a
tuple of ``(key, value)`` string pairs — hashable, order-normalized at
registration. The text form ``name{k=v,...}`` keys the snapshot.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "exponential_buckets",
    "default_registry",
    "set_default_registry",
    "enabled",
    "enable",
    "disable",
    "inc",
    "set_gauge",
    "observe",
    "snapshot",
    "to_json",
    "reset",
]

LabelPairs = "tuple[tuple[str, str], ...]"


def exponential_buckets(start: float = 0.001, factor: float = 2.0, count: int = 24):
    """``count`` exponentially-spaced upper bounds starting at ``start``.

    The default histogram layout: with start=1 ms-equivalent and factor 2,
    24 buckets span ~7 orders of magnitude — enough for everything from a
    µs-scale metrics call to a multi-second plan rebuild."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"bad bucket spec start={start} factor={factor} count={count}")
    out, edge = [], float(start)
    for _ in range(count):
        out.append(edge)
        edge *= factor
    return tuple(out)


_DEFAULT_BUCKETS = exponential_buckets()


class Counter:
    """Monotonic accumulator. ``inc`` with a negative value is an error."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter increments must be >= 0, got {value}")
        self.value += value

    def _snap(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins sample (cache hit rate, resident entries, loss)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, value: float) -> None:
        self.value += float(value)

    def _snap(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: static upper bounds + overflow, sum/count,
    exact min/max. ``observe`` is O(log buckets) (bisect)."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds=_DEFAULT_BUCKETS):
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram bounds must be strictly increasing, got {b!r}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)          # last slot = overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile, error <= one bucket width.

        ``p`` in [0, 100]. Empty histogram -> 0.0. The first/last populated
        buckets interpolate against the exact recorded min/max, so p0 and
        p100 are exact and a single-bucket histogram stays inside the data
        range instead of snapping to bucket edges."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if not self.count:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    def _snap(self):
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
        }


def _series_key(name: str, labels) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _norm_labels(labels) -> tuple:
    if not labels:
        return ()
    if isinstance(labels, dict):
        items = labels.items()
    else:
        items = labels
    return tuple(sorted((str(k), str(v)) for k, v in items))


class MetricsRegistry:
    """Thread-safe instrument store keyed by ``(kind, name, labels)``.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent, so
    call sites never pre-register); a name re-used across kinds is an
    error — one metric name means one thing in the catalog
    (docs/observability.md)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, object] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, kind: str, name: str, labels, factory):
        key = _series_key(name, _norm_labels(labels))
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev}, not {kind}"
                )
            inst = self._series.get(key)
            if inst is None:
                self._kinds[name] = kind
                inst = self._series[key] = factory()
            return inst

    def counter(self, name: str, labels=()) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, labels=()) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, labels=(), bounds=_DEFAULT_BUCKETS) -> Histogram:
        h = self._get("histogram", name, labels, lambda: Histogram(bounds))
        return h

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Sorted {series-key: state} dict — pure data, no timestamps, so
        identical runs produce identical snapshots."""
        with self._lock:
            return {k: self._series[k]._snap() for k in sorted(self._series)}

    def to_json(self, path: str | None = None, indent: int = 1) -> str:
        text = json.dumps(self.snapshot(), sort_keys=True, indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._kinds.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)


# ============================================================ module fast path
# One module-global registry + one bool. The helpers below are what the
# instrumented layers call per event; `_ENABLED is False` must make each a
# single global load + return (the pinned zero-overhead contract), so the
# signatures are fixed — no *args/**kwargs packing on the disabled path.
_DEFAULT = MetricsRegistry()
_ENABLED = False


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests isolate through this)."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, reg
    return old


def enabled() -> bool:
    return _ENABLED


def enable(registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Turn the module fast-path helpers on (optionally onto a fresh
    registry). Returns the active registry."""
    global _ENABLED
    if registry is not None:
        set_default_registry(registry)
    _ENABLED = True
    return _DEFAULT


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Clear the default registry (the enabled flag is left as is)."""
    _DEFAULT.reset()


def inc(name: str, value: float = 1.0, labels=()) -> None:
    if not _ENABLED:
        return
    _DEFAULT.counter(name, labels).inc(value)


def set_gauge(name: str, value: float, labels=()) -> None:
    if not _ENABLED:
        return
    _DEFAULT.gauge(name, labels).set(value)


def observe(name: str, value: float, labels=(), bounds=_DEFAULT_BUCKETS) -> None:
    if not _ENABLED:
        return
    _DEFAULT.histogram(name, labels, bounds).observe(value)


def snapshot() -> dict:
    return _DEFAULT.snapshot()


def to_json(path: str | None = None, indent: int = 1) -> str:
    return _DEFAULT.to_json(path, indent)
