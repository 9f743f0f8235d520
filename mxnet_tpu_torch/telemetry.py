"""Runtime telemetry: metrics registry, spans and structured events.

The port's counterpart of ``mxnet_tpu/telemetry.py``, cut to what the
serving stack reads: one process-wide, thread-safe registry of

* **counters**   — monotonically increasing event counts;
* **gauges**     — last-value instruments;
* **histograms** — bounded-bucket latency distributions with p50/p95/p99;

plus **named spans** (context managers observing their duration as a
histogram) and **structured events** (an in-memory bounded buffer).

Overhead contract, as in the JAX package: metric OBJECTS are always live
(an ``inc()`` on a disabled registry still counts, so rare-path counters
never lose events), but timing sites guard on :func:`enabled`, and
``span()`` returns a shared no-op object while telemetry is off.

Not ported yet: the chrome-trace profiler hooks of ``span`` (they wait for
the profiler's port and are no-ops here), the JSON-lines file sink and its
flusher, ``dump()`` and the Prometheus exposition.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "span", "event", "events", "enable", "enabled"]

# Latency buckets in seconds, as in the JAX package: 16 buckets + overflow,
# so a histogram's memory never grows with observation count.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 30.0,
)


class Counter:
    """Monotonic event count; ``inc`` is atomic under its own lock."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counter can only increase (got %r)" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-value instrument."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Bounded-bucket distribution with quantile estimates (linear
    interpolation inside the covering bucket, clamped to the observed
    min/max)."""

    __slots__ = ("name", "labels", "_lock", "_bounds", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name, buckets=None, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self._bounds) + 1)  # last = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v):
        v = float(v)
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def percentile(self, p):
        """Estimated value at percentile ``p`` (0-100), or None when empty."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p):
        if self._count == 0:
            return None
        target = self._count * min(max(p, 0.0), 100.0) / 100.0
        cum = 0
        lo = 0.0
        for i, hi in enumerate(self._bounds):
            prev = cum
            cum += self._counts[i]
            if cum >= target:
                frac = ((target - prev) / self._counts[i]) if self._counts[i] else 0.0
                est = lo + frac * (hi - lo)
                return min(max(est, self._min), self._max)
            lo = hi
        return self._max  # landed in the overflow bucket


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_lock = threading.RLock()
_metrics = {}  # rendered key -> instrument
_name_types = {}  # bare name -> instrument class (one kind per name)
_events = deque(maxlen=1024)
_enabled = False  # race-ok: config-time bool rebind


def _key(name, labels):
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join("%s=%s" % kv for kv in labels))


def _get(cls, name, labels_dict, **ctor_kw):
    labels = tuple(sorted((str(k), str(v)) for k, v in labels_dict.items()))
    key = _key(name, labels)
    with _lock:
        have = _name_types.setdefault(name, cls)
        if have is not cls:
            raise TypeError("metric name %r already registered as %s"
                            % (name, have.__name__))
        m = _metrics.get(key)
        if m is None:
            m = cls(name, labels=labels, **ctor_kw)
            _metrics[key] = m
        return m


def counter(name, **labels):
    """Get-or-create the counter ``name`` (labels are kwargs)."""
    return _get(Counter, name, labels)


def gauge(name, **labels):
    """Get-or-create the gauge ``name``."""
    return _get(Gauge, name, labels)


def histogram(name, buckets=None, **labels):
    """Get-or-create the histogram ``name`` (bounded buckets, seconds)."""
    return _get(Histogram, name, labels, buckets=buckets)


def enable():
    """Turn on timing capture, spans, and structured events."""
    global _enabled
    _enabled = True


def enabled():
    """Whether timing instrumentation sites should record."""
    return _enabled


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        histogram(self.name).observe(time.perf_counter() - self._t0)
        return False


def span(name, category="telemetry", **args):
    """Context manager timing one named span into histogram ``name`` while
    telemetry is enabled; a shared no-op otherwise. ``category`` and
    ``args`` feed the chrome-trace profiler in the JAX package and are
    accepted here for the same call sites."""
    del category, args
    if not _enabled:
        return _NULL_SPAN
    return _Span(name)


# ---------------------------------------------------------------------------
# structured events
# ---------------------------------------------------------------------------


def event(name, **fields):
    """Record a structured event into the bounded in-memory buffer (visible
    via :func:`events` and ``dump()['events']``). No-op while telemetry is
    disabled."""
    if not _enabled:
        return None
    rec = {"ts": time.time(), "type": "event", "event": name}
    rec.update(fields)
    with _lock:
        _events.append(rec)
    return rec


def events(name=None):
    """Buffered events, optionally filtered by event name (newest last)."""
    with _lock:
        recs = list(_events)
    if name is not None:
        recs = [r for r in recs if r.get("event") == name]
    return recs
