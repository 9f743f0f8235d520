"""Runtime telemetry: metrics registry, spans and structured events.

The port's counterpart of ``mxnet_tpu/telemetry.py``, cut to what the
serving stack reads: one process-wide, thread-safe registry of

* **counters**   — monotonically increasing event counts;
* **gauges**     — last-value instruments;
* **histograms** — bounded-bucket latency distributions with p50/p95/p99;

plus **named spans** (context managers observing their duration as a
histogram) and **structured events** (an in-memory bounded buffer, and
JSON lines in the file sink).

Exposition, as in the JAX package:

* ``dump()``             — JSON-serializable snapshot of every instrument;
* ``prometheus_text()``  — Prometheus text exposition format (metric names
  sanitized and prefixed ``mxnet_``, ``# HELP`` from :data:`METRIC_HELP`);
* a background flusher   — ``MXNET_TELEMETRY_FILE`` names a JSON-lines sink
  (``{pid}``/``{rank}`` expand); a daemon thread appends a snapshot record
  every ``MXNET_TELEMETRY_INTERVAL_S`` seconds (default 60) and a final
  one at exit; structured events are appended as they happen.

Overhead contract, as in the JAX package: metric OBJECTS are always live
(an ``inc()`` on a disabled registry still counts, so rare-path counters
never lose events), but timing sites guard on :func:`enabled`, and
``span()`` returns a shared no-op object while telemetry is off.

Enable with ``MXNET_TELEMETRY=1``, by setting ``MXNET_TELEMETRY_FILE``, or
with :func:`enable`. Not ported yet: the chrome-trace profiler hooks of
``span`` (they wait for the profiler's port, ``ROADMAP.md`` A7, and are
no-ops here) and the input pipeline's stage helpers.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time
from collections import deque

from .base import env_float as _env_float, env_str as _env_str

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "span", "event", "events", "enable", "disable", "enabled",
           "dump", "prometheus_text", "reset", "state_summary", "totals",
           "flush", "start_flusher", "stop_flusher", "register_collector",
           "set_rank", "get_rank", "METRIC_HELP", "pipeline_stage",
           "PIPELINE_STAGES"]

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

    def snapshot(self):
        return self.value


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

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


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

    def snapshot(self):
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            cum, cum_counts = 0, []
            for c in self._counts[:-1]:
                cum += c
                cum_counts.append(cum)
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "p50": self._percentile_locked(50),
                "p95": self._percentile_locked(95),
                "p99": self._percentile_locked(99),
                "buckets": {  # cumulative, le-keyed (Prometheus convention)
                    **{("%g" % b): c for b, c in zip(self._bounds, cum_counts)},
                    "+Inf": self._count,
                },
            }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_lock = threading.RLock()
_metrics = {}  # rendered key -> instrument
_name_types = {}  # bare name -> instrument class (one kind per name)
_events = deque(maxlen=1024)
_enabled = False  # race-ok: config-time bool rebind
_flusher = None  # guarded-by: _lock — (thread, stop_event, path, interval)
_file_lock = threading.Lock()  # serializes sink appends (flusher vs events)
_rank = None  # race-ok: set once at launch (int-or-None rebind)
_collectors = []  # guarded-by: _lock — read-time refresh hooks


def register_collector(fn):
    """Register a nullary hook run at the top of every registry read
    (``dump`` / ``prometheus_text`` / ``state_summary``) to refresh derived
    gauges. Collectors must be cheap; one that raises is logged and
    skipped, so a broken collector cannot take down a scrape."""
    with _lock:
        if fn not in _collectors:
            _collectors.append(fn)


def _run_collectors():
    with _lock:
        hooks = list(_collectors)
    for fn in hooks:
        try:
            fn()
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "telemetry collector %r failed", fn, exc_info=True)


def set_rank(rank):
    """Tag this process with its worker rank: every structured event and
    snapshot record from now on carries a ``rank`` field, and ``{rank}``
    in the sink path expands to it. ``None`` clears it."""
    global _rank
    _rank = None if rank is None else int(rank)


def get_rank():
    """The rank set via :func:`set_rank`, or None."""
    return _rank


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


def disable():
    global _enabled
    _enabled = False


def enabled():
    """Whether timing instrumentation sites should record."""
    return _enabled


def reset():
    """Drop every instrument and buffered event (test isolation)."""
    with _lock:
        _metrics.clear()
        _name_types.clear()
        _events.clear()


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
    via :func:`events` and ``dump()['events']``), and append it as one JSON
    line to ``MXNET_TELEMETRY_FILE`` when a file sink is active. No-op
    while telemetry is disabled."""
    if not _enabled:
        return None
    rec = {"ts": time.time(), "type": "event", "event": name}
    if _rank is not None:
        rec["rank"] = _rank
    rec.update(fields)
    with _lock:
        _events.append(rec)
        sink = (_flusher[2] if _flusher
                else _expand_sink_path(_env_str("MXNET_TELEMETRY_FILE")))
    if sink:
        _append_line(sink, rec)
    return rec


def events(name=None):
    """Buffered events, optionally filtered by event name (newest last)."""
    with _lock:
        recs = list(_events)
    if name is not None:
        recs = [r for r in recs if r.get("event") == name]
    return recs


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------


def dump(include_events=True):
    """JSON-serializable snapshot of the whole registry."""
    _run_collectors()
    with _lock:
        items = sorted(_metrics.items())
        evs = list(_events) if include_events else None
    out = {
        "ts": time.time(),
        "enabled": _enabled,
        "counters": {},
        "gauges": {},
        "histograms": {},
    }
    kind = {Counter: "counters", Gauge: "gauges", Histogram: "histograms"}
    for key, m in items:
        out[kind[type(m)]][key] = m.snapshot()
    if evs is not None:
        out["events"] = evs
    return out


def state_summary(prefixes=()):
    """Compact ``{metric_key: value}`` snapshot, filtered to metric names
    starting with any of ``prefixes`` (all when empty): counters and
    gauges render their value, histograms ``count`` and ``p99``."""
    _run_collectors()
    with _lock:
        items = sorted(_metrics.items())
    out = {}
    for key, m in items:
        if prefixes and not any(m.name.startswith(p) for p in prefixes):
            continue
        if isinstance(m, Histogram):
            snap = m.snapshot()
            out[key] = {"count": snap["count"], "p99": snap.get("p99")}
        else:
            out[key] = m.snapshot()
    return out


def totals(name):
    """Aggregate every instrument sharing bare metric ``name`` across its
    label sets: histograms return ``(count, sum)``; counters and gauges
    ``(n_instruments, value_sum)``; ``(0, 0.0)`` when none is registered."""
    with _lock:
        ms = [m for m in _metrics.values() if m.name == name]
    count, total = 0, 0.0
    for m in ms:
        if isinstance(m, Histogram):
            with m._lock:
                count += m._count
                total += m._sum
        else:
            count += 1
            total += m.value
    return count, total


# Input-pipeline stage attribution (the JAX package's ladder): the Python
# decode workers' per-record decode+augment and the batcher's assembly, the
# device feed's upload and the consumer's wait on it, and the native stage's
# summed decode, augment and assembly walls (polled per batch)
PIPELINE_STAGES = ("decode", "assemble", "upload", "feed_wait",
                   "decode_native", "augment_native", "assemble_native")


def pipeline_stage(stage):
    """The ``pipeline.stage_seconds{stage=...}`` histogram for one stage."""
    return histogram("pipeline.stage_seconds", stage=stage)


# One row per metric NAME the port registers (the JAX package's catalog cut
# to these names, its wording kept where the meaning is the same); the
# Prometheus exposition emits each entry as a ``# HELP`` line.
METRIC_HELP = {
    "compile.count":
        "CUDA graphs captured per logical program: one per shape bucket "
        "(on the CPU, a bucket's first run) (always-on)",
    "compile.seconds":
        "capture wall per program: warm-up run + graph capture (on the "
        "CPU, the bucket's first run) (always-on)",
    "speedometer.samples_per_sec": "last Speedometer window sample",
    "pipeline.stage_seconds":
        "input-pipeline wall per stage (decode, assemble, upload, "
        "feed_wait, decode_native, augment_native, assemble_native)",
    "io.batch_fetch_seconds": "per-iterator batch fetch latency",
    "io.bad_records": "corrupt records quarantined by source (always-on)",
    "io.native_decode_fallback":
        "ImageRecordIter configs that asked for the native decode stage "
        "and took the Python pipeline, by reason (always-on)",
    "fault.injections": "fired fault-injection rules by point (always-on)",
    "serving.kv_blocks_total": "usable KV pool blocks (pool size minus the "
                               "reserved trash block)",
    "serving.kv_blocks_used": "KV pool blocks currently allocated to "
                              "requests",
    "serving.kv_blocks_free": "KV pool blocks on the free list",
    "serving.kv_blocks_frag_slots":
        "internal fragmentation: allocated-but-unused tail-block token "
        "slots across running requests",
    "serving.kv_blocks_allocs": "KV pool blocks handed out (cumulative)",
    "serving.kv_blocks_frees": "KV pool blocks returned (cumulative)",
    "serving.kv_blocks_alloc_failures":
        "KV pool allocations refused for exhaustion (each triggers "
        "preemption or request failure) (always-on)",
    "serving.queue_depth": "requests waiting for admission",
    "serving.active_requests": "requests admitted and holding KV blocks",
    "serving.requests_admitted": "requests admitted into prefill",
    "serving.requests_completed": "requests finished successfully",
    "serving.requests_failed":
        "requests failed (pool too small / engine error) (always-on)",
    "serving.preemptions":
        "recompute-style evictions under KV-block exhaustion (always-on)",
    "serving.step": "serving engine step wall (span histogram)",
    "serving.prefill_seconds": "per-request prefill dispatch wall",
    "serving.prefill_tokens": "prompt+replay tokens prefilled",
    "serving.decode_batch": "live streams per fused decode step",
    "serving.generated_tokens": "tokens generated across all streams",
    "serving.ttft_seconds": "request time-to-first-token "
        "(bare = process-wide; engine label = per-engine)",
    "serving.request_latency_seconds": "request end-to-end latency "
        "(bare = process-wide; engine label = per-engine)",
    "serving.tokens_per_sec":
        "generated tokens/sec over a sliding 10s window",
    "serving.phase_seconds":
        "per-request wall by phase{engine,phase}: queue_wait / prefill / "
        "decode / replay / compile_stall sum to end-to-end "
        "(serving/obs.py)",
    "serving.tpot_seconds":
        "per-request time-per-output-token{engine} (decode-phase "
        "requests, >= 2 tokens)",
    "serving.slo_good":
        "requests meeting the SLO target{engine,phase}: phase=ttft vs "
        "MXNET_SERVING_SLO_TTFT_MS, phase=tpot vs "
        "MXNET_SERVING_SLO_TPOT_MS (always-on)",
    "serving.slo_total":
        "requests judged against the SLO target{engine,phase} (always-on)",
    "serving.goodput":
        "fraction of the last 32 finished requests meeting every "
        "applicable SLO target{engine}",
    "serving.prefix_lookups":
        "admissions probed against the prefix index "
        "(MXNET_SERVING_PREFIX_CACHE)",
    "serving.prefix_hits": "admissions that mapped >= 1 cached prefix block",
    "serving.prefix_hit_blocks":
        "KV blocks mapped from the prefix index instead of re-prefilled "
        "(cumulative)",
    "serving.prefix_shared_blocks":
        "allocated KV blocks currently shared by >= 2 streams",
    "serving.prefix_kv_bytes_saved":
        "KV bytes deduplicated right now: sum over shared blocks of "
        "(refcount-1) x block bytes",
    "serving.prefix_cow_copies":
        "copy-on-write block copies (a write slot backed by a shared "
        "block got a private copy)",
    "serving.spec_proposed_tokens":
        "draft tokens proposed (spec_k per stream per speculative step, "
        "MXNET_SERVING_SPEC_K)",
    "serving.spec_accepted_tokens":
        "draft proposals the target's verify pass accepted (emitted "
        "tokens stay bit-identical to target-only decoding)",
    "serving.spec_draft_seconds":
        "draft-model wall per speculative decode step (stall-free; the "
        "decode phase's draft sub-share)",
    "serving.spec_verify_seconds":
        "target multi-query verify wall per speculative decode step "
        "(stall-free)",
    "serving.shed":
        "submits rejected by load shedding (queue at MXNET_SERVING_MAX_"
        "QUEUE, engine draining, or supervisor mid-restart) — the 503 + "
        "Retry-After path (always-on)",
    "serving.timeouts":
        "requests swept to TIMED_OUT at their deadline (timeout_s / "
        "MXNET_SERVING_DEFAULT_TIMEOUT_MS); KV blocks freed at the sweep "
        "(always-on)",
    "serving.cancelled":
        "requests swept to CANCELLED after the consumer walked away "
        "(dropped connection / engine.cancel) (always-on)",
    "serving.restarts":
        "supervised engine restarts: abort -> salvage -> backoff -> "
        "rebuild warm -> replay survivors (resilience.EngineSupervisor) "
        "(always-on)",
    "serving.drains":
        "graceful drains begun (SIGTERM / POST /drain / start_drain): "
        "admission closed, inflight work finishing (always-on)",
    "lock.held_seconds":
        "hold time per witness-declared lock (MXNET_LOCK_WITNESS; "
        "always-on while the witness is enabled)",
    "lock.contention":
        "witnessed acquisitions that found the lock already taken "
        "(always-on while the witness is enabled)",
    "lock.order_violations":
        "classified lock-order violations the runtime witness observed: "
        "order inversions + edges absent from the static lock graph "
        "(always-on while the witness is enabled; strict mode also "
        "raises)",
}


def _prom_name(name):
    import re

    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", name):
        name = "_" + name
    return "mxnet_" + name


def _prom_labels(labels, extra=()):
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace("\\", "\\\\")
                                 .replace('"', '\\"'))
                    for k, v in pairs)
    return "{%s}" % body


def _prom_num(v):
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text():
    """The registry in Prometheus text exposition format (v0.0.4).

    Metric names are sanitized (``.`` -> ``_``) and prefixed ``mxnet_``;
    histograms expose the standard ``_bucket``/``_sum``/``_count`` triplet
    with cumulative ``le`` buckets."""
    _run_collectors()
    with _lock:
        items = sorted(_metrics.items())
    by_name = {}
    for _, m in items:
        by_name.setdefault(m.name, []).append(m)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        pname = _prom_name(name)
        help_text = METRIC_HELP.get(name)
        if help_text:
            lines.append("# HELP %s %s" % (
                pname, help_text.replace("\\", "\\\\")
                .replace("\n", "\\n")))
        if isinstance(group[0], Counter):
            lines.append("# TYPE %s counter" % pname)
            for m in group:
                lines.append("%s%s %s" % (pname, _prom_labels(m.labels),
                                          _prom_num(m.value)))
        elif isinstance(group[0], Gauge):
            lines.append("# TYPE %s gauge" % pname)
            for m in group:
                lines.append("%s%s %s" % (pname, _prom_labels(m.labels),
                                          _prom_num(m.value)))
        else:
            lines.append("# TYPE %s histogram" % pname)
            for m in group:
                # ONE snapshot feeds every line: a second read of the live
                # counts could print finite buckets above le="+Inf"
                snap = m.snapshot()
                buckets = snap.get("buckets")
                if buckets is None:  # empty histogram: all-zero buckets
                    buckets = {"%g" % b: 0 for b in m._bounds}
                    buckets["+Inf"] = 0
                for le, cum in buckets.items():
                    lines.append("%s_bucket%s %d" % (
                        pname, _prom_labels(m.labels, (("le", le),)), cum))
                lines.append("%s_sum%s %s" % (pname, _prom_labels(m.labels),
                                              _prom_num(snap["sum"])))
                lines.append("%s_count%s %d" % (pname, _prom_labels(m.labels),
                                                snap["count"]))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the JSON-lines sink and its flusher
# ---------------------------------------------------------------------------


def _expand_sink_path(path):
    """Expand ``{pid}`` / ``{rank}`` in a sink path, so the processes of one
    job that inherit the same ``MXNET_TELEMETRY_FILE`` write one file each.
    ``{rank}`` is the worker rank (a server process: ``s<id>``; outside a
    launch: the pid)."""
    if not path or "{" not in path:
        return path
    import os

    rank = _rank
    if rank is None:
        if os.environ.get("DMLC_ROLE") == "server":
            rank = "s%s" % os.environ.get("DMLC_SERVER_ID", "0")
        else:
            rank = os.environ.get("DMLC_WORKER_ID", str(os.getpid()))
    return (path.replace("{pid}", str(os.getpid()))
            .replace("{rank}", str(rank)))


def _append_line(path, rec):
    # one writer at a time: a snapshot append racing an event append would
    # interleave buffered chunks and tear the JSON lines
    try:
        with _file_lock, open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        import logging

        logging.getLogger(__name__).warning(
            "telemetry: cannot append to %s", path, exc_info=True)


def flush(path=None):
    """Append one snapshot record to the JSON-lines sink now."""
    if not path:
        with _lock:
            path = _flusher[2] if _flusher else None
        path = path or _expand_sink_path(_env_str("MXNET_TELEMETRY_FILE"))
    if not path:
        return
    rec = dump(include_events=False)
    rec["type"] = "snapshot"
    if _rank is not None:
        rec["rank"] = _rank
    _append_line(path, rec)


def start_flusher(path=None, interval_s=None):
    """Start the periodic snapshot flusher (idempotent). Defaults come from
    ``MXNET_TELEMETRY_FILE`` / ``MXNET_TELEMETRY_INTERVAL_S`` (60 s,
    floored at 0.05 s). Also enables telemetry: a flushing but disabled
    registry would record empty snapshots."""
    global _flusher
    path = _expand_sink_path(path or _env_str("MXNET_TELEMETRY_FILE"))
    if not path:
        raise ValueError("no telemetry file: pass path= or set "
                         "MXNET_TELEMETRY_FILE")
    if interval_s is None:
        interval_s = _env_float("MXNET_TELEMETRY_INTERVAL_S", 60.0)
    interval_s = max(float(interval_s), 0.05)
    with _lock:
        if _flusher is not None:
            return
        enable()
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                flush(path)

        t = threading.Thread(target=loop, name="mxnet-telemetry-flusher",
                             daemon=True)
        _flusher = (t, stop, path, interval_s)
        t.start()


def stop_flusher(final_flush=True):
    """Stop the periodic flusher (writing one last snapshot by default)."""
    global _flusher
    with _lock:
        if _flusher is None:
            return
        t, stop, path, _ = _flusher
        _flusher = None
    stop.set()
    t.join(timeout=5)
    if final_flush:
        flush(path)


def _maybe_autostart():
    import atexit
    import os

    from .base import env_flag

    if os.environ.get("DMLC_ROLE", "worker") == "worker" and \
            os.environ.get("DMLC_WORKER_ID"):
        set_rank(os.environ["DMLC_WORKER_ID"])
    if _env_str("MXNET_TELEMETRY_FILE"):
        start_flusher()
        atexit.register(stop_flusher)
    elif env_flag("MXNET_TELEMETRY"):
        enable()


_maybe_autostart()
