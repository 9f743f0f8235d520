"""Compile and device-memory observability: the program registry
(counterpart of ``mxnet_tpu/compileobs.py``).

The JAX package routes every ``jax.jit`` through one registry. The port
has no tracer and no XLA compile; its **programs** are

* a CUDA graph captured on the card — the fused training step
  (``fused.step``, ``fused.grad_step``, ``fused.apply_grads`` in
  ``parallel/spmd.py``) and the serving engine's bucket graphs
  (``serving.prefill``/``decode``/``draft``/``verify`` in
  ``serving/graphs.py``); the capture's host seconds are its compile
  seconds;
* the first run of a call site at a new input signature where nothing is
  captured — the same fused step on the CPU, the executor's
  ``executor.fwd_eval`` and ``executor.fwd_bwd`` (eager on either
  device); that run's seconds are its compile seconds;
* an ``nvcc`` build of a kernel source (``ops/_build.py``: program
  ``nvcc.<source>``), charged its build seconds, or the seconds it took
  to copy the library from the persistent compile cache.

With the compile cache on (:mod:`.compile_cache`), every compile is
classified warm or cold (``compile.cache_hits`` / ``cache_misses``), and
:func:`summary` carries the totals with ``cache_errors``.

Per logical program the registry records, as the JAX package's does: a
graph digest (:func:`symbol_digest`, the JAX package's, value for value),
the input signature of every compile, so a recompile is *attributed*
(:func:`diff_signatures`: the ``compile.recompile`` event and counter name
the axis that changed — batch, seq_len, axis-k — or a dtype or structure
change), compile seconds (always-on ``compile.count`` /
``compile.seconds{program}`` and a span on the profiler's ``compile``
lane) against cumulative run seconds, the input footprint
(``arg_bytes``) and the card's peak allocation right after the compile.

Device memory: ``device.bytes_in_use`` / ``device.peak_bytes`` gauges per
card from ``torch.cuda.memory_stats`` (never initializing CUDA to read
them), and OOM forensics: :func:`oom_guard` wraps the executor boundary
and the fused step, and when the block dies of a device out-of-memory
(``torch.cuda.OutOfMemoryError``, or the ``oom`` fault point) it logs the
top live tensors and the program table, then re-raises.
"""
from __future__ import annotations

import gc
import hashlib
import logging
import threading
import time

from . import telemetry
from .base import MXNetError, env_int
from .profiler import COMPILE_TRACE_TID

__all__ = [
    "Program", "note_compile", "note_run", "record_compile", "signature",
    "oom_guard", "symbol_digest", "diff_signatures", "program_table",
    "summary", "last_recompile", "recompile_log", "reset",
    "device_memory_stats", "live_tensor_report", "update_memory_gauges",
    "is_oom_error", "dump_oom_report", "COMPILE_TRACE_TID",
]

_log = logging.getLogger(__name__)

_lock = threading.RLock()
_programs = {}  # program name -> _ProgramRecord
_recompiles = []  # chronological recompile attributions (bounded)
_MAX_RECOMPILE_LOG = 256

_lane_lock = threading.Lock()
_lane_last_end = 0.0


def _emit_compile_span(name, wall0, dur, args):
    """One span on the compile lane; a span that would overlap the lane's
    last one starts after it ends (its duration kept)."""
    global _lane_last_end

    from . import profiler

    with _lane_lock:
        start = max(wall0, _lane_last_end)
        _lane_last_end = start + dur
    profiler.emit_span(name, "compile", start, dur, args=args,
                       tid=COMPILE_TRACE_TID)


class _ProgramRecord:
    """Registry row for one logical program (all call sites sharing a
    name)."""

    __slots__ = ("name", "site", "digest", "compile_count", "compile_seconds",
                 "run_count", "run_seconds", "recompile_count", "arg_bytes",
                 "peak_bytes", "first_compile_ts", "last_compile_ts",
                 "signatures", "lock")

    def __init__(self, name, site, digest):
        self.name = name
        self.site = site
        self.digest = digest
        self.compile_count = 0
        self.compile_seconds = 0.0
        self.run_count = 0
        self.run_seconds = 0.0
        self.recompile_count = 0
        self.arg_bytes = 0
        self.peak_bytes = None  # the card's peak right after the last compile
        self.first_compile_ts = None
        self.last_compile_ts = None
        # graph_key -> last compiled signature: a rebind or a new module
        # over the SAME graph diffs against what that graph compiled at
        self.signatures = {}
        self.lock = threading.Lock()

    def as_dict(self):
        with self.lock:
            return {
                "program": self.name,
                "site": self.site,
                "digest": self.digest,
                "compile_count": self.compile_count,
                "compile_seconds": round(self.compile_seconds, 6),
                "run_count": self.run_count,
                "run_seconds": round(self.run_seconds, 6),
                "recompile_count": self.recompile_count,
                "arg_bytes": self.arg_bytes,
                "peak_bytes": self.peak_bytes,
                "first_compile_ts": self.first_compile_ts,
                "last_compile_ts": self.last_compile_ts,
            }


def _record(name, site=None, digest=None):
    with _lock:
        rec = _programs.get(name)
        if rec is None:
            rec = _ProgramRecord(name, site or "", digest or "")
            _programs[name] = rec
        else:
            if site and not rec.site:
                rec.site = site
            if digest and not rec.digest:
                rec.digest = digest
        return rec


def reset():
    """Drop every program record (test isolation). The ``compile.*``
    metrics live in the telemetry registry and reset with it."""
    with _lock:
        _programs.clear()
        del _recompiles[:]


# ---------------------------------------------------------------------------
# graph digests & input signatures
# ---------------------------------------------------------------------------


def symbol_digest(symbol):
    """Stable digest of a Symbol's computation graph: the topo-ordered op
    sequence with attrs and the full edge wiring, independent of bind
    shapes and of node names — the JAX package's, value for value.
    Variables hash by role and slot (``a<i>`` the i-th argument, ``x<j>``
    the j-th auxiliary state), never by name."""
    from .symbol import _topo_order

    order = _topo_order(symbol._entries)
    idx = {id(n): i for i, n in enumerate(order)}
    _, aux_vars = symbol._arg_aux_split()
    h = hashlib.sha1()
    n_arg = n_aux = 0
    for node in order:
        if node.is_variable:
            if id(node) in aux_vars:
                h.update(("var:x%d|" % n_aux).encode())
                n_aux += 1
            else:
                h.update(("var:a%d|" % n_arg).encode())
                n_arg += 1
            continue
        h.update(node.op.encode())
        for k, v in sorted(node.attrs.items()):
            h.update(("|%s=%s" % (k, v)).encode())
        for inp, k in node.inputs:
            h.update(("|@%d.%d" % (idx[id(inp)], k)).encode())
        h.update(b";")
    h.update(("out:" + ",".join(
        "%d.%d" % (idx[id(n)], k) for n, k in symbol._entries)).encode())
    return h.hexdigest()[:16]


def _leaf_desc(leaf):
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None:
        return ("py:%s" % type(leaf).__name__, (), "")
    return ("", tuple(int(d) for d in shape), str(dtype).replace("torch.", ""))


def signature(named_leaves):
    """The per-leaf ``(name, kind, shape, dtype)`` tuple of a call's
    inputs, from ``(name, tensor)`` pairs in the call's order."""
    return tuple((name,) + _leaf_desc(leaf) for name, leaf in named_leaves)


def _axis_name(axis, rank):
    if axis == 0:
        return "batch"
    # "seq_len" only for token-shaped inputs (B,T) / (B,T,D): axis 1 of a
    # rank-4 image tensor is channels or height, not sequence length
    if axis == 1 and rank in (2, 3):
        return "seq_len"
    return "axis%d" % axis


def diff_signatures(old, new):
    """Attribute what changed between two compiled signatures of the same
    program: ``(cause, detail)`` where cause is one of ``batch`` /
    ``seq_len`` / ``axis<k>`` / ``dtype`` / ``rank`` / ``structure`` /
    ``placement`` (same shapes — the device moved, which a shape-level
    signature cannot see)."""
    if old == new:
        return "placement", {"note": "identical shapes: device/sharding or "
                                     "static-config change"}
    if len(old) != len(new) or \
            [e[0] for e in old] != [e[0] for e in new]:
        return "structure", {"old_leaves": len(old), "new_leaves": len(new)}
    changed = []
    for (name, okind, oshape, odt), (_, nkind, nshape, ndt) in zip(old, new):
        if okind != nkind or oshape != nshape or odt != ndt:
            changed.append((name, oshape, odt, nshape, ndt))
    if not changed:
        return "placement", {}
    name, oshape, odt, nshape, ndt = changed[0]
    detail = {"arg": name, "old_shape": list(oshape),
              "new_shape": list(nshape), "n_changed": len(changed)}
    if odt != ndt:
        detail["old_dtype"], detail["new_dtype"] = odt, ndt
        if oshape == nshape:
            return "dtype", detail
    if len(oshape) != len(nshape):
        return "rank", detail
    axes = [i for i, (a, b) in enumerate(zip(oshape, nshape)) if a != b]
    if not axes:
        return "dtype", detail
    detail["axis"] = axes[0]
    return _axis_name(axes[0], len(oshape)), detail


_ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "float64": 8,
             "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}


def _arg_nbytes(sig):
    import numpy as np

    total = 0
    for _, kind, shape, dtype in sig:
        if kind or not dtype:
            continue
        n = _ITEMSIZE.get(dtype)
        if n is None:
            try:
                n = int(np.dtype(dtype).itemsize)
            except TypeError:
                continue
        for d in shape:
            n *= int(d)
        total += n
    return total


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _classify(program, sig, graph_key, digest, seconds, cache_key, cached):
    """The persistent cache's verdict on this compile (``compile.cache_hits``
    / ``compile.cache_misses``): True for warm, False for cold, None while
    the cache is off or the program has no identity to key."""
    from . import compile_cache as _cc

    if not _cc.enabled():
        return None
    identity = digest if digest is not None else graph_key
    if cache_key is None and identity is None:
        return None
    try:
        if cache_key is None:
            cache_key = _cc.make_key(program, identity, sig)
        cls = _cc.classify_compile(program, cache_key, seconds, hit=cached)
    except Exception:
        telemetry.counter("compile.cache_errors").inc()
        return None
    return None if cls is None else cls == "hit"


def note_compile(program, seconds, sig=(), graph_key=None, site=None,
                 digest=None, wall0=None, cache_key=None, cached=None):
    """Charge ``seconds`` to ``program`` as one compile at input signature
    ``sig``. When the program's graph ``graph_key`` compiled before, the
    old and new signatures are diffed into a ``compile.recompile``
    attribution (any compile after the graph's first is a recompile).
    With the persistent compile cache on, the compile is classified warm
    or cold (by ``cache_key``, else a key of the program, its digest and
    ``sig``; ``cached`` states the verdict where the caller knows it) and
    the ``compile`` event carries ``cached``."""
    rec = _record(program, site=site, digest=digest)
    if wall0 is None:
        wall0 = time.time() - seconds
    nbytes = _arg_nbytes(sig)
    with rec.lock:
        rec.compile_count += 1
        rec.compile_seconds += seconds
        rec.arg_bytes = max(rec.arg_bytes, nbytes)
        now = wall0 + seconds
        if rec.first_compile_ts is None:
            rec.first_compile_ts = now
        rec.last_compile_ts = now
        prev = None
        if graph_key is not None:
            prev = rec.signatures.get(graph_key)
            rec.signatures[graph_key] = sig
    cached = _classify(rec.name, sig, graph_key, digest, seconds,
                       cache_key, cached)
    telemetry.counter("compile.count", program=rec.name).inc()
    telemetry.histogram("compile.seconds", program=rec.name).observe(seconds)
    _emit_compile_span("compile[%s]" % rec.name, wall0, seconds,
                       {"program": rec.name, "site": rec.site})
    ev = {"program": rec.name, "site": rec.site,
          "seconds": round(seconds, 6), "count": rec.compile_count,
          "arg_bytes": nbytes}
    if cached is not None:
        ev["cached"] = cached
    telemetry.event("compile", **ev)
    peak = _backend_peak_bytes()
    if peak is not None:
        with rec.lock:
            rec.peak_bytes = peak
    if prev is not None:
        _note_recompile(rec, prev, sig, seconds)


def _note_recompile(rec, prev, sig, seconds):
    cause, detail = diff_signatures(prev, sig)
    with rec.lock:
        rec.recompile_count += 1
    telemetry.counter("compile.recompile", program=rec.name,
                      cause=cause).inc()
    entry = {"ts": time.time(), "program": rec.name, "site": rec.site,
             "cause": cause, "seconds": round(seconds, 6)}
    entry.update(detail)
    with _lock:
        _recompiles.append(entry)
        if len(_recompiles) > _MAX_RECOMPILE_LOG:
            del _recompiles[:len(_recompiles) - _MAX_RECOMPILE_LOG]
    telemetry.event("compile.recompile", **entry)
    _log.warning(
        "compile: program %r recompiled (%s%s) at %s — %.2fs",
        rec.name, cause,
        ", arg %s %s->%s" % (detail.get("arg"), detail.get("old_shape"),
                             detail.get("new_shape"))
        if detail.get("arg") else "",
        rec.site or "<unknown site>", seconds)


def note_run(program, seconds):
    """Charge ``seconds`` to ``program`` as one steady-state run."""
    rec = _record(program)
    with rec.lock:
        rec.run_count += 1
        rec.run_seconds += seconds


class record_compile:
    """Context manager charging a block's wall time to ``program`` as one
    compile at ``sig`` (a CUDA-graph capture, a build); nothing is charged
    when the block raises."""

    def __init__(self, program, sig=(), graph_key=None, site=None,
                 digest=None):
        self._args = (program, sig, graph_key, site, digest)

    def __enter__(self):
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            program, sig, graph_key, site, digest = self._args
            note_compile(program, time.perf_counter() - self._t0, sig,
                         graph_key=graph_key, site=site, digest=digest,
                         wall0=self._wall0)
        return False


class Program:
    """One call site's program where nothing is captured: the first call
    at each new input signature is charged as a compile, every later one
    as a run. ``graph_key`` (the symbol digest) links call sites over the
    same graph for recompile attribution."""

    __slots__ = ("name", "site", "graph_key", "digest", "_seen")

    def __init__(self, name, site=None, graph_key=None, digest=None):
        self.name = name
        self.site = site
        self.graph_key = graph_key
        self.digest = digest
        self._seen = set()

    def charge(self, sig, seconds, wall0=None):
        """Charge one call of ``seconds`` at signature ``sig``."""
        if sig in self._seen:
            note_run(self.name, seconds)
            return
        self._seen.add(sig)
        note_compile(self.name, seconds, sig, graph_key=self.graph_key,
                     site=self.site, digest=self.digest, wall0=wall0)


# ---------------------------------------------------------------------------
# registry views
# ---------------------------------------------------------------------------


def program_table():
    """Every program's registry row, most compile-expensive first."""
    with _lock:
        recs = list(_programs.values())
    rows = [r.as_dict() for r in recs]
    rows.sort(key=lambda r: -r["compile_seconds"])
    return rows


def recompile_log():
    """Chronological recompile attributions (the last 256)."""
    with _lock:
        return list(_recompiles)


def summary(include_recompiles=True):
    """Program count, total compile count and seconds, total run seconds
    and recompile count, and (by default) the recompile attributions."""
    rows = program_table()
    out = {
        "programs": len(rows),
        "compile_count": sum(r["compile_count"] for r in rows),
        "compile_seconds": round(
            sum(r["compile_seconds"] for r in rows), 6),
        "run_seconds": round(sum(r["run_seconds"] for r in rows), 6),
        "recompile_count": sum(r["recompile_count"] for r in rows),
    }
    from . import compile_cache as _cc

    if _cc.enabled():
        out["cache_hits"] = telemetry.totals("compile.cache_hits")[1]
        out["cache_misses"] = telemetry.totals("compile.cache_misses")[1]
        out["cache_errors"] = telemetry.totals("compile.cache_errors")[1]
    if include_recompiles:
        out["recompiles"] = recompile_log()
    return out


def last_recompile():
    """The most recent recompile attribution, or None."""
    with _lock:
        return dict(_recompiles[-1]) if _recompiles else None


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------


def _cuda_stats():
    """``{"cuda:i": torch.cuda.memory_stats(i)}`` for every card, or {}
    when CUDA was never initialized in this process (a host-only process
    reading its telemetry must not start CUDA)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    return {"cuda:%d" % i: torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def _backend_peak_bytes():
    peaks = [s.get("allocated_bytes.all.peak") for s in _cuda_stats().values()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def device_memory_stats():
    """Per card: ``{"cuda:i": {"bytes_in_use", "peak_bytes", "source"}}``
    from the caching allocator (``allocated_bytes.all.current`` and
    ``.peak``); {} without a card in use."""
    return {dev: {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
                  "peak_bytes": s.get("allocated_bytes.all.peak", 0),
                  "source": "torch"}
            for dev, s in _cuda_stats().items()}


def live_tensor_report(top=None):
    """The live tensors' view of memory: ``{"by_device": {device: {"bytes",
    "tensors"}}, "top": [...]}`` with the ``top`` largest storages (shape,
    dtype, device, bytes). Walks the collector's objects, so it is for the
    OOM report, not a hot path."""
    import torch

    if top is None:
        top = env_int("MXNET_OOM_DUMP_TOP", 10)
    by_dev = {}
    seen = set()
    entries = []
    for obj in gc.get_objects():
        try:
            if not isinstance(obj, torch.Tensor) or obj.is_meta:
                continue
            storage = obj.untyped_storage()
            key = (str(obj.device), storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            nbytes = int(storage.nbytes())
            shape, dtype, dev = tuple(obj.shape), str(obj.dtype), str(obj.device)
        except (RuntimeError, ReferenceError):
            # a tensor without storage (sparse, functional wrapper): it
            # holds no buffer of its own
            continue
        slot = by_dev.setdefault(dev, {"bytes": 0, "tensors": 0})
        slot["bytes"] += nbytes
        slot["tensors"] += 1
        entries.append((nbytes, shape, dtype, dev))
    entries.sort(key=lambda e: -e[0])
    return {
        "by_device": by_dev,
        "top": [{"bytes": n, "shape": list(s), "dtype": d, "device": c}
                for n, s, d, c in entries[:max(int(top), 0)]],
    }


def update_memory_gauges():
    """Refresh the ``device.bytes_in_use`` / ``device.peak_bytes`` gauges
    and the per-program ``compile.run_seconds`` gauges. Registered as a
    telemetry collector, so every ``dump()``, scrape and stall dump reads
    fresh values."""
    for dev, s in device_memory_stats().items():
        telemetry.gauge("device.bytes_in_use", device=dev).set(
            s["bytes_in_use"])
        telemetry.gauge("device.peak_bytes", device=dev).set(s["peak_bytes"])
    for row in program_table():
        telemetry.gauge("compile.run_seconds",
                        program=row["program"]).set(row["run_seconds"])


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory")


def is_oom_error(exc):
    """Whether ``exc`` is a device out-of-memory failure: torch's
    ``OutOfMemoryError``, or a failure carrying an out-of-memory marker
    (the ``oom`` fault point's)."""
    import torch

    oom_type = getattr(torch, "OutOfMemoryError", None) or \
        torch.cuda.OutOfMemoryError
    if isinstance(exc, oom_type):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def dump_oom_report(program, exc, logger=None):
    """The OOM post-mortem, logged before the error propagates: the cards'
    memory stats, the top live tensors and the program table. Counted
    (``device.oom_events{program}``) and mirrored as an ``oom`` event;
    returns the report dict (None when this exception was reported
    already)."""
    logger = logger or _log
    if getattr(exc, "_mxt_oom_dumped", False):
        return None
    try:
        exc._mxt_oom_dumped = True
    except AttributeError:
        pass  # a slotted exception: at worst a second report
    telemetry.counter("device.oom_events", program=program).inc()
    mem = device_memory_stats()
    live = live_tensor_report()
    table = [{k: r[k] for k in ("program", "compile_count",
                                "compile_seconds", "run_seconds",
                                "arg_bytes")} for r in program_table()]
    logger.error(
        "OOM at program %r: %s\n"
        "device memory: %s\n"
        "top live allocations: %s\n"
        "program table (by compile seconds): %s",
        program, exc, mem, live["top"], table)
    telemetry.event("oom", program=program, error=str(exc)[:500],
                    device_memory=mem, top_allocations=live["top"],
                    programs=[{k: r[k] for k in ("program", "compile_count",
                                                  "arg_bytes")}
                              for r in table])
    return {"program": program, "device_memory": mem,
            "top_allocations": live["top"], "programs": table}


class oom_guard:
    """Run the block; if it dies of a device out-of-memory, log the OOM
    report naming ``program`` before re-raising. Hosts the ``oom`` fault
    point (``MXNET_FAULT_SPEC="oom:"``), whose synthetic failure takes the
    same path; ``inject=False`` leaves the point alone (a block that is
    one half of a program whose other half hosts it)."""

    __slots__ = ("_program", "_inject")

    def __init__(self, program, inject=True):
        self._program = program
        self._inject = inject

    def __enter__(self):
        from . import fault

        if self._inject and fault.hit("oom") is not None:
            exc = MXNetError(
                "RESOURCE_EXHAUSTED: injected device out-of-memory "
                "(fault.py point 'oom') at program %r" % self._program)
            dump_oom_report(self._program, exc)
            raise exc
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and is_oom_error(exc):
            dump_oom_report(self._program, exc)
        return False


telemetry.register_collector(update_memory_gauges)
