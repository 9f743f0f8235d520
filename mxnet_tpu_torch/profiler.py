"""Profiler (counterpart of ``mxnet_tpu/profiler.py``; reference:
python/mxnet/profiler.py:10-38 and src/engine/profiler.h — per-op records
dumped as chrome://tracing JSON).

Two tiers, started and stopped by the reference's
``profiler_set_state`` API:

* **Python tier** — imperative-op dispatch spans (mode ``all``), executor
  spans (``executor_forward[...]``, ``executor_fwd_bwd[...]``), the fit
  loop's ``fit.step`` and every ``telemetry.span``, and compile spans on a
  dedicated ``compile`` lane; :func:`dump_profile` writes them as the JAX
  package's chrome-trace JSON (``traceEvents`` sorted by thread and start,
  ``process_name``/``thread_name`` metadata rows).
* **Device tier** — with ``MXNET_PROFILER_TRACE_DIR`` set, ``run`` also
  starts a ``torch.profiler.profile`` (CPU activity, plus CUDA activity
  when a card is there) and ``stop`` exports its chrome trace into that
  directory as ``torch_trace.<pid>.<n>.json`` (:func:`last_device_trace`
  names it): the counterpart of ``jax.profiler.start_trace``. On the card
  it holds the kernels' launches and device times.

``MXNET_PROFILER_AUTOSTART=1`` runs the profiler from import in mode
``all`` and dumps at exit to ``MXNET_PROFILER_FILENAME`` (default
``profile.<pid>.json``).
"""
from __future__ import annotations

import json
import os
import threading
import time

# bound at import: the dump at exit must not import the package again (a
# server process exits from inside its import, and a second import would
# serve again)
from . import telemetry

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "emit_span", "record_span", "is_running", "last_device_trace"]

# the dedicated chrome-trace lane of compile spans (compileobs emits there)
COMPILE_TRACE_TID = 59999

_lock = threading.Lock()

# race-ok: mutation happens under _lock; the hot-path reads ("running",
# "mode") are single-slot samples, and emit_span re-checks under the lock
_state = {
    "mode": "symbolic",
    "filename": "profile.json",
    "running": False,
    "events": [],
    "device": None,         # the running torch.profiler.profile
    "device_dir": None,
    "device_trace": None,   # path of the last exported device trace
    "device_n": 0,
}


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """(reference: profiler.py profiler_set_config; modes 'symbolic'|'all')"""
    with _lock:
        _state["mode"] = mode
        _state["filename"] = filename


def _start_device(trace_dir):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_device(prof, trace_dir):
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    _state["device_n"] += 1
    path = os.path.join(trace_dir, "torch_trace.%d.%d.json"
                        % (os.getpid(), _state["device_n"]))
    prof.export_chrome_trace(path)
    return path


def profiler_set_state(state="stop"):
    """'run' | 'stop' (reference: profiler.py profiler_set_state).

    ``run`` clears the span buffer and, with ``MXNET_PROFILER_TRACE_DIR``
    set, starts the device tier; ``stop`` stops both and exports the device
    trace. Transitions run under the lock, so a span completing on another
    thread lands in exactly one buffer."""
    from .base import env_str

    with _lock:
        if state == "run" and not _state["running"]:
            _state["running"] = True
            _state["events"] = []
            trace_dir = env_str("MXNET_PROFILER_TRACE_DIR")
            if trace_dir:
                _state["device"] = _start_device(trace_dir)
                _state["device_dir"] = trace_dir
        elif state == "stop" and _state["running"]:
            _state["running"] = False
            prof, _state["device"] = _state["device"], None
            if prof is not None:
                _state["device_trace"] = _stop_device(prof,
                                                      _state["device_dir"])


def is_running():
    """Whether the Python tier is collecting spans."""
    return _state["running"]


def last_device_trace():
    """Path of the chrome trace the device tier exported at the last
    ``stop``, or None."""
    return _state["device_trace"]


def emit_span(name, category, wall_t0, dur_s, args=None, tid=None):
    """Append one complete span to the chrome-trace buffer if the profiler
    runs — the hook ``telemetry.span`` uses, so runtime spans land in the
    same timeline as the op and executor spans. ``args`` (a JSON-able
    dict) becomes the event's ``args``; ``tid`` pins the span to a
    synthetic lane instead of the emitting thread's."""
    if not _state["running"]:
        return
    if tid is None:
        tid = threading.get_ident() % (1 << 16)
        if tid == COMPILE_TRACE_TID:
            # keep real work off the dedicated compile lane
            tid += 1
    ev = {
        "name": name,
        "cat": category,
        "ph": "X",
        "ts": wall_t0 * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": int(tid),
    }
    if args:
        ev["args"] = dict(args)
    with _lock:
        if not _state["running"]:
            return
        _state["events"].append(ev)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "category", "t0")

    def __init__(self, name, category):
        self.name = name
        self.category = category

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        emit_span(self.name, self.category, self.t0, time.time() - self.t0)
        return False


def record_span(name, category="operator"):
    """Context manager recording one span while the profiler runs; a shared
    no-op when stopped. Mode ``symbolic`` records no ``operator`` spans
    (the reference's kOnlySymbolic); ``all`` adds one per imperative op
    (kAllOperator, profiler.h:63-66)."""
    if not _state["running"]:
        return _NULL_SPAN
    if _state["mode"] == "symbolic" and category == "operator":
        return _NULL_SPAN
    return _Span(name, category)


def dump_profile():
    """Write the buffered spans as chrome://tracing JSON
    (reference: MXDumpProfile → Profiler::DumpProfile, profiler.h:88),
    sorted by (tid, ts): spans are appended when they END, so an outer span
    lands after the inner ones it encloses. A distributed process adds a
    ``process_name`` row naming its rank; the compile lane, when used, a
    ``thread_name`` row."""
    with _lock:
        events = sorted(_state["events"],
                        key=lambda e: (e.get("tid", 0), e.get("ts", 0)))
        filename = _state["filename"]
    rank = telemetry.get_rank()
    if rank is not None:
        events.insert(0, {
            "name": "process_name", "cat": "__metadata", "ph": "M",
            "pid": os.getpid(), "tid": 0,
            "args": {"name": "rank %d" % rank, "rank": rank},
        })
    if any(e.get("tid") == COMPILE_TRACE_TID for e in events):
        events.insert(0, {
            "name": "thread_name", "cat": "__metadata", "ph": "M",
            "pid": os.getpid(), "tid": COMPILE_TRACE_TID,
            "args": {"name": "compile"},
        })
    with open(filename, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def _maybe_autostart():
    """``MXNET_PROFILER_AUTOSTART`` (reference: docs/how_to/env_var.md:73):
    run from import in mode ``all``, dump at exit."""
    import atexit

    from .base import env_flag, env_str

    if not env_flag("MXNET_PROFILER_AUTOSTART"):
        return
    # pid-suffixed by default: every process of a launched cluster inherits
    # the variable, and a shared name would keep only the last exiter's
    profiler_set_config(mode="all", filename=env_str(
        "MXNET_PROFILER_FILENAME", "profile.%d.json" % os.getpid()))
    profiler_set_state("run")

    def _dump_at_exit():
        profiler_set_state("stop")
        dump_profile()

    atexit.register(_dump_at_exit)


_maybe_autostart()
