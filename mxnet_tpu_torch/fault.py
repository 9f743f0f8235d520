"""Deterministic in-process fault injection.

The port's counterpart of ``mxnet_tpu/fault.py``: named *injection points*
threaded through the runtime's failure-prone seams, so every recovery path
is testable in one process, reproducibly:

* ``checkpoint_write`` — inside the atomic checkpoint writer
  (``utils/atomic_file.py``): ``crash_after_bytes=N`` kills the write
  mid-stream, leaving a torn temp file exactly N bytes long.
* ``checkpoint_between_files`` — after the symbol json, before the params
  file (the classic half-written two-file checkpoint).
* ``nan`` — the health guard's sentinel (``guard.py``): poisons the next
  step's gradients with NaN (``target=loss`` flags the loss instead), so
  skip/rollback/abort are testable without real divergence.
* ``stall`` — the device feed's transfer stage (``io.DeviceFeedIter``):
  ``delay_ms=N`` sleeps it past the guard's watchdog deadline.
* ``oom`` — the executor and fused-step boundary (``compileobs.oom_guard``):
  a firing rule raises a synthetic out-of-memory failure there, exercising
  the OOM report without a real device out-of-memory. ``oom:`` alone
  fires every time; ``oom:after=K,times=1`` dies once at step K.
* ``dispatch_error`` — the serving engine's prefill/decode dispatch seam
  (serving/engine.py): ``raise=1`` escapes the step, aborting the engine.
* ``kv_oom`` — the KV block allocator (serving/kv_cache.py): a firing rule
  synthesizes a classified ``KVCacheOOM`` without draining the pool.
* ``slow_step`` — the serving engine step's entry (``delay_ms=N`` stalls
  the whole step).

Not here yet: the JAX package's ``kv_push``/``kv_pull``/``server_updater``
retry points and the ``kill_worker``/``kill_server`` hooks (``ROADMAP.md``
A6c), and ``bad_record``.

Faults are described by a spec string, in ``MXNET_FAULT_SPEC`` (inherited
by every process a run starts) or pushed with :func:`inject`::

    MXNET_FAULT_SPEC="checkpoint_write:crash_after_bytes=128;nan:after=3,times=1"

Grammar: ``point:arg=val[,arg=val...]`` joined by ``;``. Args: ``times=N``
(fire at most N times), ``after=N`` (let the first N hits through),
``raise=1`` (raise :class:`InjectedFault`), ``crash=1`` (raise
:class:`InjectedCrash`, a ``BaseException``), ``delay_ms=N`` (sleep);
``crash_after_bytes=N`` and ``target=`` are read by their call sites.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from . import telemetry
from .base import MXNetError, env_str

__all__ = ["InjectedFault", "InjectedCrash", "hit", "inject", "reset",
           "crash_after_bytes", "consume"]


class InjectedFault(MXNetError):
    """A recoverable failure raised by an injection point."""


class InjectedCrash(BaseException):
    """A simulated hard crash: not an ``Exception``, so recovery code that
    catches ``Exception`` cannot swallow it."""


_lock = threading.RLock()
_rules = None  # lazily parsed from MXNET_FAULT_SPEC
_spec_stack = []  # programmatic overrides from inject()


def _parse(spec):
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, argstr = part.partition(":")
        args = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            args[k.strip()] = v.strip()
        rules.append({"point": point.strip(), "args": args,
                      "hits": 0, "fired": 0})
    return rules


def _active_rules():
    global _rules
    with _lock:
        if _spec_stack:
            return _spec_stack[-1]
        if _rules is None:
            _rules = _parse(env_str("MXNET_FAULT_SPEC", ""))
        return _rules


def reset():
    """Forget the parsed ``MXNET_FAULT_SPEC`` rules and their counters (the
    environment is read again at the next hit). Rules pushed with
    :func:`inject` are unaffected."""
    global _rules
    with _lock:
        _rules = None


@contextmanager
def inject(spec):
    """Activate ``spec`` for the dynamic extent of the block. Nested
    injects stack; the innermost wins wholesale."""
    rules = _parse(spec)
    with _lock:
        _spec_stack.append(rules)
    try:
        yield rules
    finally:
        with _lock:
            _spec_stack.remove(rules)


def _arm(name, require=None):
    """after/times gating (caller holds ``_lock``): count the hit on
    ``name``'s rule (one carrying arg ``require``, when given) and return
    the rule if it should fire, not yet marked fired."""
    for r in _active_rules():
        if r["point"] != name:
            continue
        if require is not None and require not in r["args"]:
            continue
        args = r["args"]
        r["hits"] += 1
        if r["hits"] <= int(args.get("after", 0)):
            return None
        times = args.get("times")
        if times is not None and r["fired"] >= int(times):
            return None
        return r
    return None


def hit(name):
    """Consult the active spec at injection point ``name``.

    Returns ``None`` when no rule fires. Otherwise applies ``delay_ms`` /
    ``raise`` / ``crash`` itself and returns the rule's arg dict."""
    with _lock:
        rule = _arm(name)
        if rule is None:
            return None
        rule["fired"] += 1
        args = rule["args"]
    telemetry.counter("fault.injections", point=name).inc()
    delay = args.get("delay_ms")
    if delay:
        time.sleep(int(delay) / 1000.0)
    if args.get("crash") not in (None, "0"):
        raise InjectedCrash("injected crash at %s" % name)
    if args.get("raise") not in (None, "0"):
        raise InjectedFault("injected fault at %s" % name)
    return args


def crash_after_bytes(name):
    """Byte budget for a write-stream injection point, or ``None``. Each
    call counts as one hit (one stream opened at the point); the stream
    wrapper that exhausts the budget records the firing with
    :func:`consume`."""
    with _lock:
        rule = _arm(name, require="crash_after_bytes")
        if rule is None:
            return None
        return int(rule["args"]["crash_after_bytes"])


def consume(name):
    """Record a firing of ``name``'s ``crash_after_bytes`` rule (the one
    :func:`crash_after_bytes` armed) without applying any action."""
    with _lock:
        for r in _active_rules():
            if r["point"] == name and "crash_after_bytes" in r["args"]:
                r["fired"] += 1
                break
        else:
            return
    telemetry.counter("fault.injections", point=name).inc()
