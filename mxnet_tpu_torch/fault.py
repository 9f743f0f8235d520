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
* ``kv_push`` / ``kv_pull`` — the dist KVStore's RPC attempts
  (``drop=1`` fails one, ``delay_ms=N`` stalls it), for retry and backoff.
* ``server_updater`` — a parameter server's optimizer update (``raise=1``),
  for the server's failure count and threshold.
* ``bad_record`` — ``ImageRecordIter``'s per-record decode.
* ``kill_worker`` — the fit loop's per-batch seam (``module/
  base_module.py``): SIGKILLs this process, no exit hooks, no flush: a
  machine loss. ``rank=N`` targets one worker of a launched cluster (every
  process inherits ``MXNET_FAULT_SPEC``); with ``after=K`` it dies at batch
  K. Drives the elastic kill, reconfigure and rejoin cycle
  (``tools/launch.py --elastic``).
* ``kill_server`` — a parameter server's update seam
  (``kvstore_server.py``): SIGKILLs a server the same way, after ``after=K``
  applied updates; ``server_id=N`` targets one. Drives the promotion of a
  backup.

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

import os
import signal
import threading
import time
from contextlib import contextmanager

from . import telemetry
from .base import MXNetError, env_str

__all__ = ["InjectedFault", "InjectedCrash", "hit", "inject", "reset",
           "crash_after_bytes", "consume", "kill_worker", "kill_server"]


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


def _arm(name, require=None, match=None):
    """after/times gating (caller holds ``_lock``): count the hit on
    ``name``'s rule (one carrying arg ``require``, when given; one whose
    args named in ``match`` equal its values, where the rule has them) and
    return the rule if it should fire, not yet marked fired. A rule aimed
    at another target is not counted: its budget stays the target's."""
    for r in _active_rules():
        if r["point"] != name:
            continue
        if require is not None and require not in r["args"]:
            continue
        if match is not None and any(k in r["args"] and r["args"][k] != str(v)
                                     for k, v in match.items()):
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


def _kill(name, match):
    with _lock:
        rule = _arm(name, match=match)
        if rule is None:
            return
        rule["fired"] += 1
    telemetry.counter("fault.injections", point=name).inc()
    os.kill(os.getpid(), signal.SIGKILL)


def kill_worker(rank=None):
    """The ``kill_worker`` point: SIGKILL this process when a rule fires
    whose ``rank=`` (if it has one) is ``rank``. The fit loop calls it once
    per batch."""
    _kill("kill_worker", None if rank is None else {"rank": int(rank)})


def kill_server(server_id=None):
    """The ``kill_server`` point: SIGKILL this server when a rule fires
    whose ``server_id=`` (if it has one) is ``server_id``. A server calls
    it once per applied update."""
    _kill("kill_server",
          None if server_id is None else {"server_id": int(server_id)})


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
