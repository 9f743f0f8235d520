"""Deterministic in-process fault injection for the serving stack.

The port's counterpart of ``mxnet_tpu/fault.py``, cut to the injection
points of the ported serving path:

* ``dispatch_error`` — the serving engine's prefill/decode dispatch seam
  (serving/engine.py): ``raise=1`` escapes the step, aborting the engine.
* ``kv_oom`` — the KV block allocator (serving/kv_cache.py): a firing rule
  synthesizes a classified ``KVCacheOOM`` without draining the pool.
* ``slow_step`` — the serving engine step's entry (``delay_ms=N`` stalls
  the whole step).

Faults are described by a spec string, in ``MXNET_FAULT_SPEC`` or pushed
with :func:`inject`::

    MXNET_FAULT_SPEC="dispatch_error:raise=1,after=3,times=1"

Grammar: ``point:arg=val[,arg=val...]`` joined by ``;``. Args: ``times=N``
(fire at most N times), ``after=N`` (let the first N hits through),
``raise=1`` (raise :class:`InjectedFault`), ``crash=1`` (raise
:class:`InjectedCrash`, a ``BaseException``), ``delay_ms=N`` (sleep).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from . import telemetry
from .base import MXNetError, env_str

__all__ = ["InjectedFault", "InjectedCrash", "hit", "inject"]


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


def _arm(name):
    """after/times gating (caller holds ``_lock``): count the hit on
    ``name``'s rule and return the rule if it should fire."""
    for r in _active_rules():
        if r["point"] != name:
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
