"""Runtime lock-order witness — the dynamic half of the concurrency pass
(the port's copy of ``mxnet_tpu/analysis/witness.py``).

The static analyzer (:mod:`lockgraph`, :mod:`concurrency`) reasons about
every acquisition it can SEE; this module checks the ones that actually
HAPPEN. Declared locks are wrapped so each acquisition records, per
thread, the lock it was taken under — an observed nesting edge. Two
classified violations:

* ``order_inversion`` — this thread acquired B under A while some thread
  (statically or earlier at runtime) acquired A under B: the classic
  deadlock recipe, caught even when the two schedules never actually
  collide in this run.
* ``unknown_edge`` — an observed edge absent from the static lock graph:
  either the analyzer has a blind spot (fix lockgraph) or runtime took a
  path no reviewer saw (fix the code). Checked only once a static edge
  set is seeded (:func:`seed_static`) — without one, the witness still
  catches inversions against its own observations.

Modes (``MXNET_LOCK_WITNESS``, read via ``base.env_str``; off when
unset):

* off      — :func:`declare` returns the raw lock object unchanged: the
  fast path carries zero instrumentation.
* ``warn``   — violations bump always-on counters and log once per edge.
* ``strict`` — violations raise :class:`LockWitnessError` at the
  offending ``acquire``.

Telemetry (always-on):

* ``lock.held_seconds{lock}`` — hold-time histogram per declared lock.
* ``lock.contention{lock}``   — acquisitions that found the lock taken.
* ``lock.order_violations``   — classified violations (both kinds).

Integration idiom — wrap AFTER construction, in a separate statement, so
lockgraph still sees the ``threading.Lock()`` call and keys the lock to
its declaration site::

    self._lock = threading.RLock()
    self._lock = witness.declare(
        "mxnet_tpu_torch.serving.engine.ServingEngine._lock", self._lock)

``declare`` names must be the lock ids the static graph uses
(``module.Class.attr``) so seeded edges line up. A wrapped lock still
works under ``threading.Condition`` — the proxy forwards the private
``_release_save``/``_acquire_restore``/``_is_owned`` hooks.
"""
from __future__ import annotations

import logging
import threading
import time

# imported with this module, never inside a call: a call can run on a
# parameter server's connection thread while the server serves inside
# ``import mxnet_tpu_torch``, and an import of the package from that
# thread would wait on its import lock for ever
from .. import telemetry
from ..base import MXNetError, env_str

__all__ = ["LockWitnessError", "declare", "mode", "configure", "active",
           "seed_static", "observed_edges", "reset_observations",
           "COUNTER_ORDER", "HELD_HISTOGRAM", "CONTENTION_COUNTER"]

COUNTER_ORDER = "lock.order_violations"
HELD_HISTOGRAM = "lock.held_seconds"
CONTENTION_COUNTER = "lock.contention"

_UNSET = object()
_mode = _UNSET  # None=off, "warn", "strict"; _UNSET = env not read yet
_lock = threading.Lock()  # guards the module's own registries below
_tls = threading.local()  # .stack — [witness names] held by THIS thread
_observed = {}  # (outer, inner) -> first-seen description
_static_edges = None  # set[(outer, inner)] from lockgraph, or None = unseeded
_logged_edges = set()  # warn-mode dedup, bounded
_MAX_LOGGED_EDGES = 4096

_log = logging.getLogger(__name__)


class LockWitnessError(MXNetError):
    """Classified strict-mode lock-order violation.

    ``kind`` is ``order_inversion`` or ``unknown_edge``; an ``except
    MXNetError`` catches it like every other classified failure."""

    def __init__(self, kind, message):
        super().__init__(message)
        self.kind = kind


def mode():
    """Current mode: ``None`` (off), ``"warn"`` or ``"strict"``. First call
    resolves ``MXNET_LOCK_WITNESS`` (later changes go via
    :func:`configure`)."""
    global _mode
    if _mode is _UNSET:
        configure(env_str("MXNET_LOCK_WITNESS", None,
                          choices=("warn", "strict")))
    return _mode


def active():
    return mode() is not None


def configure(new_mode):
    """Set the witness mode programmatically (``None``/"warn"/"strict").

    Locks already handed out by :func:`declare` keep their nature (raw
    locks stay raw, proxies stay proxies but go quiet when off) — flip the
    mode BEFORE constructing the objects whose locks should be witnessed.
    """
    global _mode
    if new_mode not in (None, "warn", "strict"):
        raise ValueError("witness mode must be None/'warn'/'strict', got %r"
                         % (new_mode,))
    with _lock:
        _mode = new_mode
        _logged_edges.clear()


def seed_static(edges):
    """Seed the static lock graph's edge set (``{(outer, inner), ...}`` of
    witness names) — from then on an observed edge outside it is an
    ``unknown_edge`` violation. Pass ``None`` to unseed (inversion checks
    continue)."""
    global _static_edges
    with _lock:
        _static_edges = None if edges is None else {tuple(e) for e in edges}


def observed_edges():
    """Snapshot of every (outer, inner) nesting observed so far."""
    with _lock:
        return set(_observed)


def reset_observations():
    """Drop recorded edges and log dedup (test isolation). Telemetry
    counters are owned by :mod:`..telemetry` and reset there."""
    with _lock:
        _observed.clear()
        _logged_edges.clear()


def declare(name, lock):
    """Register ``lock`` under ``name`` (the static graph's lock id).

    Returns ``lock`` itself when the witness is off — the caller's
    attribute is the pristine stdlib object, zero overhead. When on,
    returns a recording proxy."""
    if not active():
        return lock
    return _WitnessedLock(name, lock)


# ---------------------------------------------------------------------------
# violation reporting
# ---------------------------------------------------------------------------

def _count(counter, **labels):
    # always-on: violations and lock health must be visible even with
    # telemetry disabled (same contract as the engine sanitizer)
    telemetry.counter(counter, **labels).inc()


def _warn_once(edge, message):
    if edge in _logged_edges:
        return
    if len(_logged_edges) < _MAX_LOGGED_EDGES:
        _logged_edges.add(edge)
    _log.warning("lock witness: %s", message)


def _violate(kind, edge, message):
    _count(COUNTER_ORDER)
    if mode() == "strict":
        raise LockWitnessError(kind, message)
    _warn_once((kind,) + edge, message)


def _record_edge(outer, inner):
    """Called with ``outer`` held while acquiring ``inner`` (names)."""
    edge = (outer, inner)
    with _lock:
        first = edge not in _observed
        if first:
            _observed[edge] = True
        inverted = (inner, outer) in _observed
        static = _static_edges
    if not first:
        return
    if inverted:
        _violate("order_inversion", edge,
                 "%s acquired under %s, but the reverse nesting was also "
                 "observed — deadlock-possible order inversion"
                 % (inner, outer))
    if static is not None and edge not in static \
            and (inner, outer) not in static:
        # the reverse static edge is NOT a free pass for this direction —
        # but it already reported as an inversion above; only a genuinely
        # unknown pair lands here
        _violate("unknown_edge", edge,
                 "observed %s acquired under %s — an edge the static lock "
                 "graph does not contain (blind spot or untracked path)"
                 % (inner, outer))


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------

class _WitnessedLock:
    """Wraps a Lock/RLock: records nesting edges, contention, hold time.

    The wrapped lock serializes as before — the proxy adds bookkeeping on
    the acquiring thread only. Reentrant re-acquires (RLock) don't record
    self-edges. ``Condition(proxy)`` works: the private hooks forward.
    """

    __slots__ = ("_name", "_inner", "_t0")

    def __init__(self, name, inner):
        self._name = name
        self._inner = inner
        self._t0 = None  # monotonic acquire time of the OUTERMOST hold

    # -- acquisition ------------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(False)
        if not got:
            _count(CONTENTION_COUNTER, lock=self._name)
            if not blocking:
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        try:
            self._note_acquired()
        except BaseException:
            # a strict-mode violation raises out of acquire(): hand the
            # lock back so the failed acquisition holds nothing
            self._inner.release()
            raise
        return True

    def release(self):
        stack = self._stack()
        if stack and stack[-1] is self:
            stack.pop()
            if self._name not in [w._name for w in stack]:
                t0, self._t0 = self._t0, None
                if t0 is not None:
                    self._observe_held(t0)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- bookkeeping ------------------------------------------------------

    @staticmethod
    def _stack():
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        return stack

    def _note_acquired(self):
        stack = self._stack()
        held = [w._name for w in stack]
        if self._name not in held:
            # one edge per DISTINCT held lock — the same all-pairs shape
            # the static graph records, so seeded comparisons line up
            for outer in dict.fromkeys(held):
                _record_edge(outer, self._name)
            self._t0 = time.monotonic()
        stack.append(self)

    def _observe_held(self, t0):
        telemetry.histogram(HELD_HISTOGRAM, lock=self._name).observe(
            time.monotonic() - t0)

    # -- Condition compatibility -----------------------------------------
    # Condition(lock) calls these private hooks on non-RLock locks; an
    # RLock's own implementations release the full recursion depth. The
    # proxy keeps its stack honest through both paths.

    def _release_save(self):
        stack = self._stack()
        depth = 0
        while stack and stack[-1] is self:
            stack.pop()
            depth += 1
        if depth and self._t0 is not None:
            t0, self._t0 = self._t0, None
            self._observe_held(t0)
        if hasattr(self._inner, "_release_save"):
            return depth, self._inner._release_save()
        self._inner.release()
        return depth, None

    def _acquire_restore(self, state):
        depth, inner_state = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        stack = self._stack()
        if self._name not in [w._name for w in stack]:
            self._t0 = time.monotonic()
        stack.extend([self] * depth)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock: Condition's fallback probe — owned iff held here
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return "<witnessed %s %r>" % (self._name, self._inner)
