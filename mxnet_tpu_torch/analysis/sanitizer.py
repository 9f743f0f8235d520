"""Engine dependency sanitizer — runtime check of push contracts (the
port's copy of ``mxnet_tpu/analysis/sanitizer.py``).

The engine schedules host-side work purely from *declared* dependencies:
``push(fn, const_vars=..., mutable_vars=...)`` (engine.py). Nothing ever
verified the declarations — an fn that mutates a buffer it declared const
(or never declared at all) races every reader the scheduler believes is
safe to run concurrently, and an fn touching a deleted var reads freed
state. This is the TSan-style counterpart to those contracts, in the
spirit of the reference's ``MXNET_ENGINE_TYPE=NaiveEngine`` bisection
tool: opt-in, zero-cost when off.

Modes (``MXNET_ENGINE_SANITIZER``, read via ``base.env_str``; off when
unset):

* ``warn``   — violations bump always-on ``engine.sanitizer.*`` telemetry
  counters and log (rate-limited per site).
* ``strict`` — violations raise :class:`EngineSanitizerError`; in-fn
  violations surface through the engine's error slot at the next
  ``wait_for_var``/``wait_all``, declaration-time ones (pushing with a
  deleted var) raise at the push.

Tracking: NDArrays are associated with engine vars via :func:`attach`. A
view (``a[0]``, a reshape) is an NDArray over a tensor that shares its
base's storage: it reports through the var attached to the array whose
storage it shares. While an instrumented fn runs, ``NDArray.data`` reads
and the writes (``_set_data``, ``a[...] = v`` and ``a += b``, which write
the held tensor in place) on the thread that runs it — the pushing thread
under ``NaiveEngine``, a native worker that the ``ctypes`` trampoline
calls under ``ThreadedEngine`` — are recorded against the declaration.
The NDArray accessors are only patched while a sanitizer mode is active —
the disabled default path is the original class attributes (no flag
check added).

Violation classes:

* ``undeclared_mutation`` — wrote a var declared neither const nor mutable
* ``const_write``         — wrote a var declared const
* ``use_after_free``      — touched (or declared) a deleted var
* ``undeclared_read``     — read a var that was not declared (counter/log
  only, even in strict mode: reads are racy but not corrupting, and the
  reference engine tolerated them longest)
"""
from __future__ import annotations

import logging
import threading

# imported with this module, never inside a call: a call can run on a
# parameter server's connection thread while the server serves inside
# ``import mxnet_tpu_torch``, and an import of the package from that
# thread would wait on its import lock for ever
from .. import telemetry
from ..base import MXNetError, env_str

__all__ = ["EngineSanitizerError", "attach", "var_of", "mode", "configure",
           "active", "wrap_push", "check_declared", "COUNTER_PREFIX"]

COUNTER_PREFIX = "engine.sanitizer."

_UNSET = object()
_mode = _UNSET  # None=off, "warn", "strict"; _UNSET = env not read yet
_lock = threading.Lock()
_tls = threading.local()  # .rec — the _OpRecord of the fn running HERE;
# .writing — inside a recorded write (its own _set_data is not a second)
_orig_accessors = None  # (data, _set_data, __setitem__, _inplace) patched
_logged_sites = set()  # rate-limit: one log line per (kind, var) in warn mode

_log = logging.getLogger(__name__)


class EngineSanitizerError(MXNetError):
    """Classified strict-mode violation of an engine push declaration.

    ``kind`` is the violation class (``undeclared_mutation`` /
    ``const_write`` / ``use_after_free``); an ``except MXNetError`` in a
    training loop catches it like every other classified engine error.
    """

    def __init__(self, kind, message):
        super().__init__(message)
        self.kind = kind


def mode():
    """Current mode: ``None`` (off), ``"warn"`` or ``"strict"``. First call
    resolves ``MXNET_ENGINE_SANITIZER`` (later changes go via
    :func:`configure`)."""
    global _mode
    if _mode is _UNSET:
        configure(env_str("MXNET_ENGINE_SANITIZER", None,
                          choices=("warn", "strict")))
    return _mode


def active():
    return mode() is not None


def configure(new_mode):
    """Set the sanitizer mode programmatically (``None``/"warn"/"strict").

    Patches the NDArray accessors on enable and restores the pristine
    originals on disable, so the default path carries zero instrumentation.
    """
    global _mode
    if new_mode not in (None, "warn", "strict"):
        raise ValueError("sanitizer mode must be None/'warn'/'strict', got %r"
                         % (new_mode,))
    with _lock:
        _mode = new_mode
        _logged_sites.clear()
        if new_mode is None:
            _unpatch_ndarray()
        else:
            _patch_ndarray()


def _storage_key(arr):
    """The identity of the storage under ``arr``'s tensor (device and base
    address): a view shares it with the array it was taken from."""
    t = getattr(arr, "_data", None)
    if t is None:
        return None
    try:
        return (str(t.device), t.untyped_storage().data_ptr())
    except (AttributeError, RuntimeError):
        return None


_by_storage = {}  # storage key -> weakref of the attached NDArray


def attach(arr, var):
    """Associate ``arr`` (an NDArray) with engine ``var`` for tracking."""
    import weakref

    arr._engine_var = var
    key = _storage_key(arr)
    if key is not None:
        with _lock:
            _by_storage[key] = weakref.ref(arr)
    return arr


def var_of(arr):
    """The engine var tracking ``arr`` — a view without its own var reports
    through the var of the attached array whose storage it shares."""
    var = getattr(arr, "_engine_var", None)
    if var is not None:
        return var
    key = _storage_key(arr)
    if key is None:
        return None
    ref = _by_storage.get(key)
    base = ref() if ref is not None else None
    if base is None or base is arr:
        return None
    if _storage_key(base) != key:
        return None  # the attached array was rebound to another tensor
    return getattr(base, "_engine_var", None)


# ---------------------------------------------------------------------------
# violation reporting
# ---------------------------------------------------------------------------

def _count(kind):
    # always-on counter: violations are rare by
    # definition and must be visible even with telemetry disabled
    telemetry.counter(COUNTER_PREFIX + kind).inc()


_MAX_LOGGED_SITES = 4096


def _warn_once(kind, var, message):
    """One log line per (kind, var) — keyed on id(var), not the message (a
    Var's default repr embeds its address, which would defeat dedup), and
    bounded so a pathological run can't grow the set forever (past the cap
    new sites stop logging; counters still tell the whole story)."""
    site = (kind, id(var))
    if site in _logged_sites:
        return
    if len(_logged_sites) < _MAX_LOGGED_SITES:
        _logged_sites.add(site)
    _log.warning("engine sanitizer: %s — %s", kind, message)


def _report(kind, var, message, strict_raises=True):
    _count(kind)
    if mode() == "strict" and strict_raises:
        raise EngineSanitizerError(kind, message)
    _warn_once(kind, var, message)


# ---------------------------------------------------------------------------
# push instrumentation
# ---------------------------------------------------------------------------

class _OpRecord:
    __slots__ = ("const_ids", "mutable_ids", "deferred")

    def __init__(self, const_vars, mutable_vars):
        self.const_ids = {id(v) for v in const_vars}
        self.mutable_ids = {id(v) for v in mutable_vars}
        self.deferred = []  # (kind, message) raised after the fn finishes


def check_declared(const_vars, mutable_vars):
    """Declaration-time check at push: flags deleted vars immediately (a
    deleted var can never legally appear in a dependency list)."""
    if not active():
        return
    for v in tuple(const_vars) + tuple(mutable_vars):
        if getattr(v, "deleted", False):
            _report("use_after_free", v,
                    "push declares deleted var %r" % (v,))


def wrap_push(fn, const_vars=(), mutable_vars=()):
    """Wrap a pushed fn so its actual NDArray accesses are checked against
    the declaration. Returns ``fn`` unchanged when the sanitizer is off."""
    if not active():
        return fn
    rec = _OpRecord(const_vars, mutable_vars)

    def checked():
        prev = getattr(_tls, "rec", None)
        _tls.rec = rec
        try:
            fn()
        finally:
            _tls.rec = prev
        # strict-mode raise happens HERE (after fn ran, on the worker
        # thread) so the engine's error slot carries it to the next wait —
        # identical surfacing to any other pushed-fn failure
        if rec.deferred and mode() == "strict":
            kind, message = rec.deferred[0]
            raise EngineSanitizerError(kind, message)

    return checked


def _record_access(arr, write):
    rec = getattr(_tls, "rec", None)
    if rec is None:
        return
    var = var_of(arr)
    if var is None:
        return
    vid = id(var)
    if getattr(var, "deleted", False):
        _defer(rec, "use_after_free", var,
               "%s of deleted var %r" % ("write" if write else "read", var))
    elif write and vid in rec.mutable_ids:
        pass  # declared correctly
    elif write and vid in rec.const_ids:
        _defer(rec, "const_write", var,
               "write to declared-const var %r" % (var,))
    elif write:
        _defer(rec, "undeclared_mutation", var,
               "write to undeclared var %r" % (var,))
    elif vid not in rec.const_ids and vid not in rec.mutable_ids:
        # reads never strict-raise: racy but not corrupting
        _count("undeclared_read")
        _warn_once("undeclared_read", var,
                   "undeclared_read of var %r" % (var,))


def _defer(rec, kind, var, message):
    """Count + log now; in strict mode remember the first violation so the
    wrapper raises it after the fn body finishes (raising mid-fn from a
    data accessor would tear the user's fn at an arbitrary point)."""
    _count(kind)
    _warn_once(kind, var, message)
    rec.deferred.append((kind, message))


# ---------------------------------------------------------------------------
# NDArray accessor patching (enable-time only; default path untouched)
# ---------------------------------------------------------------------------

def _patch_ndarray():
    global _orig_accessors
    if _orig_accessors is not None:
        return
    from ..ndarray import NDArray

    orig_data = NDArray.data
    orig_set = NDArray._set_data
    orig_setitem = NDArray.__setitem__
    orig_inplace = NDArray._inplace

    def data(self):
        _record_access(self, write=False)
        return orig_data.fget(self)

    def _set_data(self, value):
        # one write per user-level write: `a += b` rebinding through
        # _set_data was recorded by _inplace already
        if not getattr(_tls, "writing", False):
            _record_access(self, write=True)
        return orig_set(self, value)

    def _writes(orig):
        def write(self, *args):
            _record_access(self, write=True)
            _tls.writing = True
            try:
                return orig(self, *args)
            finally:
                _tls.writing = False
        write.__name__ = orig.__name__
        return write

    NDArray.data = property(data, doc=orig_data.__doc__)
    NDArray._set_data = _set_data
    NDArray.__setitem__ = _writes(orig_setitem)
    NDArray._inplace = _writes(orig_inplace)
    _orig_accessors = (orig_data, orig_set, orig_setitem, orig_inplace)


def _unpatch_ndarray():
    global _orig_accessors
    if _orig_accessors is None:
        return
    from ..ndarray import NDArray

    (NDArray.data, NDArray._set_data, NDArray.__setitem__,
     NDArray._inplace) = _orig_accessors
    _orig_accessors = None
