"""Serving resilience: overload classification, backoff hints, and the
supervised engine-recovery loop.

The serving engine's failure contract is deliberately blunt — any error
escaping a step aborts the engine and "after an abort the engine is
unusable" (engine.py). That is the right primitive (pool pages written
in place by a failed dispatch cannot be trusted) but the wrong place to
stop:
production serving treats failure as routine, the way the training tier
already does (checkpoint retries, elastic resize, parameter-server HA).
This module layers the routine-failure story on top:

* :class:`ServingOverloadError` — the classified load-shedding signal.
  ``submit()`` raises it instead of enqueueing when the admission queue
  is at ``MXNET_SERVING_MAX_QUEUE``, the engine is draining, or the
  supervisor is mid-restart. It carries a ``retry_after_s`` hint so
  serve.py can answer ``503`` with a ``Retry-After`` header and clients
  back off instead of piling onto a saturated engine.
* :func:`retry_after_s` — the hint itself, estimated from the windowed
  occupancy/latency/goodput gauges the observability layer maintains:
  roughly "how long until the present backlog has worked off".
* :class:`EngineSupervisor` — wraps an engine *factory*. When the engine
  aborts, the supervisor salvages still-live requests (the engine parks
  them via ``salvage_on_abort`` instead of failing them), waits out an
  exponential backoff, builds a replacement engine and resubmits the
  survivors. Their replay prefill rebuilds
  the KV state from prompt + emitted tokens, exactly like recompute
  preemption, so greedy decoding finishes them bit-identical to an
  uninterrupted run. A restart cap turns repeated aborts into a
  permanent failure that fails pending requests with the abort cause.

The supervisor is duck-typed over the engine surface it drives
(``run_loop``/``submit``/``abort``/``pop_salvaged``/``resubmit``/...)
and deliberately does NOT import the engine module — engine.py imports
this module for the error class, and the factory closes over the real
constructor at the call site.

Lock order: supervisor lock is leaf-only held (never while calling into
the engine), so supervisor-lock -> engine-lock cycles cannot form.
"""
import threading
import time

from .. import telemetry
from ..analysis import witness
from ..base import MXNetError, env_float, env_int
from .scheduler import FAILED

__all__ = ["ServingOverloadError", "retry_after_s", "EngineSupervisor"]


class ServingOverloadError(MXNetError):
    """Load shed at submit: the request was REJECTED, not enqueued.

    ``reason`` classifies the shed — ``"queue_full"`` (admission queue at
    its bound), ``"draining"`` (shutdown in progress), ``"restarting"``
    (supervisor rebuilding the engine) — and ``retry_after_s`` is the
    backoff hint serve.py forwards as the ``Retry-After`` header."""

    def __init__(self, msg, reason="queue_full", retry_after_s=1.0):
        super().__init__(msg)
        self.reason = str(reason)
        self.retry_after_s = float(retry_after_s)


def retry_after_s(engine, default_s=1.0, max_s=60.0):
    """Client backoff hint: estimated seconds until the engine's current
    backlog has worked off, from the gauges the observability layer
    already maintains — backlog depth over batch slots gives the number
    of "waves" ahead of a retry, the windowed latency p50 prices a wave,
    and sub-1.0 goodput (the engine is missing its SLOs) stretches the
    hint so a struggling engine is not told "come right back". Clamped
    to [default_s, max_s]; any missing gauge degrades to ``default_s``
    (a cold engine has no latency history — and no backlog either)."""
    try:
        backlog = (len(engine.scheduler.waiting)
                   + len(engine.scheduler.running))
        slots = max(1, int(engine.config.max_batch))
        eid = str(engine.engine_id)
    except AttributeError:
        return default_s
    p50 = telemetry.histogram("serving.request_latency_seconds",
                              engine=eid).percentile(50)
    if not p50 or p50 <= 0.0:
        p50 = default_s
    waves = max(1, -(-backlog // slots))   # ceil without math import
    hint = waves * p50
    goodput = telemetry.gauge("serving.goodput", engine=eid).value
    if goodput and 0.0 < goodput < 1.0:
        hint /= max(goodput, 0.25)
    return round(min(max(hint, default_s), max_s), 3)


class EngineSupervisor:
    """Restart-supervised serving engine (one engine live at a time).

    ``factory`` is a zero-argument callable returning a fresh, ready
    engine; the supervisor owns the current instance (``.engine``) and
    re-invokes the factory after an abort. Warmth across restarts is the
    factory's job (the kernels' shared libraries are built once per
    process, so a replacement engine pays no build).

    Drive it exactly like an engine: ``run_loop`` on one stepping thread,
    ``submit``/``cancel`` from any thread. ``run_loop`` returns only on
    a clean stop; it re-raises the abort cause once the restart budget
    (``MXNET_SERVING_MAX_RESTARTS``) is exhausted, so a stepping thread's
    death stays observable (serve.py's ``/healthz``)."""

    def __init__(self, factory, max_restarts=None, backoff_s=None,
                 backoff_max_s=None):
        self.factory = factory
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else env_int("MXNET_SERVING_MAX_RESTARTS", 3))
        self.backoff_s = float(
            backoff_s if backoff_s is not None
            else env_float("MXNET_SERVING_RESTART_BACKOFF_MS", 100.0)
            / 1000.0)
        self.backoff_max_s = float(
            backoff_max_s if backoff_max_s is not None
            else env_float("MXNET_SERVING_RESTART_BACKOFF_MAX_MS", 5000.0)
            / 1000.0)
        self._lock = threading.Lock()
        self._lock = witness.declare(
            "mxnet_tpu_torch.serving.resilience.EngineSupervisor._lock", self._lock)
        self._restarts = 0
        self._restarting = False
        self._failed_msg = None     # permanent: restart budget exhausted
        self._last_error = None
        self._draining = False
        self._engine = factory()
        self._engine.salvage_on_abort = True

    # ---- state ---------------------------------------------------------
    @property
    def engine(self):
        """The live engine (replaced across restarts — do not cache)."""
        with self._lock:
            return self._engine

    @property
    def restarts(self):
        with self._lock:
            return self._restarts

    @property
    def last_error(self):
        with self._lock:
            return self._last_error

    @property
    def failed(self):
        """Permanent-failure cause, or None while restarts remain."""
        with self._lock:
            return self._failed_msg

    @property
    def restarting(self):
        with self._lock:
            return self._restarting

    @property
    def draining(self):
        with self._lock:
            return self._draining

    # ---- engine surface ------------------------------------------------
    def submit(self, *args, **kwargs):
        """Proxy to the live engine. During a restart window new work is
        shed (``reason="restarting"``, retry hint = the backoff in
        flight) — the queue the dead engine held is being replayed, not
        accepting. After permanent failure submits raise the abort cause
        like a bare aborted engine would."""
        with self._lock:
            eng = self._engine
            failed = self._failed_msg
            restarting = self._restarting
        if failed is not None:
            raise RuntimeError(failed)
        if restarting:
            raise ServingOverloadError(
                "engine restarting after abort", reason="restarting",
                retry_after_s=max(self.backoff_s, 0.05))
        try:
            return eng.submit(*args, **kwargs)
        except RuntimeError as exc:
            # the engine aborted between our snapshot and the enqueue;
            # unless the budget is gone the restart loop will replace it,
            # so advertise a transient overload, not permanent death
            with self._lock:
                failed = self._failed_msg
            if failed is not None:
                raise RuntimeError(failed) from exc
            raise ServingOverloadError(
                str(exc), reason="restarting",
                retry_after_s=max(self.backoff_s, 0.05)) from exc

    def cancel(self, req):
        self.engine.cancel(req)

    def cancel_all(self):
        return self.engine.cancel_all()

    def has_work(self):
        with self._lock:
            if self._restarting:
                return True     # salvaged requests await the replacement
            eng = self._engine
        return eng.has_work()

    def pop_finished(self):
        return self.engine.pop_finished()

    def start_drain(self):
        """Close admission on the live engine and every future
        replacement (a restart mid-drain must not reopen the doors)."""
        with self._lock:
            self._draining = True
            eng = self._engine
        eng.start_drain()

    def stats(self):
        """The live engine's stats() plus a ``supervisor`` block."""
        out = self.engine.stats()
        with self._lock:
            out["supervisor"] = {
                "restarts": self._restarts,
                "max_restarts": self.max_restarts,
                "restarting": self._restarting,
                "failed": self._failed_msg,
                "last_error": self._last_error,
                "draining": self._draining,
            }
        return out

    # ---- the supervision loop ------------------------------------------
    def run_loop(self, stop_event=None, idle_wait_s=0.05):
        """Drive the live engine; on abort, salvage + backoff + rebuild +
        resubmit, up to ``max_restarts`` times. Returns when
        ``stop_event`` is set; re-raises the final abort cause once the
        budget is exhausted (after failing every salvaged request)."""
        while stop_event is None or not stop_event.is_set():
            with self._lock:
                eng = self._engine
            try:
                eng.run_loop(stop_event, idle_wait_s=idle_wait_s)
                if stop_event is None or stop_event.is_set():
                    return
                continue
            except Exception as exc:
                if not self._recover(eng, exc, stop_event):
                    raise

    def _recover(self, eng, exc, stop_event):
        """One abort's recovery. Returns True when a replacement engine
        is live (loop continues), False when the failure is permanent or
        shutdown interrupted the restart (caller re-raises)."""
        salvaged = eng.pop_salvaged()
        cause = eng.aborted or ("serving engine aborted: %r" % (exc,))
        with self._lock:
            self._last_error = cause
            self._restarts += 1
            n = self._restarts
            permanent = n > self.max_restarts
            if permanent:
                self._failed_msg = (
                    "serving engine permanently failed (restart budget "
                    "%d exhausted): %s" % (self.max_restarts, cause))
                msg = self._failed_msg
            else:
                self._restarting = True
        if permanent:
            telemetry.event("serving.engine_restart", engine=eng.engine_id,
                            outcome="gave_up", restarts=n - 1,
                            error=cause)
            self._fail_salvaged(eng, salvaged, msg)
            return False
        backoff = min(self.backoff_s * (2.0 ** (n - 1)), self.backoff_max_s)
        telemetry.counter("serving.restarts").inc()
        telemetry.event("serving.engine_restart", engine=eng.engine_id,
                        outcome="restarting", restart=n,
                        backoff_s=round(backoff, 3),
                        salvaged=len(salvaged), error=cause)
        interrupted = (stop_event.wait(backoff) if stop_event is not None
                       else (time.sleep(backoff) or False))
        if interrupted:
            # shutdown won the race: wake the salvaged waiters honestly
            self._fail_salvaged(eng, salvaged,
                                "shutdown during engine restart: " + cause)
            with self._lock:
                self._restarting = False
            return False
        new_eng = self.factory()
        new_eng.salvage_on_abort = True
        with self._lock:
            draining = self._draining
        if draining:
            new_eng.start_drain()
        for req in salvaged:    # original submit order: FCFS is preserved
            new_eng.resubmit(req)
        with self._lock:
            self._engine = new_eng
            self._restarting = False
        return True

    @staticmethod
    def _fail_salvaged(eng, salvaged, msg):
        """Terminal path for requests that survived the abort but not
        the supervisor: fail them with the classified cause through the
        dead engine's obs so their traces close and waiters wake."""
        now = time.time()
        for req in salvaged:
            req.state = FAILED
            req.error = msg
            req.finish_t = now
            telemetry.counter("serving.requests_failed").inc()
            eng.obs.request_finished(req, failed=True)
            if req.done_event is not None:
                req.done_event.set()
