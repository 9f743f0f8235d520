"""Training health guard: NaN and stall sentinel, policy ladder, exact
rollback (counterpart of ``mxnet_tpu/guard.py``).

* **Sentinel** — each step's observables (the executor outputs and every
  gradient on the classic path; the step's outputs on the fused path)
  reduce on the device to two float32 scalars (sum of the outputs, global
  gradient norm²), pulled to the host with one sync per step.
  :meth:`Sentinel.classify` flags non-finite values always and
  EWMA-relative spikes once ``warmup_steps`` good steps built a baseline
  (the JAX package's classifier, copied).
* **Policy ladder** (``MXNET_GUARD_POLICY`` / ``fit(guard=...)``) —
  ``skip`` the bad update (on the classic path the gradients are dropped
  with the parameters untouched; on the fused path detection comes after
  the step, so skip escalates to abort once bad steps persist); after
  ``MXNET_GUARD_MAX_BAD_STEPS`` consecutive bad steps ``rollback`` to the
  last good snapshot (parameters, optimizer state and update counts,
  iterator position, numpy RNG and the port's generators); past
  ``max_rollbacks``, or with nothing to roll back to, ``abort`` with a
  :class:`BadStepError`. ``abort`` alone raises at the first bad step.
* **Stall watchdog** — a daemon thread fires when no step completes within
  ``MXNET_GUARD_STALL_S``: it logs the runtime's telemetry state, then
  interrupts the training thread, so ``fit`` raises :class:`StallError`.
  An interrupt is seen between bytecodes: a fit waiting on the device
  feed's queue sees it at once, one blocked inside a CUDA call when the
  call returns.
* **Mid-epoch checkpoints** — ``checkpoint_every=N`` writes an ordinary
  checkpoint every N good steps with a ``.resume`` sidecar
  (``model.save_resume_state``), so ``fit(auto_resume=...)`` lands on the
  exact next batch.

On the fused path a rollback writes into the tensors the step's CUDA graph
captured: ``set_params`` copies the snapshot in place before the next
replay, the optimizer's bytes go back through the shared state's
``set_states_bytes``, and the restored update counts set the learning
rate and Adam's bias correction written before each replay.

Metrics (always on): ``guard.bad_steps{reason}``, ``guard.rollbacks``,
``guard.stalls``, ``guard.checkpoint_errors``. The ``nan`` and ``stall``
fault points (``fault.py``) drive every path.
"""
from __future__ import annotations

import logging
import math
import signal
import threading
import time

import numpy as np
import torch

from . import model as model_mod
from . import random as _random
from . import telemetry
from .base import MXNetError, env_float, env_int, env_str

__all__ = ["GuardError", "BadStepError", "StallError", "GuardPolicy",
           "TrainingGuard", "Sentinel", "resolve"]

# the metric-name prefixes the stall watchdog's state dump covers
STATE_SUMMARY_PREFIXES = ("engine.", "pipeline.", "io.", "kvstore.", "kv.",
                          "fit.", "guard.", "compile.", "device.")


class GuardError(MXNetError):
    """Base class for health-guard failures."""


class BadStepError(GuardError):
    """Training aborted by the guard's policy ladder (non-finite or
    anomalous loss/gradients that skip/rollback could not heal)."""


class StallError(GuardError):
    """No training step completed within the watchdog deadline."""


POLICIES = ("off", "skip", "rollback", "abort")


class GuardPolicy:
    """Configuration for a :class:`TrainingGuard`; every argument defaults
    from its environment variable, as in the JAX package:

    * ``policy`` — ``off`` | ``skip`` | ``rollback`` | ``abort``
      (``MXNET_GUARD_POLICY``, default ``off``);
    * ``max_bad_steps`` — consecutive bad steps before skip escalates to
      rollback (``MXNET_GUARD_MAX_BAD_STEPS``, 3);
    * ``max_rollbacks`` — rollbacks before abort
      (``MXNET_GUARD_MAX_ROLLBACKS``, 2);
    * ``stall_timeout_s`` — the watchdog's deadline, 0 off
      (``MXNET_GUARD_STALL_S``); it arms at the first completed step;
    * ``spike_factor`` — a step is bad when its loss or gradient norm
      exceeds this × the EWMA of good steps, 0 off (``MXNET_GUARD_SPIKE``);
    * ``warmup_steps`` — good steps before spikes count
      (``MXNET_GUARD_WARMUP``, 10);
    * ``snapshot_every`` — good steps between rollback snapshots, 0 only
      the epoch-start one (``MXNET_GUARD_SNAPSHOT_STEPS``);
    * ``checkpoint_prefix`` / ``checkpoint_every`` — a checkpoint with a
      ``.resume`` sidecar every N good steps (``MXNET_GUARD_CKPT_STEPS``);
      fit fills the prefix from ``auto_resume``.
    """

    def __init__(self, policy=None, max_bad_steps=None, max_rollbacks=None,
                 stall_timeout_s=None, spike_factor=None, warmup_steps=None,
                 snapshot_every=None, checkpoint_prefix=None,
                 checkpoint_every=None):
        if policy is None:
            policy = env_str("MXNET_GUARD_POLICY", "off")
        policy = str(policy).lower()
        if policy not in POLICIES:
            raise MXNetError("MXNET_GUARD_POLICY must be one of %s, got %r"
                             % ("/".join(POLICIES), policy))
        self.policy = policy
        self.max_bad_steps = (max_bad_steps if max_bad_steps is not None
                              else env_int("MXNET_GUARD_MAX_BAD_STEPS", 3))
        self.max_rollbacks = (max_rollbacks if max_rollbacks is not None
                              else env_int("MXNET_GUARD_MAX_ROLLBACKS", 2))
        self.stall_timeout_s = (stall_timeout_s if stall_timeout_s is not None
                                else env_float("MXNET_GUARD_STALL_S", 0.0))
        self.spike_factor = (spike_factor if spike_factor is not None
                             else env_float("MXNET_GUARD_SPIKE", 0.0))
        self.warmup_steps = (warmup_steps if warmup_steps is not None
                             else env_int("MXNET_GUARD_WARMUP", 10))
        self.snapshot_every = (snapshot_every if snapshot_every is not None
                               else env_int("MXNET_GUARD_SNAPSHOT_STEPS", 0))
        self.checkpoint_prefix = checkpoint_prefix
        self.checkpoint_every = (checkpoint_every if checkpoint_every
                                 is not None
                                 else env_int("MXNET_GUARD_CKPT_STEPS", 0))

    @property
    def active(self):
        return self.policy != "off" or self.stall_timeout_s > 0

    def __repr__(self):
        return ("GuardPolicy(policy=%r, max_bad_steps=%d, max_rollbacks=%d, "
                "stall_timeout_s=%g, spike_factor=%g)"
                % (self.policy, self.max_bad_steps, self.max_rollbacks,
                   self.stall_timeout_s, self.spike_factor))


def resolve(guard, checkpoint_prefix=None, logger=None):
    """``fit``'s ``guard=`` argument as a :class:`TrainingGuard`, or None
    (no guard: the default when no ``MXNET_GUARD_*`` variable is set).
    Takes None (the environment), a policy name, a :class:`GuardPolicy` or
    a ready :class:`TrainingGuard`; ``checkpoint_prefix`` (fit's
    ``auto_resume``) is where mid-epoch checkpoints go when the policy
    names no prefix."""
    if isinstance(guard, TrainingGuard):
        guard._default_prefix = checkpoint_prefix
        return guard if guard.policy.active else None
    if guard is None:
        policy = GuardPolicy()
    elif isinstance(guard, GuardPolicy):
        policy = guard
    elif isinstance(guard, str):
        policy = GuardPolicy(policy=guard)
    else:
        raise TypeError("fit(guard=...) accepts None, a policy name, a "
                        "GuardPolicy, or a TrainingGuard; got %r" % (guard,))
    if not policy.active:
        return None
    obj = TrainingGuard(policy, logger=logger)
    obj._default_prefix = checkpoint_prefix
    return obj


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------


class Sentinel:
    """Per-step health classifier (the JAX package's).

    :meth:`measure` reduces the step's observables on their device to the
    sum of the outputs (NaN or Inf anywhere poisons it) and the global
    gradient norm², one two-float host pull per device. :meth:`classify`
    flags non-finite values always, and EWMA-relative spikes once
    ``warmup_steps`` good steps built a baseline; only good steps fold into
    the EWMA."""

    EWMA_ALPHA = 0.1

    def __init__(self, spike_factor=0.0, warmup_steps=10):
        self.spike_factor = float(spike_factor)
        self.warmup_steps = int(warmup_steps)
        self._good_steps = 0
        self._loss_ewma = None
        self._gnorm_ewma = None

    def measure(self, per_device):
        """``[(outputs, grads), ...]`` (tensors, one entry per device) ->
        ``(loss, grad_norm)`` floats."""
        loss = 0.0
        gsq = 0.0
        for outs, grads in per_device:
            if not outs and not grads:
                continue
            dev = (list(outs) + list(grads))[0].device
            acc = torch.zeros(2, dtype=torch.float32, device=dev)
            with torch.no_grad():
                for o in outs:
                    acc[0] += o.to(torch.float32).sum()
                for g in grads:
                    g32 = g.to(torch.float32).reshape(-1)
                    acc[1] += torch.dot(g32, g32)
            vals = acc.tolist()
            loss += vals[0]
            gsq += vals[1]
        return loss, math.sqrt(gsq) if gsq >= 0 else float("nan")

    def classify(self, loss, grad_norm):
        """Bad-step reason for this measurement, or ``None`` if healthy.
        A good step folds into the EWMA baselines; a bad one does not."""
        if loss is not None and not math.isfinite(loss):
            return "non_finite_loss"
        if grad_norm is not None and not math.isfinite(grad_norm):
            return "non_finite_grad"
        if self.spike_factor > 0 and self._good_steps >= self.warmup_steps:
            if (self._loss_ewma is not None and self._loss_ewma > 0
                    and loss is not None
                    and abs(loss) > self.spike_factor * self._loss_ewma):
                return "loss_spike"
            if (self._gnorm_ewma is not None and self._gnorm_ewma > 0
                    and grad_norm is not None
                    and grad_norm > self.spike_factor * self._gnorm_ewma):
                return "grad_spike"
        self._good_steps += 1
        a = self.EWMA_ALPHA
        if loss is not None:
            prev = abs(loss) if self._loss_ewma is None else self._loss_ewma
            self._loss_ewma = a * abs(loss) + (1 - a) * prev
        if grad_norm is not None:
            prev = (grad_norm if self._gnorm_ewma is None
                    else self._gnorm_ewma)
            self._gnorm_ewma = a * grad_norm + (1 - a) * prev
        return None


def _module_observables(module, want_grads=True):
    """``[(outputs, grads), ...]`` tensors per device of a bound module, or
    None when nothing is observable yet (a fused batch staged, not run)."""
    fused = getattr(module, "_fused", None)
    if fused is not None and fused.pending:
        return None
    if fused is not None and fused.has_outputs:
        # the fused step's gradients are inside its graph: outputs only
        return [([o.data for o in fused.get_outputs()], [])]
    eg = getattr(module, "_exec_group", None)
    if eg is None:
        return None
    per_device = []
    for dev, exe in enumerate(eg.execs):
        outs = [o.data for o in exe.outputs]
        grads = []
        if want_grads and eg.grad_arrays:
            for per_param in eg.grad_arrays:
                g = per_param[dev] if per_param is not None else None
                if g is not None:
                    grads.append(g.data)
        per_device.append((outs, grads))
    return per_device


def _poison_grads(module):
    """The ``nan`` fault (target=grad, the default): fill one real gradient
    array with NaN, so an unguarded update would corrupt the weights."""
    eg = getattr(module, "_exec_group", None)
    if eg is None or not eg.grad_arrays:
        return False
    for per_param in eg.grad_arrays:
        for g in per_param or []:
            if g is not None:
                g.data.fill_(float("nan"))
                return True
    return False


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


class _Snapshot:
    __slots__ = ("epoch", "nbatch", "arg", "aux", "opt_bytes", "opt_counts",
                 "iter_state", "rng", "generators")

    def __init__(self, epoch, nbatch, arg, aux, opt_bytes, opt_counts,
                 iter_state, rng, generators):
        self.epoch = epoch
        self.nbatch = nbatch
        self.arg = arg
        self.aux = aux
        self.opt_bytes = opt_bytes
        self.opt_counts = opt_counts
        self.iter_state = iter_state
        self.rng = rng
        self.generators = generators


def _opt_state_bytes(module):
    """Optimizer state as bytes, or None when it lives on a kvstore."""
    fused = getattr(module, "_fused", None)
    if fused is not None:
        return fused.get_states_bytes()
    upd = getattr(module, "_updater", None)
    if upd is not None:
        return upd.get_states()
    return None


def _set_opt_state_bytes(module, data):
    fused = getattr(module, "_fused", None)
    if fused is not None:
        fused.set_states_bytes(data)
        return True
    upd = getattr(module, "_updater", None)
    if upd is not None:
        upd.set_states(data)
        return True
    return False


def _iter_state(train_data):
    """``state_dict()`` of an iterator that supports it, else None."""
    fn = getattr(train_data, "state_dict", None)
    if fn is None:
        return None
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 — an unsupported iterator
        # degrades to position-less snapshots, not a dead fit
        logging.getLogger(__name__).warning(
            "guard: %s.state_dict() failed (%s); snapshots carry no "
            "iterator position", type(train_data).__name__, exc)
        return None


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------


class _Watchdog:
    """Daemon thread raising the alarm when no step completes in time.

    Arms on the FIRST :meth:`beat` (a first step's capture and kernel
    loading cannot false-fire it), then fires once when ``timeout_s``
    passes without another beat: logs the telemetry state, counts
    ``guard.stalls`` and interrupts the training thread with
    ``pthread_kill(SIGINT)`` — the main thread's blocking waits (a queue
    pop, ``time.sleep``) are interruptible. When fit runs on another
    thread, or SIGINT has a custom handler, it degrades to flag-only: fit
    checks :attr:`fired` at the top of every step."""

    GRACE = 10.0  # suspend() deadline multiplier

    def __init__(self, timeout_s, logger=None):
        self.timeout_s = float(timeout_s)
        self.logger = logger or logging.getLogger(__name__)
        self.fired = False
        self._lock = threading.Lock()
        self._last = None  # None until the first beat arms us
        self._stopped = False
        self._target = threading.current_thread()
        self._thread = threading.Thread(
            target=self._loop, name="mxnet-guard-watchdog", daemon=True)
        self._thread.start()

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def suspend(self):
        """Extend the deadline to ``GRACE × timeout`` from now (long
        between-step work: a rollback, a checkpoint, epoch-end work); an
        unarmed watchdog stays unarmed."""
        with self._lock:
            if self._last is not None:
                self._last = time.monotonic() + (self.GRACE - 1.0) \
                    * self.timeout_s

    def stop(self):
        with self._lock:
            self._stopped = True

    def _can_interrupt(self):
        if self._target is not threading.main_thread():
            return False
        try:
            return signal.getsignal(signal.SIGINT) is signal.default_int_handler
        except (ValueError, TypeError):
            return False

    def _loop(self):
        poll = max(min(self.timeout_s / 4.0, 1.0), 0.01)
        while True:
            time.sleep(poll)
            with self._lock:
                if self._stopped:
                    return
                if self._last is None:
                    continue
                if time.monotonic() - self._last <= self.timeout_s:
                    continue
                self.fired = True
                self._stopped = True  # fire once
                interrupt = self._can_interrupt()
            telemetry.counter("guard.stalls").inc()
            self._dump()
            if interrupt:
                try:
                    signal.pthread_kill(self._target.ident, signal.SIGINT)
                except (OSError, ValueError):  # thread gone: flag-only
                    pass
            return

    def _dump(self):
        """Log where the runtime is stuck: the telemetry state."""
        state = telemetry.state_summary(STATE_SUMMARY_PREFIXES)
        self.logger.error(
            "guard: no training step completed in %.1fs — stall. "
            "Runtime state: %s", self.timeout_s, state)
        telemetry.event("guard_stall", timeout_s=self.timeout_s, state=state)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


class TrainingGuard:
    """The fit loop's health supervisor (see the module docstring). Step
    protocol, in loop order::

        guard.check_stall()                      # top of step
        reason = guard.step_check(module)        # after forward_backward
        if reason is None: module.update()
        reason = reason or guard.post_check(module)
        if reason is None:
            guard.good_step(module, it, epoch, nbatch, iter_state)
        else:
            action = guard.bad_step(reason, epoch, nbatch)
    """

    def __init__(self, policy=None, logger=None):
        self.policy = policy or GuardPolicy()
        self.logger = logger or logging.getLogger(__name__)
        self.sentinel = Sentinel(self.policy.spike_factor,
                                 self.policy.warmup_steps)
        self._watchdog = None
        self._snapshot = None
        self._consecutive_bad = 0
        self._good_since_snapshot = 0
        self._good_since_checkpoint = 0
        self.bad_steps = 0
        self.rollbacks = 0
        self._stall_raised = False
        self._default_prefix = None  # per-fit fallback, set by resolve()
        self._ckpt_unsupported = False

    @property
    def checkpoint_prefix(self):
        """Where mid-epoch checkpoints go: the policy's prefix, else the
        current fit's ``auto_resume`` prefix."""
        return self.policy.checkpoint_prefix or self._default_prefix

    @property
    def last_snapshot(self):
        """The last in-memory restore point, or None."""
        return self._snapshot

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        if self.policy.stall_timeout_s <= 0:
            return
        if self._watchdog is None or self._watchdog.fired:
            self._watchdog = _Watchdog(self.policy.stall_timeout_s,
                                       self.logger)
            self._stall_raised = False

    def close(self):
        if self._watchdog is not None:
            self._watchdog.stop()
            # a fired watchdog stays visible through stall_fired until a
            # later fit replaces it
            if not self._watchdog.fired:
                self._watchdog = None

    def suspend_watchdog(self):
        """Extend the watchdog's deadline over epoch-boundary work."""
        if self._watchdog is not None:
            self._watchdog.suspend()

    @property
    def stall_fired(self):
        return self._watchdog is not None and self._watchdog.fired

    def check_stall(self):
        """Raise :class:`StallError` once the watchdog has fired (the
        flag-only delivery path)."""
        if self.stall_fired and not self._stall_raised:
            self._stall_raised = True
            raise StallError(
                "no training step completed within MXNET_GUARD_STALL_S="
                "%gs (telemetry state was dumped to the log)"
                % self.policy.stall_timeout_s)

    def stall_error(self):
        """The error fit raises when the watchdog's interrupt surfaced as
        KeyboardInterrupt."""
        self._stall_raised = True
        return StallError(
            "training stalled: no step completed within "
            "MXNET_GUARD_STALL_S=%gs (telemetry state was dumped to the "
            "log)" % self.policy.stall_timeout_s)

    # ---- sentinel hooks --------------------------------------------------
    def step_check(self, module):
        """Pre-update sentinel (the classic path): classify this step's
        outputs and gradients; a bad-step reason or None. On the fused
        path nothing is observable before ``update()``."""
        if self.policy.policy == "off":
            return None
        fused = getattr(module, "_fused", None)
        if fused is not None and fused.pending:
            # the `nan` point's budget belongs to post_check on this path
            return None
        from . import fault

        args = fault.hit("nan")
        poisoned_marker = False
        if args is not None:
            target = args.get("target", "grad")
            if target == "loss" or not _poison_grads(module):
                poisoned_marker = True
        obs = _module_observables(module)
        if obs is None:
            return None
        loss, gnorm = self.sentinel.measure(obs)
        if poisoned_marker:
            loss = float("nan")
        return self.sentinel.classify(loss, gnorm)

    def post_check(self, module):
        """Post-update sentinel (the fused path, where forward, backward
        and update ran as one step): classify its outputs. A bad step here
        already reached the parameters, so only rollback heals it."""
        if self.policy.policy == "off":
            return None
        fused = getattr(module, "_fused", None)
        if fused is None or not fused.has_outputs:
            return None
        from . import fault

        obs = _module_observables(module, want_grads=False)
        if not obs:
            return None
        loss, _ = self.sentinel.measure(obs)
        if fault.hit("nan") is not None:
            loss = float("nan")
        return self.sentinel.classify(loss, None)

    # ---- step outcomes ---------------------------------------------------
    def good_step(self, module, train_data, epoch, nbatch, iter_state=None):
        """Record a healthy step: heartbeat, ladder reset, and the periodic
        snapshot/checkpoint cadence. ``iter_state`` is the iterator's
        ``state_dict()`` as of this step's batch."""
        if self._watchdog is not None:
            self._watchdog.beat()
        self._consecutive_bad = 0
        p = self.policy
        if p.policy == "rollback":
            self._good_since_snapshot += 1
            if p.snapshot_every and \
                    self._good_since_snapshot >= p.snapshot_every:
                self.take_snapshot(module, train_data, epoch, nbatch + 1,
                                   iter_state)
        if self.checkpoint_prefix and p.checkpoint_every \
                and not self._ckpt_unsupported:
            self._good_since_checkpoint += 1
            if self._good_since_checkpoint >= p.checkpoint_every:
                self._good_since_checkpoint = 0
                self._write_checkpoint(module, epoch, nbatch + 1, iter_state)

    def bad_step(self, reason, epoch, nbatch, applied=False):
        """Count a bad step and decide the ladder action: ``skip`` |
        ``rollback`` | ``abort``. ``applied``: the bad update already
        reached the parameters (the fused path); ``skip`` then escalates
        to abort after ``max_bad_steps`` consecutive ones."""
        if self._watchdog is not None:
            # a bad step that completed is progress, not a stall
            self._watchdog.beat()
        self.bad_steps += 1
        self._consecutive_bad += 1
        telemetry.counter("guard.bad_steps", reason=reason).inc()
        telemetry.event("guard_bad_step", reason=reason, epoch=epoch,
                        nbatch=nbatch, applied=bool(applied))
        p = self.policy
        if p.policy == "abort":
            action = "abort"
        elif p.policy == "skip":
            if applied and self._consecutive_bad >= p.max_bad_steps:
                self.logger.error(
                    "guard: %d consecutive bad steps whose updates were "
                    "already applied (fused path) — skip cannot protect "
                    "the parameters here; aborting (use policy 'rollback' "
                    "to heal applied bad updates)", self._consecutive_bad)
                action = "abort"
            else:
                action = "skip"
        elif self._consecutive_bad < p.max_bad_steps:
            action = "skip"
        elif self._snapshot is None:
            self.logger.error(
                "guard: %d consecutive bad steps and no snapshot to roll "
                "back to — aborting", self._consecutive_bad)
            action = "abort"
        elif self.rollbacks >= p.max_rollbacks:
            self.logger.error(
                "guard: still diverging after %d rollbacks — aborting",
                self.rollbacks)
            action = "abort"
        else:
            action = "rollback"
        self.logger.warning(
            "guard: bad step at epoch %d batch %d (%s) — %s "
            "(%d consecutive)", epoch, nbatch, reason, action,
            self._consecutive_bad)
        return action

    def abort_error(self, reason, epoch, nbatch):
        return BadStepError(
            "training health guard aborted at epoch %d batch %d: %s "
            "(%d bad steps total, %d rollbacks; policy %r)"
            % (epoch, nbatch, reason, self.bad_steps, self.rollbacks,
               self.policy.policy))

    # ---- snapshots + rollback -------------------------------------------
    def epoch_start(self, module, train_data, epoch, nbatch=0):
        """Epoch-boundary snapshot (rollback policy) and cadence reset."""
        self._good_since_snapshot = 0
        if self.policy.policy == "rollback":
            self.take_snapshot(module, train_data, epoch, nbatch,
                               _iter_state(train_data))

    def take_snapshot(self, module, train_data, epoch, nbatch,
                      iter_state=None):
        """Capture the restore point: host copies of every parameter, the
        optimizer's state bytes and update counts, the iterator position,
        the numpy RNG and the port's generators."""
        arg, aux = module.get_params()
        self._snapshot = _Snapshot(
            epoch, nbatch,
            {k: v.asnumpy().copy() for k, v in arg.items()},
            {k: v.asnumpy().copy() for k, v in (aux or {}).items()},
            _opt_state_bytes(module), model_mod.optimizer_counts(module),
            iter_state if iter_state is not None else _iter_state(train_data),
            np.random.get_state(), _random.get_states())
        self._good_since_snapshot = 0

    def rollback(self, module, train_data):
        """Restore the last snapshot. Returns ``(epoch, nbatch,
        iter_restored)``; fit restarts its inner loop there. An iterator
        that cannot seek keeps its position (logged)."""
        from . import ndarray as nd
        from .context import cpu

        snap = self._snapshot
        if snap is None:
            raise GuardError("rollback without a snapshot")
        if self._watchdog is not None:
            self._watchdog.suspend()
        self.rollbacks += 1
        telemetry.counter("guard.rollbacks").inc()
        # in place into the bound arrays, and on the fused path into the
        # tensors its graph captured before the next replay
        module.set_params(
            {k: nd.array(v, ctx=cpu()) for k, v in snap.arg.items()},
            {k: nd.array(v, ctx=cpu()) for k, v in snap.aux.items()},
            force_init=True)
        if snap.opt_bytes is not None:
            if not _set_opt_state_bytes(module, snap.opt_bytes):
                self.logger.warning(
                    "guard: optimizer state lives on the kvstore — rollback "
                    "restored parameters only")
        model_mod.restore_optimizer_counts(module, snap.opt_counts)
        iter_restored = False
        if snap.iter_state is not None and \
                getattr(train_data, "load_state", None) is not None:
            try:
                train_data.load_state(snap.iter_state)
                iter_restored = True
            except Exception as exc:  # noqa: BLE001 — a seek failure
                # degrades to forward-only recovery
                self.logger.warning(
                    "guard: iterator load_state failed (%s); continuing "
                    "from the current position", exc)
        np.random.set_state(snap.rng)
        _random.set_states(snap.generators)
        self._consecutive_bad = 0
        self.logger.warning(
            "guard: rolled back to epoch %d batch %d (rollback %d/%d, "
            "iterator %s)", snap.epoch, snap.nbatch, self.rollbacks,
            self.policy.max_rollbacks,
            "restored" if iter_restored else "NOT restored")
        telemetry.event("guard_rollback", epoch=snap.epoch,
                        nbatch=snap.nbatch, iter_restored=iter_restored)
        return snap.epoch, snap.nbatch, iter_restored

    # ---- mid-epoch disk checkpoints -------------------------------------
    def _write_checkpoint(self, module, epoch, nbatch, iter_state):
        """An ordinary checkpoint named with the completed-epoch count plus
        the ``.resume`` sidecar that makes it land mid-epoch."""
        if not hasattr(module, "save_checkpoint"):
            self._ckpt_unsupported = True
            self.logger.warning(
                "guard: %s has no save_checkpoint — mid-epoch checkpoints "
                "disabled", type(module).__name__)
            return
        if self._watchdog is not None:
            self._watchdog.suspend()
        prefix = self.checkpoint_prefix
        try:
            module.save_checkpoint(prefix, epoch, save_optimizer_states=True)
            model_mod.save_resume_state(
                prefix, epoch, nbatch=nbatch, iter_state=iter_state,
                numpy_rng=np.random.get_state(),
                optimizer_counts=model_mod.optimizer_counts(module))
        except Exception as exc:  # noqa: BLE001 — a failing checkpoint
            # sink (disk full, prefix gone) must not kill a healthy fit
            telemetry.counter("guard.checkpoint_errors").inc()
            self.logger.error("guard: mid-epoch checkpoint failed: %s", exc)
