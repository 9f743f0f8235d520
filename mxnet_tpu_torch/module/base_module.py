"""BaseModule with the fit loop (counterpart of
``mxnet_tpu/module/base_module.py``; reference:
python/mxnet/module/base_module.py).

``fit`` binds, initializes the parameters and the optimizer, then runs
epochs of ``forward_backward`` → ``update`` → ``update_metric`` over the
batches, with batch-end and epoch-end callbacks, the epoch-end
``get_params``/``set_params`` round trip and an optional evaluation pass;
``score`` and ``predict`` run inference passes.

``fit(auto_resume=prefix)`` continues a job that was cut: from the newest
intact checkpoint under ``prefix`` (``model.load_latest_valid_checkpoint``),
with its ``.states`` file when there is one (else a warm start, logged),
and, when a ``.resume`` sidecar lies beside it, at the exact batch, numpy
RNG and optimizer update counts it recorded.

``fit(guard=...)`` runs the training health guard (``guard.py``: a policy
name, a ``GuardPolicy``, a ``TrainingGuard``, or None for the
``MXNET_GUARD_*`` variables): each step's loss and gradients are
classified, bad steps skipped or rolled back per its ladder (the inner
loop restarts at the snapshot's batch), and its watchdog turns a hung
step into a ``StallError``. ``fit(monitor=Monitor(...))`` installs the
monitor (the module leaves the fused path) and brackets every step with
its ``tic``/``toc_print``. Every step is a ``fit.step`` span
(``epoch``/``nbatch`` args) on the profiler's trace; while telemetry is on
each step's wall is split into ``fit.compute_seconds`` (the step),
``fit.data_wait_seconds`` (the next batch) and ``fit.guard_seconds``.

On a parameter-server store (``kvstore='dist_*'`` under a launcher) every
RPC of a step carries ``epoch << 32 | nbatch`` (``KVStoreDist.set_step``),
and ``fit`` starts the store's cluster-stats publisher unless one runs
already (it stops only the one it started). With ``MXNET_ELASTIC=1``
(``tools/launch.py --elastic``) ``fit`` joins the membership registry
before the first RPC (:mod:`..elastic`), runs a rollback guard when none
was given, and answers a ``KVMembershipError`` — a worker or server lost,
a worker joined — by reconfiguring (drain, adopt, reshard, roll back) and
going on from the snapshot; a relaunched worker enters where the
survivors restart. The ``kill_worker`` fault point sits at the top of
every step.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import elastic as elastic_mod
from .. import fault as fault_mod
from .. import guard as guard_mod
from .. import metric as metric_mod
from .. import io as io_mod
from .. import model as model_mod
from .. import ndarray as nd
from .. import telemetry
from ..base import MXNetError
from ..context import cpu

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = model_mod.BatchEndParam


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith("_weight")
                      and not arg.endswith("_bias") and not arg.endswith("_gamma")
                      and not arg.endswith("_beta")]
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, str(names), name,
                                           "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _batch_samples(data_batch, source_iter):
    """Real samples in a batch: its size less the padding."""
    bs = getattr(source_iter, "batch_size", None)
    if not bs and data_batch.data:
        bs = data_batch.data[0].shape[0]
    return max(int(bs or 0) - int(getattr(data_batch, "pad", 0) or 0), 0)


class _StepMeter:
    """The fit loop's step split while telemetry is on: the step (forward,
    backward, update), the wait for the next batch, the guard's checks,
    the whole step, batches, samples and samples per second. The handles
    are resolved at the first step; off, each call is one flag check."""

    __slots__ = ("_inst",)

    def __init__(self):
        self._inst = None

    @staticmethod
    def now():
        return time.perf_counter() if telemetry.enabled() else 0.0

    def _instruments(self):
        if self._inst is None:
            # race-ok: idempotent lazy cache — racing initializers store
            # equal tuples of the same registry handles
            self._inst = (telemetry.histogram("fit.compute_seconds"),
                          telemetry.histogram("fit.data_wait_seconds"),
                          telemetry.histogram("fit.step_time_seconds"),
                          telemetry.counter("fit.batches"),
                          telemetry.counter("fit.samples"),
                          telemetry.gauge("fit.imgs_per_sec"),
                          telemetry.histogram("fit.guard_seconds"))
        return self._inst

    def guard(self, t0):
        if telemetry.enabled():
            self._instruments()[6].observe(time.perf_counter() - t0)

    def wait(self, t0):
        if telemetry.enabled():
            self._instruments()[1].observe(time.perf_counter() - t0)

    def step(self, t_step, t_compute, t_data, data_batch, source_iter):
        if not telemetry.enabled():
            return
        h_comp, h_wait, h_step, c_batch, c_samp, g_ips, _ = self._instruments()
        step_s = time.perf_counter() - t_step
        h_comp.observe(t_compute - t_step)
        h_wait.observe(t_data - t_compute)
        h_step.observe(step_s)
        c_batch.inc()
        n = _batch_samples(data_batch, source_iter)
        if n:
            c_samp.inc(n)
            if step_s > 0:
                g_ips.set(n / step_s)


class BaseModule:
    """The base class of a module."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ---- high-level ------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data`` (inference forwards)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric, locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yields ``(outputs, nbatch, batch)`` over ``eval_data``, padding
        dropped (inference forwards)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def get_states(self, merge_multi_context=True):
        """The states of a stateful module's graph: none here, as in the
        JAX package (RNN states are inputs)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        assert not states and not value

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """Outputs over ``eval_data``, padding dropped, as host NDArrays."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copyto(cpu())
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            # fwlint: disable=host-sync — predict(merge_batches=True) returns host arrays by contract
            merged = [nd.array(np.concatenate([out[i].asnumpy() for out in output_list]),
                               ctx=cpu())
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            auto_resume=None, guard=None):
        """Train for ``num_epoch`` epochs. ``arg_params``/``aux_params`` may
        be dicts of NDArrays, tensors or numpy arrays. ``auto_resume`` is a
        checkpoint prefix to continue from (see the module docstring); with
        no loadable checkpoint under it training starts afresh.
        ``monitor`` and ``guard`` are described there too."""
        from .. import initializer as init_mod

        if num_epoch is None:
            raise MXNetError("please specify number of epochs")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        resume_epoch = resume_state = None
        if auto_resume is not None:
            ckpt = model_mod.load_latest_valid_checkpoint(auto_resume)
            if ckpt is not None:
                _, arg_params, aux_params, resume_epoch = ckpt
                # the file name counts completed epochs: resuming at that
                # index repeats and skips nothing
                begin_epoch = max(begin_epoch, resume_epoch)
                if begin_epoch == resume_epoch:
                    resume_state = model_mod.load_resume_state(auto_resume,
                                                               resume_epoch)
                self.logger.info(
                    "auto-resume: restored '%s' epoch %d, continuing at epoch "
                    "%d%s", auto_resume, resume_epoch, begin_epoch,
                    " batch %d" % resume_state["nbatch"] if resume_state else "")
        guard_obj = guard_mod.resolve(guard, checkpoint_prefix=auto_resume,
                                      logger=self.logger)
        from ..kvstore import KVMembershipError

        # elastic: the store is made and joins the registry before its
        # first RPC, and survivors recover by rolling back, so a rollback
        # guard runs when none was given
        session = None
        if elastic_mod.enabled():
            kvstore, session = elastic_mod.prepare(kvstore, logger=self.logger)
            if session is not None and guard_obj is None:
                guard_obj = guard_mod.resolve("rollback",
                                              checkpoint_prefix=auto_resume,
                                              logger=self.logger)
        fault_rank = int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
        completed = False
        kv_obj = set_step = None
        started_cluster = False
        meter = _StepMeter()
        # MXNET_FEED_DEPTH: a transfer thread keeps the next batches on the
        # device (the feed is this fit's own and closed when it returns)
        inner_data = train_data
        train_data = io_mod.maybe_device_feed(
            train_data, getattr(self, "_context", None))
        try:
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True, force_rebind=force_rebind)
            if monitor is not None:
                self.install_monitor(monitor)
            self.init_params(initializer=initializer, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init or resume_epoch is not None)
            self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params)
            kv_obj = getattr(self, "_kvstore", None)
            set_step = getattr(kv_obj, "set_step", None)
            if getattr(kv_obj, "start_cluster_stats", None) is not None \
                    and kv_obj._cluster is None:
                # fit owns the publisher only when it started it
                started_cluster = kv_obj.start_cluster_stats() is not None
            if resume_epoch is not None:
                self._resume_optimizer(auto_resume, resume_epoch, resume_state)
            if session is not None and session.joining:
                # relaunched: adopt the membership and shard, pull the
                # servers' parameters, enter where the survivors restart
                joined = session.join(self, train_data)
                if joined is None:
                    completed = True
                    return
                begin_epoch, resume_state = joined
            if validation_metric is None:
                validation_metric = eval_metric
            if not isinstance(eval_metric, metric_mod.EvalMetric):
                eval_metric = metric_mod.create(eval_metric)
            if guard_obj is not None:
                guard_obj.start()
            # with a guard: the iterator's position as of each fetched
            # batch, so a snapshot after step n restores to batch n+1 though
            # the loop fetched n+1 before step n ended
            state_fn = getattr(train_data, "state_dict", None)
            track_state = guard_obj is not None and state_fn is not None

            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                start_nbatch = 0
                if resume_state is not None and epoch == begin_epoch:
                    start_nbatch = self._resume_fast_forward(train_data,
                                                             resume_state)
                    resume_state = None
                if guard_obj is not None:
                    guard_obj.epoch_start(self, train_data, epoch,
                                          start_nbatch)
                while True:  # restarted when the guard rolls back
                    rolled_back = False
                    nbatch = start_nbatch
                    data_iter = iter(train_data)
                    end_of_batch = False
                    t0 = meter.now()
                    try:
                        next_data_batch = next(data_iter)
                    except StopIteration:
                        # a mid-epoch resume may land on the epoch's end
                        break
                    next_state = state_fn() if track_state else None
                    meter.wait(t0)
                    while not end_of_batch:
                        data_batch = next_data_batch
                        cur_state = next_state
                        if set_step is not None:
                            # one step id across the cluster (BSP ranks
                            # run the same (epoch, nbatch) sequence)
                            set_step((epoch << 32) | nbatch)
                        # the machine-loss seam of the elastic cycle
                        fault_mod.kill_worker(fault_rank)
                        if guard_obj is not None:
                            guard_obj.check_stall()
                        if monitor is not None:
                            monitor.tic()
                        t_step = meter.now()
                        bad_reason = None
                        bad_applied = False
                        membership_changed = False
                        with telemetry.span("fit.step", "fit", epoch=epoch,
                                            nbatch=nbatch):
                            try:
                                self.forward_backward(data_batch)
                                if guard_obj is not None:
                                    # before the update: a bad classic step
                                    # is dropped, the parameters untouched
                                    t_guard = meter.now()
                                    bad_reason = guard_obj.step_check(self)
                                    meter.guard(t_guard)
                                if bad_reason is None:
                                    self.update()
                                    if guard_obj is not None:
                                        # the fused step's outputs exist
                                        # only now, its update applied
                                        t_guard = meter.now()
                                        bad_reason = guard_obj.post_check(self)
                                        meter.guard(t_guard)
                                        bad_applied = bad_reason is not None
                            except KVMembershipError:
                                # the cluster reconfigured under this step;
                                # without a session that stays fatal
                                if session is None:
                                    raise
                                membership_changed = True
                        t_compute = meter.now()
                        if membership_changed:
                            r_epoch, r_nbatch, iter_restored = \
                                self._reconfigure(session, train_data,
                                                  guard_obj)
                            if r_epoch != epoch:
                                self.logger.warning(
                                    "elastic: snapshot epoch %d != current "
                                    "epoch %d — resuming within the current "
                                    "epoch at its batch position", r_epoch,
                                    epoch)
                            eval_metric.reset()
                            start_nbatch = (r_nbatch if iter_restored
                                            else nbatch + 1)
                            rolled_back = True
                            break
                        if bad_reason is not None:
                            action = guard_obj.bad_step(bad_reason, epoch,
                                                        nbatch,
                                                        applied=bad_applied)
                            if action == "abort":
                                raise guard_obj.abort_error(bad_reason,
                                                            epoch, nbatch)
                            if action == "rollback":
                                _, r_nbatch, iter_restored = \
                                    guard_obj.rollback(self, train_data)
                                eval_metric.reset()
                                start_nbatch = (r_nbatch if iter_restored
                                                else nbatch + 1)
                                rolled_back = True
                                break
                            # skip: no update ran; the batch advances
                        try:
                            # fetch the next batch while the card works
                            next_data_batch = next(data_iter)
                            next_state = state_fn() if track_state else None
                            self.prepare(next_data_batch)
                        except StopIteration:
                            end_of_batch = True
                        t_data = meter.now()
                        if bad_reason is None:
                            self.update_metric(eval_metric, data_batch.label)
                            if guard_obj is not None:
                                guard_obj.good_step(self, train_data, epoch,
                                                    nbatch, cur_state)
                        meter.step(t_step, t_compute, t_data, data_batch,
                                   train_data)
                        if monitor is not None:
                            monitor.toc_print()
                        if batch_end_callback is not None:
                            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                                   eval_metric=eval_metric,
                                                   locals=locals())
                            for callback in _as_list(batch_end_callback):
                                callback(params)
                        nbatch += 1
                    if not rolled_back:
                        break
                if guard_obj is not None:
                    # epoch-boundary work is not a stall
                    guard_obj.suspend_watchdog()
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
                arg_params_, aux_params_ = self.get_params()
                self.set_params(arg_params_, aux_params_)
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params_, aux_params_)
                if eval_data:
                    res = self.score(eval_data, validation_metric,
                                     score_end_callback=eval_end_callback,
                                     batch_end_callback=eval_batch_end_callback,
                                     epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
                train_data.reset()
            completed = True
        except KeyboardInterrupt:
            # the watchdog interrupts a wedged step with SIGINT; a real
            # Ctrl-C (the watchdog never fired) goes on as it is
            if guard_obj is not None and guard_obj.stall_fired:
                raise guard_obj.stall_error() from None
            raise
        finally:
            if started_cluster:
                kv_obj.stop_cluster_stats()
            if session is not None:
                # a failed fit only stops beating: the lapse reconfigures
                # the survivors and the launcher's relaunch rejoins
                session.close(done=completed)
            if guard_obj is not None:
                guard_obj.close()
            if train_data is not inner_data:
                train_data.close()

    def _reconfigure(self, session, train_data, guard_obj):
        """The elastic session's recovery, started again when the
        membership changes once more during it (five times at most)."""
        from ..kvstore import KVMembershipError

        for attempt in range(5):
            try:
                return session.reconfigure(self, train_data, guard_obj)
            except KVMembershipError:
                self.logger.warning(
                    "elastic: membership changed again during "
                    "reconfiguration (attempt %d/5) — restarting recovery",
                    attempt + 1)
        raise MXNetError("elastic: membership kept changing through 5 "
                         "reconfiguration attempts — giving up (the cluster "
                         "is flapping)")

    def _resume_optimizer(self, prefix, epoch, resume_state):
        """Restore the optimizer states of checkpoint ``epoch`` (a warm
        start, logged, when the file is missing or does not load) and the
        sidecar's numpy RNG and update counts."""
        # the writer's %04d name first, then the unpadded one a hand-saved
        # 'prefix-N.params' would have beside it
        states = next((f for f in ("%s-%04d.states" % (prefix, epoch),
                                   "%s-%d.states" % (prefix, epoch))
                       if os.path.exists(f)), None)
        if states is None:
            self.logger.warning("auto-resume: no optimizer states for epoch %d "
                                "of '%s': a warm start", epoch, prefix)
        elif not hasattr(self, "load_optimizer_states"):
            self.logger.warning("auto-resume: a %s does not load optimizer "
                                "states: a warm start", type(self).__name__)
        else:
            try:
                self.load_optimizer_states(states)
                self.logger.info("auto-resume: restored optimizer states from %s",
                                 states)
            except Exception as exc:  # noqa: BLE001 — the params are restored
                self.logger.warning("auto-resume: ignoring unloadable optimizer "
                                    "states %s (a warm start): %s", states, exc)
        if resume_state is not None:
            rng = model_mod.decode_rng(resume_state.get("numpy_rng"))
            if rng is not None:
                np.random.set_state(rng)
            model_mod.restore_optimizer_counts(
                self, resume_state.get("optimizer_counts"))

    def _resume_fast_forward(self, train_data, resume_state):
        """Position ``train_data`` at the sidecar's batch; returns the batch
        number to continue from. An iterator that can seek (its
        ``state_dict()`` is not None) seeks to the sidecar's ``iter_state``
        with ``load_state``; one that cannot, or a sidecar without a state,
        is drawn batch by batch to the same position."""
        nbatch = int(resume_state.get("nbatch") or 0)
        state = resume_state.get("iter_state")
        if state is not None and io_mod._state_of(train_data) is not None:
            train_data.load_state(state)
            self.logger.info("auto-resume: iterator repositioned to batch %d",
                             nbatch)
            return nbatch
        it = iter(train_data)
        for done in range(nbatch):
            try:
                next(it)
            except StopIteration:
                self.logger.warning("auto-resume: iterator exhausted after %d "
                                    "of %d skipped batches", done, nbatch)
                break
        return nbatch

    # ---- symbol ----------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def prepare(self, data_batch):
        """Prepare for processing a data batch (no-op by default)."""

    # ---- abstract interface ---------------------------------------------
    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save the parameters to a ``.params`` file (``arg:``/``aux:``
        name prefixes)."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        """Load the parameters from a ``.params`` file written by
        :meth:`save_params` (by either package)."""
        save_dict = nd.load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        raise NotImplementedError()
