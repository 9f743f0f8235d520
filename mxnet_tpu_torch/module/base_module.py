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
RNG and optimizer update counts it recorded. The JAX package's health
``guard``, ``monitor``, elastic membership and telemetry hooks are not
ported yet: passing ``guard`` or ``monitor`` raises (``ROADMAP.md`` A7).
"""
from __future__ import annotations

import logging
import os
import time
from collections import namedtuple

import numpy as np

from .. import metric as metric_mod
from .. import io as io_mod
from .. import model as model_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


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
        no loadable checkpoint under it training starts afresh."""
        from .. import initializer as init_mod

        if num_epoch is None:
            raise MXNetError("please specify number of epochs")
        for name, value in (("monitor", monitor), ("guard", guard)):
            if value is not None:
                raise MXNetError("fit(%s=...) is not ported yet (ROADMAP.md A7)" % name)
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
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init or resume_epoch is not None)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_epoch is not None:
            self._resume_optimizer(auto_resume, resume_epoch, resume_state)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            if resume_state is not None and epoch == begin_epoch:
                nbatch = self._resume_fast_forward(train_data, resume_state)
                resume_state = None
            data_iter = iter(train_data)
            end_of_batch = False
            try:
                next_data_batch = next(data_iter)
            except StopIteration:
                # a mid-epoch resume may land on the epoch's end
                end_of_batch = True
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                try:
                    # fetch the next batch while the card works on this one
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric, locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
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
