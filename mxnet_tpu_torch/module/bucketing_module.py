"""BucketingModule of the port (counterpart of
``mxnet_tpu/module/bucketing_module.py``; reference:
python/mxnet/module/bucketing_module.py).

One :class:`~.module.Module` per bucket key, each built from
``sym_gen(key)`` and bound at its bucket's shapes over the default
bucket's parameter arrays (``bind(shared_module=...)``). They share one
optimizer and updater (``borrow_optimizer``), so one update count runs
across buckets, and, on the fused path, one device state: each bucket
captures its own CUDA graph, every graph on the same master parameters
and optimizer slots, and a bucket switch moves nothing through the host.
"""
from __future__ import annotations

import logging
import warnings

from ..base import MXNetError
from .base_module import BaseModule, _check_input_names
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        symbol, data_names, label_names = sym_gen(default_bucket_key)
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) if fixed_param_names else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _check_bound(self, params=True, optimizer=False):
        if (not self.binded or (params and not self.params_initialized)
                or (optimizer and not self.optimizer_initialized)):
            raise MXNetError("bind, initialize the parameters and "
                             "init_optimizer first")

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._check_bound(params=False)
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._check_bound(params=False)
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._check_bound(params=False)
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._check_bound(params=False)
        return self._curr_module.symbol

    # ---- params ----------------------------------------------------------
    def get_params(self):
        """Host copies of the parameters, the fused updates synced in."""
        self._check_bound()
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        """Set through the current bucket (its arrays, host dicts and fused
        state are every bucket's; fit's epoch-end round trip of its own
        dicts moves nothing), every bucket with ``allow_missing``."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._check_bound(params=False)
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing, force_init=force_init)
        self._share_host_dicts()
        if allow_missing:
            for mod in self._buckets.values():
                if mod is not self._curr_module:
                    mod.set_params(arg_params, aux_params, allow_missing=True,
                                   force_init=force_init)
        self._params_dirty = allow_missing
        self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Initialize through the current bucket: the arrays, host dicts
        and fused state it writes are every bucket's."""
        if self.params_initialized and not force_init:
            return
        self._check_bound(params=False)
        self._curr_module.init_params(initializer=initializer, arg_params=arg_params,
                                      aux_params=aux_params, allow_missing=allow_missing,
                                      force_init=force_init)
        self._share_host_dicts()
        self._params_dirty = False
        self.params_initialized = True

    def _share_host_dicts(self):
        """Point every bucket at the current bucket's host parameter dicts
        (``init_params`` makes new ones): a bucket's fused step refreshes
        the shared device state from its own module's dicts."""
        cur = self._curr_module
        for mod in self._buckets.values():
            mod._arg_params, mod._aux_params = cur._arg_params, cur._aux_params

    # ---- bind ------------------------------------------------------------
    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context, work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module over the default
        bucket's arrays (and optimizer) the first time it is seen."""
        self._check_bound(params=False)
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad, force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        self._check_bound()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Bind the next batch's bucket ahead of its step (fit's prefetch),
        keeping the current one."""
        self._check_bound()
        original = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(original, None, None)

    # ---- compute ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._check_bound()
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._check_bound()
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._check_bound(optimizer=True)
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._check_bound()
        return self._curr_module.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check_bound()
        return self._curr_module.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._check_bound()
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._check_bound(params=False)
        for mod in self._buckets.values():
            mod.install_monitor(mon)
