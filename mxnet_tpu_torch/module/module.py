"""Module — the training API of the port (counterpart of
``mxnet_tpu/module/module.py``; reference: python/mxnet/module/module.py).

The classic executor-group path: with one context and no distributed
kvstore the JAX package creates no kvstore, sets
``rescale_grad = 1 / batch_size`` and lets the :class:`~..optimizer.Updater`
update each parameter — so does the port. A ``Module`` built without a
``context`` runs on the card (:func:`~..context.default_device`, which
raises when there is none); tests pass ``context=cpu()``.

Not in this slice: the fused one-program step (a CUDA graph on the
card), kvstores and several contexts, ``compute_dtype``, checkpoints
(``save_checkpoint``/``load`` wait for ``.params`` I/O), optimizer-state
files, ``BucketingModule`` and monitors (``ROADMAP.md`` A1, A3, A6, A7).
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import context as ctx_mod
from .. import optimizer as opt
from ..base import MXNetError
from ..io import DataDesc
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, compute_dtype=None):
        super().__init__(logger=logger)
        if compute_dtype is not None:
            raise MXNetError("compute_dtype (mixed precision) is not ported "
                             "yet (ROADMAP.md A3)")
        if context is None:
            context = [ctx_mod.default_device()]
        if isinstance(context, (torch.device, str)):
            context = [torch.device(context)]
        self._context = [torch.device(c) for c in context]
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        if len(work_load_list) != len(self._context):
            raise MXNetError("work_load_list needs one entry per context")
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names) if fixed_param_names else []
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names) if state_names else []
        self._output_names = symbol.list_outputs()

        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    # ---- properties ------------------------------------------------------
    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._exec_group.get_output_shapes()

    # ---- params ----------------------------------------------------------
    def get_params(self):
        """Host (CPU) copies of the parameters: (arg_params, aux_params)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Initialize the bound parameters: from ``arg_params``/``aux_params``
        (dicts of NDArrays, tensors or numpy arrays) where given, else by
        ``initializer`` (name-suffix dispatch, each Variable's own
        ``__init__`` attr first)."""
        from .. import initializer as init_mod

        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "init_params call ignored.", stacklevel=2)
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        if initializer is None and not (arg_params and aux_params):
            initializer = init_mod.Uniform(0.01)

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    if cache[name] is not arr:
                        arr[:] = cache[name]
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(name, arr)
            else:
                initializer(name, arr)

        attrs = self._symbol.attr_dict()
        exe = self._exec_group.execs[0]
        for name, arr in sorted(exe.arg_dict.items()):
            if name in self._param_names:
                _impl(_init_desc(name, attrs), arr, arg_params)
        for name, arr in sorted(exe.aux_dict.items()):
            _impl(_init_desc(name, attrs), arr, aux_params)
        # host copies of the initialized parameters
        host = ctx_mod.cpu()
        self._arg_params = {name: arr.copyto(host) for name, arr in exe.arg_dict.items()
                            if name in self._param_names}
        self._aux_params = {name: arr.copyto(host) for name, arr in exe.aux_dict.items()}
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ---- bind ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module (bucketing) is not ported yet "
                             "(ROADMAP.md A1)")
        if not for_training and inputs_need_grad:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        self._label_shapes = ([x if isinstance(x, DataDesc) else DataDesc(*x)
                               for x in label_shapes]
                              if label_shapes is not None and len(label_shapes) else None)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, self._data_shapes,
            self._label_shapes, self._param_names, for_training, inputs_need_grad,
            None, logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)


    # ---- optimizer -------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """The optimizer and its updater. With one context and a kvstore
        that is None or not distributed no kvstore is created, and
        ``rescale_grad`` defaults to ``1 / batch_size``."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the parameters first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore is not None and (not isinstance(kvstore, str) or "dist" in kvstore):
            raise MXNetError("kvstore %r is not ported yet (ROADMAP.md A6)" % (kvstore,))
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            warnings.warn(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size (%s vs. %s). Is this "
                "intended?" % (optimizer.rescale_grad, rescale_grad), stacklevel=2)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # ---- compute ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter that has a gradient."""
        if not (self.binded and self.params_initialized and self.optimizer_initialized):
            raise MXNetError("bind, initialize and init_optimizer first")
        self._params_dirty = True
        pairs = [(index, grads[0], params[0]) for index, (params, grads) in enumerate(
                     zip(self._exec_group.param_arrays, self._exec_group.grad_arrays))
                 if grads[0] is not None]
        self._updater.update_all(pairs)

    def get_outputs(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized and self.inputs_need_grad):
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)


def _init_desc(name, attrs):
    from ..initializer import InitDesc

    return InitDesc(name, attrs.get(name, {}))
