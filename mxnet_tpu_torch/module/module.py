"""Module — the training API of the port (counterpart of
``mxnet_tpu/module/module.py``; reference: python/mxnet/module/module.py).

Two paths, as in the JAX package. The fused path (:mod:`.fused_path`)
runs forward, backward and the optimizer update as one step, captured as
a CUDA graph on the card; it is taken on a card's context with kvstore
None, ``'local'`` or ``'device'``, and on the CPU with ``'device'``
(:meth:`Module._fused_veto` lists what keeps the classic path, with the
JAX package's warnings; ``MXNET_MODULE_NO_FUSED=1`` turns it off). The
classic executor-group path: with one context and no distributed kvstore
the JAX package creates no kvstore, sets ``rescale_grad = 1 / batch_size``
and lets the :class:`~..optimizer.Updater` update each parameter — so
does the port. ``compute_dtype`` runs the graph in that dtype over
float32 master parameters on both paths. A ``Module`` built without a
``context`` runs on the card (:func:`~..context.default_device`, which
raises when there is none); tests pass ``context=cpu()``.

Checkpoints (``save_checkpoint``/``Module.load``, with the optimizer's
``.states`` file when asked) are the JAX package's files, readable by
either package; ``save_optimizer_states``/``load_optimizer_states`` go
through the fused path's or the Updater's states, whichever is live.

``bind(shared_module=...)`` binds over another module's parameter arrays
and ``borrow_optimizer`` shares its optimizer, updater and fused state:
the buckets of a ``BucketingModule``. ``reshape`` rebinds at new batch
shapes over the same arrays. Not in this slice: kvstores and several
contexts, and monitors (``ROADMAP.md`` A6, A7).
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import context as ctx_mod
from .. import io as io_mod
from .. import model as model_mod
from .. import optimizer as opt
from ..base import MXNetError, env_flag
from ..io import DataDesc
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, compute_dtype=None):
        super().__init__(logger=logger)
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
        # mixed precision: the graph runs in this dtype over float32
        # master parameters
        self._compute_dtype = compute_dtype
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
        self._grad_req = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = None    # the fused path, set by init_optimizer
        self._fused_kvstore_arg = None
        self._preload_opt_states = None   # a .states file for init_optimizer

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint written by :meth:`save_checkpoint` or
        ``model.save_checkpoint`` (of either package); ``kwargs`` go to the
        constructor. The parameters are set at the next ``bind``, the
        optimizer states (``prefix-%04d.states``) at ``init_optimizer``."""
        sym, args, auxs = model_mod.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, both
        crash-safely, in the JAX package's format, and retire a stale
        ``.resume`` sidecar of this epoch number. With
        ``save_optimizer_states`` also ``prefix-%04d.states`` and a
        sidecar at batch 0 that carries the optimizer's update counts (the
        ``.states`` format has no room for them; without them an
        epoch-boundary resume restarts Adam's bias correction at t = 1,
        which the JAX package does)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        model_mod.clear_resume_state(prefix, epoch)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            model_mod.save_resume_state(
                prefix, epoch, 0,
                optimizer_counts=model_mod.optimizer_counts(self))
            logging.info('Saved optimizer state to "%s"', state_name)

    def save_optimizer_states(self, fname):
        """Write the optimizer's states to ``fname`` crash-safely, with a
        CRC footer, as the JAX package's ``.states`` payload."""
        from ..utils.atomic_file import atomic_write

        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer first")
        with atomic_write(fname) as fout:
            fout.write(self._fused.get_states_bytes() if self._fused is not None
                       else self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Read a ``.states`` file of either package, from either path.
        States that do not fit the bound parameters raise
        :class:`MXNetError` (``fit(auto_resume=...)`` then warm-starts)."""
        from ..utils.atomic_file import read_verified

        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer first")
        data = read_verified(fname)
        if self._fused is not None:
            self._fused.set_states_bytes(data)
        else:
            self._updater.set_states(data)
            self._updater.check_state_shapes(self._expected_state_shapes(),
                                             source=fname)

    def _expected_state_shapes(self):
        """``{index: weight shape}`` in the classic Updater's layout."""
        return {i: tuple(w[0].shape)
                for i, w in enumerate(self._exec_group.param_arrays)}

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
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        if self._fused is not None and self._fused.device_dirty:
            self._fused.sync_to_module()
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

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
        if self._fused is not None:
            self._fused.invalidate()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        if (arg_params is self._arg_params and aux_params is self._aux_params
                and self._fused is not None and not self._fused.device_dirty
                and not self._params_dirty):
            # fit's epoch-end get_params -> set_params: the host dicts, the
            # executor group and the fused path already agree
            return
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
        if self._fused is not None:
            self._fused.invalidate()

    # ---- bind ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        fused = self._fused
        if force_rebind:
            if fused is not None and fused.device_dirty:
                self.get_params()   # the fused path's parameters first
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None and not (
                isinstance(shared_module, Module) and shared_module.binded
                and shared_module.params_initialized):
            raise MXNetError("shared_module must be a bound Module with "
                             "initialized parameters")
        if not for_training and inputs_need_grad:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        self._label_shapes = ([x if isinstance(x, DataDesc) else DataDesc(*x)
                               for x in label_shapes]
                              if label_shapes is not None and len(label_shapes) else None)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, self._data_shapes,
            self._label_shapes, self._param_names, for_training, inputs_need_grad,
            None if shared_module is None else shared_module._exec_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names,
            compute_dtype=self._compute_dtype)
        if shared_module is not None:
            # the lender's arrays are bound, its host dicts shared
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
            return
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if fused is not None and self.optimizer_initialized:
            # a rebind to new shapes: a new fused path (and graph) for them,
            # carrying the optimizer state
            states = fused.states_for_updater()
            self._fused = self._build_fused_path(self._fused_kvstore_arg)
            if self._fused is not None:
                self._fused.set_states_from_updater(states)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind at new batch shapes over the same parameter arrays; a
        fused path gets a trainer (and graph) for the new shapes over the
        same device state."""
        if not self.binded:
            raise MXNetError("bind first")
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        self._label_shapes = ([x if isinstance(x, DataDesc) else DataDesc(*x)
                               for x in label_shapes]
                              if label_shapes is not None else None)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self._fused is not None:
            self._fused.drop_batch()
            self._fused = self._build_fused_path(self._fused_kvstore_arg,
                                                 share_state=self._fused.state)

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
        self._fused_kvstore_arg = kvstore
        self._fused = self._build_fused_path(kvstore)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer and updater (one update
        count for both) and, when it trains on the fused path, its device
        state: this module gets a fused path of its own shapes over the
        same master parameters and optimizer slots."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("the lender's optimizer is not initialized")
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._fused_kvstore_arg = shared_module._fused_kvstore_arg
        self._fused = (None if shared_module._fused is None else
                       self._build_fused_path(self._fused_kvstore_arg,
                                              share_state=shared_module._fused.state))
        self.optimizer_initialized = True

    def _fused_veto(self, kvstore_arg):
        """Why this configuration does not run as one program per step —
        None when it does. The JAX package's reasons for one context, with
        the card's context in the TPU's place: kvstore None, 'local' and
        'device' fuse on a card, only 'device' on the CPU."""
        if env_flag("MXNET_MODULE_NO_FUSED"):
            return "MXNET_MODULE_NO_FUSED=1 (explicit opt-out)"
        from ..symbol import _topo_order

        if any(node.op == "Custom" for node in _topo_order(self._symbol._entries)):
            return ("the symbol holds a Custom op (host Python: a captured "
                    "step would replay what it did at capture time)")
        if self._grad_req != "write":
            return "grad_req=%r (fused step supports 'write' only)" % (
                self._grad_req,)
        if self.inputs_need_grad:
            return "inputs_need_grad=True"
        if self._state_names:
            return "state_names are bound"
        if self._fixed_param_names:
            return "fixed_param_names are bound"
        from .fused_path import batch_axes_standard

        if not batch_axes_standard(self._data_shapes or []) or (
                self._label_shapes
                and not batch_axes_standard(self._label_shapes)):
            return "a data/label layout has a non-leading batch axis"
        # the fused step seeds ones into loss OUTPUTS only: a symbol with
        # none would train on zero gradients
        from ..ops.registry import get_op

        if not any(not node.is_variable and get_op(node.op).is_loss
                   for node, _ in self._symbol._entries):
            return "symbol has no loss output (trained via out_grads)"
        if kvstore_arg is not None and "dist" in kvstore_arg:
            return ("distributed kvstore %r (the hybrid fused step is not "
                    "ported: ROADMAP.md A6)" % (kvstore_arg,))
        if kvstore_arg in ("device", "local_allreduce_device"):
            return None
        if self._context[0].type == "cuda" and kvstore_arg in (None, "local"):
            return None
        return ("kvstore=%r on a CPU context (pass kvstore='device' to opt "
                "in)" % (kvstore_arg,))

    def _build_fused_path(self, kvstore_arg, share_state=None):
        veto = self._fused_veto(kvstore_arg)
        if veto is not None:
            # loud when the user plausibly expected the fused path: a card's
            # context or an explicit kvstore='device' (CPU + local is the
            # expected classic default: quiet)
            wanted_fast = (
                (isinstance(kvstore_arg, str)
                 and (kvstore_arg in ("device", "local_allreduce_device")
                      or "dist" in kvstore_arg))
                or any(c.type == "cuda" for c in self._context))
            if wanted_fast and "MXNET_MODULE_NO_FUSED" not in veto:
                self.logger.warning(
                    "Module.fit is NOT using the fused SPMD fast path: %s. "
                    "Training runs on the executor-group path (one launch "
                    "per kernel instead of one CUDA graph per step). Set "
                    "MXNET_MODULE_NO_FUSED=1 to silence this warning if "
                    "the classic path is intended.", veto)
            return None
        try:
            from .fused_path import FusedFitPath

            return FusedFitPath(self, share_state=share_state)
        except ValueError as e:   # an optimizer without a fused rule
            self.logger.info("fused SPMD path unavailable (%s); using the "
                             "executor-group path", e)
            return None

    # ---- compute ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self._fused is not None:
            train = self.for_training if is_train is None else is_train
            if train and self._fused.accepts(data_batch):
                # stage only: update() runs forward, backward and update
                self._fused.stage(data_batch)
                return
            # a classic-path consumer (eval, a batch of another shape): it
            # sees the fused updates, and no stale staged batch or outputs
            self._fused.sync_to_module()
            self._fused.drop_batch()
        # a uint8-wire batch (io.WireSpec) is decoded here, on the bound
        # device, into the float32 NCHW arrays the executors were bound for
        data_batch = io_mod.apply_wire(
            data_batch, ctx=io_mod.wire_decode_ctx(self._context))
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self._fused is not None and self._fused.pending:
            if out_grads is None:
                return   # the gradient is computed inside update()
            # explicit head gradients cannot be seeded into the fused
            # step: replay the staged batch on the classic path
            batch = io_mod.apply_wire(
                self._fused.staged_batch,
                ctx=io_mod.wire_decode_ctx(self._context))
            self._fused.sync_to_module()
            self._fused.drop_batch()
            self._exec_group.forward(batch, True)
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter that has a gradient: the
        fused step when a batch is staged for it, else the Updater."""
        if not (self.binded and self.params_initialized and self.optimizer_initialized):
            raise MXNetError("bind, initialize and init_optimizer first")
        self._params_dirty = True
        if self._fused is not None and self._fused.pending:
            self._fused.step()
            return
        handover = self._fused is not None and (
            self._fused.state.states is not None
            or self._fused.state.host_states is not None)
        if handover:
            # a classic update mid-fused-training keeps the fused momentum
            # and Adam moments, and the update count goes on from where
            # the fused steps left it
            self._optimizer.begin_num_update = self._optimizer.num_update
            self._optimizer._index_update_count = {}
            self._updater.states = self._fused.states_for_updater()
        pairs = [(index, grads[0], params[0]) for index, (params, grads) in enumerate(
                     zip(self._exec_group.param_arrays, self._exec_group.grad_arrays))
                 if grads[0] is not None]
        self._updater.update_all(pairs)
        if self._fused is not None:
            # the executor group's parameters are now the truth, and the
            # classic step's optimizer state goes back to the fused path
            self._fused.invalidate()
            if handover:
                self._fused.set_states_from_updater(self._updater.states)

    def get_outputs(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self._fused is not None and self._fused.has_outputs:
            outs = self._fused.get_outputs()
            return outs if merge_multi_context else [[o] for o in outs]
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized and self.inputs_need_grad):
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused is not None and self._fused.has_outputs:
            self._fused.update_metric(eval_metric, labels)
            return
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        raise MXNetError("monitors are not ported yet (ROADMAP.md A7)")


def _init_desc(name, attrs):
    from ..initializer import InitDesc

    return InitDesc(name, attrs.get(name, {}))
