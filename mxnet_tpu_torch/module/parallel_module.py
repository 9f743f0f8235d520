"""ParallelLMModule — the Module face of the dense, sp, pp and ep LM
trainers (counterpart of ``mxnet_tpu/module/parallel_module.py``).

One user-facing path trains the same decoder-only transformer dense,
sequence parallel, pipeline parallel or expert parallel through the
unchanged ``BaseModule.fit`` loop (bind, init_params, init_optimizer,
forward/update/update_metric, checkpoints)::

    mod = mx.mod.ParallelLMModule(
        vocab_size=1000, num_layers=4, model_dim=128, num_heads=4,
        ffn_dim=256, seq_len=64, mode="sp", num_devices=4)
    mod.fit(train_iter, num_epoch=3, optimizer="adam",
            eval_metric=mx.metric.Perplexity(ignore_label=None))

Batches carry ``data`` (B, T) token ids and ``softmax_label`` (B, T)
next-token targets; ``get_outputs()`` returns softmax probabilities
(B*T, V), so Perplexity, Accuracy and ``score()`` read them as they read
the symbol module's SoftmaxOutput. The mesh is ``num_devices`` positions
from :func:`~..parallel.mesh.build_mesh` (the visible cards, repeated in
order: on one card every position is ``cuda:0``; the CPU inside ``with
mx.cpu():``); dense mode runs on the current context. Parameters are the
one name-keyed family of :func:`~..parallel.lm.init_lm_params` in every
mode; ``save_params``/``load_params`` write and read the JAX package's
``.params`` files, so a dense checkpoint of either package warm-starts an
sp or pp run (ep's FFN weights have an expert axis).

As in the JAX package, ``update()`` runs the whole step (forward,
backward, update), and ``get_outputs()`` after it evaluates the batch
with the updated parameters; ``.loss`` is the step's own loss.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["ParallelLMModule"]


def _as_tensor(arr):
    """A parameter value (NDArray, tensor or array-like) as a tensor."""
    if hasattr(arr, "data") and hasattr(arr, "context"):
        return arr.data
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(np.asarray(arr))


class ParallelLMModule(BaseModule):
    def __init__(self, vocab_size, num_layers, model_dim, num_heads, ffn_dim,
                 seq_len, mode="dense", mesh=None, num_devices=None,
                 num_experts=0, microbatches=None, capacity_factor=2.0,
                 seed=0, logger=logging):
        super().__init__(logger=logger)
        if mode not in ("dense", "sp", "pp", "ep"):
            raise MXNetError("ParallelLMModule: unknown mode %r" % (mode,))
        if mode == "ep" and not num_experts:
            raise MXNetError("mode='ep' needs num_experts > 0")
        self.mode = mode
        self._cfg = dict(vocab_size=vocab_size, num_layers=num_layers,
                         model_dim=model_dim, num_heads=num_heads,
                         ffn_dim=ffn_dim, seq_len=seq_len)
        self._num_experts = num_experts
        self._microbatches = microbatches
        self._capacity_factor = capacity_factor
        self._seed = seed
        self._mesh = mesh
        self._num_devices = num_devices
        self._device = None
        self._trainer = None
        self._params = None      # name -> tensor on the home device
        self._opt_state = None
        self._staged = None      # (tokens, labels) staged by forward
        self._metric_tokens = None
        self._outs = None        # probabilities of the staged tokens
        self._last_loss = None

    # ---- where it runs ---------------------------------------------------
    def _ensure_mesh(self):
        if self.mode == "dense" or self._mesh is not None:
            return self._mesh
        from ..parallel import build_mesh

        n = self._num_devices or max(torch.cuda.device_count(), 1)
        self._mesh = build_mesh({self.mode: n})
        return self._mesh

    def _home(self):
        """The device the parameters live on: position 0's, or the current
        context in dense mode (fixed at first use)."""
        if self._device is None:
            mesh = self._ensure_mesh()
            if mesh is not None:
                self._device = mesh.device_list[0]
            else:
                from ..context import resolve

                self._device = resolve(None)
        return self._device

    # ---- Module protocol -------------------------------------------------
    @property
    def data_names(self):
        return ["data"]

    @property
    def label_names(self):
        return ["softmax_label"]

    @property
    def output_names(self):
        return ["softmax_output"]

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        (b, t) = self._data_shapes[0].shape
        return [("softmax_output", (b * t, self._cfg["vocab_size"]))]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        from ..io import DataDesc

        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad or grad_req != "write":
            raise MXNetError(
                "ParallelLMModule supports grad_req='write' without input "
                "grads (the step is one fused program)")
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]
        shape = tuple(self._data_shapes[0].shape)
        if len(shape) != 2 or shape[1] != self._cfg["seq_len"]:
            raise MXNetError("data must be (batch, seq_len=%d), got %s"
                             % (self._cfg["seq_len"], (shape,)))
        if self.mode == "pp":
            m = self._microbatches or self._ensure_mesh().shape["pp"]
            if shape[0] % m:
                raise MXNetError("batch %d must divide into %d pipeline "
                                 "microbatches" % (shape[0], m))
            self._microbatches = m
        self.for_training = for_training
        self.binded = True

    def _cfg_with_experts(self):
        cfg = dict(self._cfg)
        if self.mode == "ep":
            cfg["num_experts"] = self._num_experts
        return cfg

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        if self.params_initialized and not force_init:
            return
        from .. import ndarray as nd
        from ..parallel.lm import init_lm_params

        home = self._home()
        params = {n: torch.as_tensor(a).to(home)
                  for n, a in init_lm_params(self._seed,
                                             **self._cfg_with_experts()).items()}
        if initializer is not None:
            for name, arr in params.items():
                holder = nd.NDArray(arr)
                initializer(name, holder)
                params[name] = holder.data.to(home, torch.float32)
        for name, arr in (arg_params or {}).items():
            if name not in params:
                if not allow_missing:
                    raise MXNetError("unknown parameter %s" % name)
                continue
            a = _as_tensor(arr)
            if tuple(a.shape) != tuple(params[name].shape):
                raise MXNetError("shape mismatch loading %s: %s vs %s"
                                 % (name, tuple(a.shape),
                                    tuple(params[name].shape)))
            params[name] = a.detach().to(home, torch.float32, copy=True)
        self._params = params
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the parameters first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        from ..parallel import lm as lm_mod

        kwargs = dict(optimizer=optimizer,
                      optimizer_params=dict(optimizer_params))
        mesh = self._ensure_mesh()
        if self.mode == "dense":
            self._trainer = lm_mod.DenseLMTrainer(device=self._home(),
                                                  **self._cfg, **kwargs)
        elif self.mode == "sp":
            self._trainer = lm_mod.SPLMTrainer(mesh, **self._cfg, **kwargs)
        elif self.mode == "pp":
            self._trainer = lm_mod.PPLMTrainer(mesh, **self._cfg, **kwargs)
        else:
            self._trainer = lm_mod.MoELMTrainer(
                mesh, num_experts=self._num_experts,
                capacity_factor=self._capacity_factor, **self._cfg, **kwargs)
        self._opt_state = self._trainer.init_opt_state(self._params)
        self.optimizer_initialized = True

    def _forward_trainer(self):
        """A trainer for inference, made on demand so ``bind`` +
        ``load_params`` + ``score``/``predict`` work without
        ``init_optimizer``."""
        if self._trainer is None:
            self.init_optimizer()
            self.optimizer_initialized = False  # inference only: no claim
        return self._trainer

    # ---- step ------------------------------------------------------------
    def _tokens_labels(self, data_batch):
        home = self._home()

        def ids(x):
            return _as_tensor(x).to(home, torch.int64)

        tok = ids(data_batch.data[0])
        labels = ids(data_batch.label[0]) if data_batch.label else None
        if self.mode == "pp":
            m = self._microbatches
            b, t = tok.shape
            tok = tok.reshape(m, b // m, t)
            if labels is not None:
                labels = labels.reshape(m, b // m, t)
        return tok, labels

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        train = self.for_training if is_train is None else is_train
        tok, labels = self._tokens_labels(data_batch)
        self._outs = None
        self._staged = (tok, labels if train else None)

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError(
                "ParallelLMModule fuses backward into update(); explicit "
                "out_grads are not supported")

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer first")
        if self._staged is None or self._staged[1] is None:
            raise MXNetError("call forward(train) with labels before update()")
        tok, labels = self._staged
        self._params, self._opt_state, loss = self._trainer.step(
            self._params, self._opt_state, tok, labels)
        self._last_loss = loss
        # update_metric after update() evaluates these tokens (get_outputs)
        self._metric_tokens = tok
        self._staged = None

    @property
    def loss(self):
        """The last step's loss (mean next-token NLL)."""
        return None if self._last_loss is None else float(self._last_loss)

    def get_outputs(self, merge_multi_context=True):
        """Softmax probabilities (B*T, V) of the current batch, with the
        current parameters (after ``update()``, the updated ones)."""
        from .. import ndarray as nd

        if self._outs is None:
            tok = (self._staged[0] if self._staged is not None
                   else self._metric_tokens)
            if tok is None:
                raise MXNetError("call forward first")
            logits = self._forward_trainer().forward(self._params, tok)
            self._outs = torch.softmax(logits.float(), dim=-1).reshape(
                -1, self._cfg["vocab_size"])
        return [nd.NDArray(self._outs)]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.get_outputs())

    def get_params(self):
        """Host (CPU) copies of the parameters: (arg_params, {})."""
        if not self.params_initialized:
            raise MXNetError("initialize the parameters first")
        from .. import ndarray as nd

        return {n: nd.NDArray(a.detach().to("cpu", copy=True))
                for n, a in self._params.items()}, {}

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True):
        if not self.params_initialized:
            self.init_params(arg_params=arg_params, aux_params=aux_params,
                             allow_missing=allow_missing)
            return
        with torch.no_grad():
            for name, arr in (arg_params or {}).items():
                if name in self._params:
                    self._params[name].copy_(_as_tensor(arr))
                elif not allow_missing:
                    raise MXNetError("unknown parameter %s" % name)
        self._outs = None

    def get_input_grads(self, merge_multi_context=True):
        raise MXNetError("ParallelLMModule does not expose input gradients")

    def install_monitor(self, mon):
        raise MXNetError(
            "Monitor is not supported on the fused parallel LM step; train "
            "a dense symbol Module (models/transformer_lm.get_symbol) to "
            "inspect per-node outputs")
