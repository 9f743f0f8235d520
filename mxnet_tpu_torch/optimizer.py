"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer.py``;
reference: python/mxnet/optimizer.py).

SGD (with and without momentum) and Adam, with the JAX package's
``lr_mult``/``wd_mult`` resolution (no weight decay on names that end in
neither ``_weight`` nor ``_gamma``), per-index update counts for Adam's
bias correction, and its arithmetic in its order
(:mod:`.ops.optimizer_ops`). The :class:`Updater` keeps per-index state
and applies the update parameter by parameter with plain torch
arithmetic on the parameters' own device; the fused training step
(:mod:`.parallel.fused_opt`) applies the same per-parameter math inside
one step, a CUDA graph on the card. ``Updater.get_states``/``set_states``
are the JAX package's ``.states`` file payload (a pickled ``{index:
numpy state}``), so either package reads the other's. Also NAG, SGLD (its noise drawn by the ``_random_normal`` op from
:mod:`.random`), DCASGD, ccSGD, AdaGrad, RMSProp (plain and centered),
AdaDelta, Ftrl and Test, each in the JAX package's order of operations,
and ``lr_scheduler``: the rate at ``num_update`` before this update's
increment, times the parameter's ``lr_mult``.
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array, zeros
from .ops import optimizer_ops

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "ccSGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Test", "Updater",
           "get_updater", "create", "register"]


class Optimizer:
    """Base optimizer with lr/wd multiplier resolution and the registry."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("WARNING: New optimizer %s is overriding existing optimizer", name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_mult(self, args_lr_mult):
        """``__lr_mult__`` attrs of the symbol, then ``args_lr_mult``."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Defaults: no wd on names that end in neither ``_weight`` nor
        ``_gamma``; then ``__wd_mult__`` attrs, then ``args_wd_mult``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common(self):
        return dict(rescale_grad=self.rescale_grad,
                    clip_gradient=(self.clip_gradient
                                   if self.clip_gradient is not None else -1.0))

    def _grad(self, grad):
        """The rescaled gradient, clipped when ``clip_gradient`` is set
        (the rules that do not go through :mod:`.ops.optimizer_ops`)."""
        g = grad.data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is not 0."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        if state is not None:
            w, m = optimizer_ops.sgd_mom_update(
                weight.data, grad.data, state.data, lr=lr, wd=wd,
                momentum=self.momentum, **self._common())
            weight._set_data(w)
            state._set_data(m)
        else:
            weight._set_data(optimizer_ops.sgd_update(
                weight.data, grad.data, lr=lr, wd=wd, **self._common()))


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size:
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, t counted per index."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),   # mean
                zeros(weight.shape, weight.context, dtype=weight.dtype))   # variance

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr_t = lr * math.sqrt(coef2) / coef1
        mean, var = state
        w, m, v = optimizer_ops.adam_update(
            weight.data, grad.data, mean.data, var.data, lr=lr_t, wd=wd,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
            **self._common())
        weight._set_data(w)
        mean._set_data(m)
        var._set_data(v)


@register
class NAG(SGD):
    """Nesterov accelerated SGD: the momentum buffer, then the lookahead
    ``g + momentum * mom``."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        w = weight.data
        if state is not None:
            mom = state.data * self.momentum
            g = g + wd * w
            mom = mom + g
            g = g + self.momentum * mom
            state._set_data(mom)
            weight._set_data(w + -lr * g)
        else:
            weight._set_data(w + -lr * (g + wd * w))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    N(0, sqrt(lr)) noise from the weight's device generator."""

    def update(self, index, weight, grad, state):
        from .ndarray import random_normal

        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        noise = random_normal(loc=0.0, scale=math.sqrt(lr), shape=weight.shape,
                              ctx=weight.context)
        w = weight.data
        weight._set_data(w + (-lr / 2 * (g + wd * w) + noise.data))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the state is (momentum buffer
    or None, the previous weight). The JAX package tests the buffer's
    truth (``if mon:``), which raises for a buffer of more than one
    element; the port tests ``is not None``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = NDArray(weight.data.clone())
        if self.momentum == 0.0:
            return (None, prev)
        return (zeros(weight.shape, weight.context, dtype=weight.dtype), prev)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        mon, previous_weight = state
        w = weight.data
        step = -lr * (g + wd * w + self.lamda * g * g * (w - previous_weight.data))
        if mon is not None:
            step = mon.data * self.momentum + step
            mon._set_data(step)
        previous_weight._set_data(w.clone())
        weight._set_data(w + step)


@register
class ccSGD(SGD):
    """SGD under its legacy name (the reference keeps it for old
    scripts)."""


@register
class AdaGrad(Optimizer):
    """AdaGrad: the squared gradients summed in the state."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        history = state.data + g * g
        state._set_data(history)
        w = weight.data
        weight._set_data(w + -lr * (g / torch.sqrt(history + self.float_stable_eps)
                                    + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman & Hinton), or with ``centered`` the variant of
    Graves; ``clip_weights`` clips the weight after the update."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(zeros(weight.shape, weight.context) for _ in range(n))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kw = dict(lr=lr, wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                  **self._common())
        if not self.centered:
            w, n = optimizer_ops.rmsprop_update(weight.data, grad.data,
                                                state[0].data, **kw)
            new = (n,)
        else:
            w, *new = optimizer_ops.rmspropalex_update(
                weight.data, grad.data, *(s.data for s in state),
                gamma2=self.gamma2, **kw)
        for s, v in zip(state, new):
            s._set_data(v)
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        weight._set_data(w)


@register
class AdaDelta(Optimizer):
    """AdaDelta: running averages of squared gradients and of squared
    updates; no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),   # accumulated g
                zeros(weight.shape, weight.context))   # accumulated delta

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        acc_g, acc_delta = state
        ag = acc_g.data * self.rho + (1.0 - self.rho) * g * g
        cur = (torch.sqrt(acc_delta.data + self.epsilon)
               / torch.sqrt(ag + self.epsilon) * g)
        ad = acc_delta.data * self.rho + (1.0 - self.rho) * cur * cur
        acc_g._set_data(ag)
        acc_delta._set_data(ad)
        w = weight.data
        weight._set_data(w - cur - wd * w)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (FTRL-proximal): the state is (z,
    n); the weight is recomputed from them, 0 where ``|z| <= lamda1``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),   # z
                zeros(weight.shape, weight.context))   # n

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._grad(grad)
        z, n = state
        w = weight.data
        zv = z.data + (g - (torch.sqrt(n.data + g * g) - torch.sqrt(n.data))
                       / lr * w)
        nv = n.data + g * g
        z._set_data(zv)
        n._set_data(nv)
        weight._set_data((torch.sign(zv) * self.lamda1 - zv)
                         / ((self.beta + torch.sqrt(nv)) / lr + wd)
                         * (torch.abs(zv) > self.lamda1).to(zv.dtype))


@register
class Test(Optimizer):
    """Adds the rescaled gradient and keeps the new weight as its state
    (the reference's kvstore test optimizer)."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        w = weight.data + grad.data * self.rescale_grad
        weight._set_data(w)
        state._set_data(w.clone())


class Updater:
    """Weight updater with per-index optimizer state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._on_host = set()   # indices whose states set_states left on the host

    def __call__(self, index, grad, weight):
        if not isinstance(weight, NDArray) or not isinstance(grad, NDArray):
            raise TypeError("Updater takes NDArray weights and gradients")
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif index in self._on_host:
            self.states[index] = _as_in(self.states[index], weight.context)
            self._on_host.discard(index)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_all(self, pairs):
        """``pairs``: (index, grad, weight) triples, updated in order."""
        for index, g, w in pairs:
            self(index, g, w)

    def get_states(self):
        """The states as the JAX package pickles them: ``{index: numpy
        state}`` (a tuple of arrays for Adam, None for plain SGD)."""
        return pickle.dumps({k: _to_np(v) for k, v in self.states.items()})

    def set_states(self, states):
        """Adopt :meth:`get_states` bytes of either package. The states
        are host NDArrays until their parameter's next update moves them
        to its device."""
        self.states = {k: _from_np(v) for k, v in pickle.loads(states).items()}
        self._on_host = set(self.states)

    def check_state_shapes(self, shapes_by_index, source=None):
        """Raise :class:`MXNetError`, and forget the states, when a state
        does not fit the weight its index updates (a ``.states`` file of
        another model)."""
        bad = []
        for idx, state in self.states.items():
            expected = shapes_by_index.get(idx)
            if expected is None:
                bad.append("index %s not among the %d bound parameters"
                           % (idx, len(shapes_by_index)))
                continue
            for shape in _leaf_shapes(state):
                if shape != tuple(expected):
                    bad.append("index %s: state shape %s != weight shape %s"
                               % (idx, shape, tuple(expected)))
        if bad:
            self.states = {}
            raise MXNetError(
                "optimizer states%s do not match this model (%s) — was the "
                "model edited between runs? Discarding them for a warm start."
                % (" from %r" % source if source else "",
                   "; ".join(bad[:4]) + ("; ..." if len(bad) > 4 else "")))


def _leaf_shapes(state):
    if isinstance(state, NDArray):
        return [tuple(state.shape)]
    if isinstance(state, (tuple, list)):
        return [s for part in state for s in _leaf_shapes(part)]
    return []


def _to_np(state):
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_np(i) for i in state)
    return state


def _as_in(state, ctx):
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (tuple, list)):
        return type(state)(_as_in(i, ctx) for i in state)
    return state


def _from_np(state):
    if isinstance(state, np.ndarray):
        return array(state, ctx=cpu())
    if isinstance(state, (tuple, list)):
        return type(state)(_from_np(i) for i in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
