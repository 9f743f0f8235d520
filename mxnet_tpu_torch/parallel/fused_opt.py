"""Optimizer rules of the fused training step (counterpart of
``mxnet_tpu/parallel/fused_opt.py``).

Each rule is the serial ``Optimizer.update`` arithmetic in its order
(:mod:`..ops.optimizer_ops`: rescale, clip, weight decay, then the
rule), applied in place to the step's float32 master weight and its
optimizer slots, so a fused step and the per-index ``Updater`` agree to
float32 rounding — bit for bit where the arithmetic is the same. The
step's learning rate enters as a device scalar written before each step
(:meth:`_Rule.step_lr` folds in what depends on the update count ``t``,
on the host in double precision as the serial Adam does), so a captured
CUDA graph replays with new values; per-parameter multipliers,
``rescale_grad`` and the clip threshold are constants of the run.

SGD (with or without momentum) and Adam are ported; any other optimizer
(a subclass included) raises ``ValueError`` and the Module keeps the
classic path, as the JAX package does with the rules it lacks.
"""
from __future__ import annotations

import math

import torch

from .. import optimizer as _opt
from ..ops import optimizer_ops

__all__ = ["make_rule", "supported", "host_step_values", "mults_for"]


def _prep(rule):
    """(rescale_grad, clip_gradient) as optimizer_ops takes them."""
    return dict(rescale_grad=rule.rescale,
                clip_gradient=rule.clip if rule.clip is not None else -1.0)


class _Rule:
    """One optimizer's fused update: ``apply_`` writes the new weight and
    slots into the given tensors (no gradient is tracked)."""

    nslot = 0

    def init_state(self, shape, device):
        return tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                     for _ in range(self.nslot))

    def step_lr(self, lr, t):
        """The learning rate ``apply_`` takes at update count ``t``."""
        return lr

    def apply_(self, w, g, state, lr, wd):
        raise NotImplementedError

    # the per-index state Optimizer.create_state returns, for a handover
    # to the classic Updater (and back)
    def to_serial(self, state):
        if self.nslot == 0:
            return None
        if self.nslot == 1:
            return state[0]
        return tuple(state)

    def from_serial(self, st):
        if self.nslot == 0:
            return ()
        if self.nslot == 1:
            return (st,)
        return tuple(st)


class _SGDRule(_Rule):
    """optimizer.py SGD via sgd_update / sgd_mom_update."""

    def __init__(self, momentum, rescale, clip):
        self.momentum = momentum
        self.rescale = rescale
        self.clip = clip
        self.nslot = 1 if momentum else 0

    def apply_(self, w, g, state, lr, wd):
        if self.momentum:
            new_w, new_m = optimizer_ops.sgd_mom_update(
                w, g, state[0], lr, momentum=self.momentum, wd=wd,
                **_prep(self))
            state[0].copy_(new_m)
        else:
            new_w = optimizer_ops.sgd_update(w, g, lr, wd=wd, **_prep(self))
        w.copy_(new_w)


class _AdamRule(_Rule):
    """optimizer.py Adam: the bias correction folded into the step size,
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``."""

    nslot = 2

    def __init__(self, beta1, beta2, eps, rescale, clip):
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.rescale = rescale
        self.clip = clip

    def step_lr(self, lr, t):
        # optimizer.py Adam.update's expression, in its order
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return lr * math.sqrt(coef2) / coef1

    def apply_(self, w, g, state, lr, wd):
        mean, var = state
        new_w, new_mean, new_var = optimizer_ops.adam_update(
            w, g, mean, var, lr, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.eps, wd=wd, **_prep(self))
        mean.copy_(new_mean)
        var.copy_(new_var)
        w.copy_(new_w)


def make_rule(optimizer):
    """The fused rule of an Optimizer instance; ``ValueError`` if there is
    none. ``type() is``, not ``isinstance``: a subclass may change the
    math."""
    t = type(optimizer)
    o = optimizer
    if t is _opt.SGD:
        return _SGDRule(o.momentum, o.rescale_grad, o.clip_gradient)
    if t is _opt.Adam:
        return _AdamRule(o.beta1, o.beta2, o.epsilon, o.rescale_grad,
                         o.clip_gradient)
    raise ValueError(
        "optimizer %s is not supported by the fused step (supported: SGD, "
        "Adam); the Module keeps the per-index Updater path" % t.__name__)


def supported(optimizer):
    try:
        make_rule(optimizer)
        return True
    except ValueError:
        return False


def host_step_values(optimizer, param_names):
    """The step's (base lr, t), kept in step with the serial path's
    bookkeeping: every parameter's update count advances by one and ``t``
    is ``num_update`` after the increments (Adam's bias correction). The
    port has no lr scheduler yet (ROADMAP A4), so the lr is
    ``optimizer.lr``."""
    for n in param_names:
        optimizer._update_count(n)
    return float(optimizer.lr), int(optimizer.num_update)


def mults_for(optimizer, param_names):
    """Per-parameter (lr_mult, wd_mult) dicts, resolved as
    ``Optimizer._get_lr``/``_get_wd`` do: the update index's key first,
    then the name."""
    by_name = {}
    for idx, name in optimizer.idx2name.items():
        by_name.setdefault(name, idx)
    lrm, wdm = {}, {}
    for n in param_names:
        idx = by_name.get(n, n)
        lrm[n] = float(optimizer.lr_mult.get(idx, optimizer.lr_mult.get(n, 1.0)))
        wdm[n] = float(optimizer.wd_mult.get(idx, optimizer.wd_mult.get(n, 1.0)))
    return lrm, wdm
