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

The rules are the JAX package's: SGD (with or without momentum; ccSGD
under its rule), NAG, Adam, AdaGrad, RMSProp (plain and centered),
AdaDelta and Ftrl. Any other optimizer (SGLD, DCASGD, a subclass) raises
``ValueError`` and the Module keeps the classic path, as the JAX package
does.
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


def _grad(rule, g):
    """The rescaled gradient, clipped when the clip is positive (the rules
    that do not go through optimizer_ops)."""
    g = g * rule.rescale
    if rule.clip is not None and rule.clip > 0:
        g = torch.clamp(g, -rule.clip, rule.clip)
    return g


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


class _NAGRule(_Rule):
    """optimizer.py NAG: the momentum buffer, then the lookahead."""

    def __init__(self, momentum, rescale, clip):
        self.momentum = momentum
        self.rescale = rescale
        self.clip = clip
        self.nslot = 1 if momentum else 0

    def apply_(self, w, g, state, lr, wd):
        g = _grad(self, g)
        if self.momentum:
            m = state[0] * self.momentum
            g = g + wd * w
            m = m + g
            g = g + self.momentum * m
            state[0].copy_(m)
            w.copy_(w + -lr * g)
        else:
            w.copy_(w + -lr * (g + wd * w))


class _AdaGradRule(_Rule):
    """optimizer.py AdaGrad."""

    nslot = 1

    def __init__(self, eps, rescale, clip):
        self.eps = eps
        self.rescale = rescale
        self.clip = clip

    def apply_(self, w, g, state, lr, wd):
        g = _grad(self, g)
        hist = state[0] + g * g
        state[0].copy_(hist)
        w.copy_(w + -lr * (g / torch.sqrt(hist + self.eps) + wd * w))


class _RMSPropRule(_Rule):
    """optimizer.py RMSProp via rmsprop_update / rmspropalex_update, then
    ``clip_weights``. Its serial state is a tuple even with one slot."""

    def __init__(self, gamma1, gamma2, eps, centered, clip_weights, rescale,
                 clip):
        self.gamma1, self.gamma2, self.eps = gamma1, gamma2, eps
        self.centered = centered
        self.clip_weights = clip_weights
        self.rescale = rescale
        self.clip = clip
        self.nslot = 3 if centered else 1

    def apply_(self, w, g, state, lr, wd):
        kw = dict(gamma1=self.gamma1, epsilon=self.eps, wd=wd, **_prep(self))
        if self.centered:
            new_w, *new = optimizer_ops.rmspropalex_update(
                w, g, *state, lr, gamma2=self.gamma2, **kw)
        else:
            new_w, *new = optimizer_ops.rmsprop_update(w, g, state[0], lr, **kw)
        for s, v in zip(state, new):
            s.copy_(v)
        if self.clip_weights:
            new_w = torch.clamp(new_w, -self.clip_weights, self.clip_weights)
        w.copy_(new_w)

    def to_serial(self, state):
        return tuple(state)

    def from_serial(self, st):
        # the JAX package's fused path writes a lone slot bare
        return tuple(st) if isinstance(st, (tuple, list)) else (st,)


class _AdaDeltaRule(_Rule):
    """optimizer.py AdaDelta (no learning rate)."""

    nslot = 2

    def __init__(self, rho, eps, rescale, clip):
        self.rho, self.eps = rho, eps
        self.rescale = rescale
        self.clip = clip

    def apply_(self, w, g, state, lr, wd):
        acc_g, acc_delta = state
        g = _grad(self, g)
        ag = acc_g * self.rho + (1.0 - self.rho) * g * g
        cur = torch.sqrt(acc_delta + self.eps) / torch.sqrt(ag + self.eps) * g
        ad = acc_delta * self.rho + (1.0 - self.rho) * cur * cur
        acc_g.copy_(ag)
        acc_delta.copy_(ad)
        w.copy_(w - cur - wd * w)


class _FtrlRule(_Rule):
    """optimizer.py Ftrl."""

    nslot = 2

    def __init__(self, lamda1, beta, rescale, clip):
        self.lamda1, self.beta = lamda1, beta
        self.rescale = rescale
        self.clip = clip

    def apply_(self, w, g, state, lr, wd):
        z, n = state
        g = _grad(self, g)
        zv = z + (g - (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr * w)
        nv = n + g * g
        z.copy_(zv)
        n.copy_(nv)
        w.copy_((torch.sign(zv) * self.lamda1 - zv)
                / ((self.beta + torch.sqrt(nv)) / lr + wd)
                * (torch.abs(zv) > self.lamda1).to(zv.dtype))


def make_rule(optimizer):
    """The fused rule of an Optimizer instance; ``ValueError`` if there is
    none. ``type() is``, not ``isinstance``: a subclass may change the
    math; ccSGD is the one deliberate alias (declared SGD-identical)."""
    t = type(optimizer)
    o = optimizer
    clip = o.clip_gradient
    if t is _opt.SGD or t is _opt.ccSGD:
        return _SGDRule(o.momentum, o.rescale_grad, clip)
    if t is _opt.NAG:
        return _NAGRule(o.momentum, o.rescale_grad, clip)
    if t is _opt.Adam:
        return _AdamRule(o.beta1, o.beta2, o.epsilon, o.rescale_grad, clip)
    if t is _opt.AdaGrad:
        return _AdaGradRule(o.float_stable_eps, o.rescale_grad, clip)
    if t is _opt.RMSProp:
        return _RMSPropRule(o.gamma1, o.gamma2, o.epsilon, o.centered,
                            o.clip_weights, o.rescale_grad, clip)
    if t is _opt.AdaDelta:
        return _AdaDeltaRule(o.rho, o.epsilon, o.rescale_grad, clip)
    if t is _opt.Ftrl:
        return _FtrlRule(o.lamda1, o.beta, o.rescale_grad, clip)
    raise ValueError(
        "optimizer %s is not supported by the fused step (supported: "
        "SGD/ccSGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl); the Module "
        "keeps the per-index Updater path" % t.__name__)


def supported(optimizer):
    try:
        make_rule(optimizer)
        return True
    except ValueError:
        return False


def host_step_values(optimizer, param_names):
    """The step's (base lr, t), ordered exactly like the serial path
    (``SGD.update``): the lr scheduler sees ``num_update`` BEFORE this
    step's increments, Adam's bias-correction ``t`` is the count AFTER
    them; every parameter's update count advances by one, so schedulers
    and a handover to the serial Updater (a resume) see the same counts.

    One-step boundary skew against the serial Updater (the JAX package's,
    kept): the scheduler is evaluated once per fused step, while the
    serial path evaluates it per parameter as ``num_update`` advances
    within a step; on the step that crosses a boundary the serial path's
    first parameter still gets the old rate and the rest the new one,
    the fused step the old rate for all."""
    if optimizer.lr_scheduler is not None:
        lr = optimizer.lr_scheduler(optimizer.num_update)
    else:
        lr = optimizer.lr
    for n in param_names:
        optimizer._update_count(n)
    return float(lr), int(optimizer.num_update)


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
