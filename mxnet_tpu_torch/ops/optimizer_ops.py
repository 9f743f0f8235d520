"""Optimizer update arithmetic of the port (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``).

Plain functions of torch tensors with the JAX package's arithmetic in
its order: the gradient is rescaled, clipped when ``clip_gradient > 0``
and gets ``wd * weight`` added (``_prep_grad``), then each rule updates.
They return new tensors; the optimizer rebinds its NDArrays to them.
SGD, SGD with momentum, Adam, and RMSProp (``rmsprop_update``,
Tieleman & Hinton; ``rmspropalex_update``, the centered variant of
Graves).

Each is also a registered op of the same name (``mx.nd.sgd_mom_update(w,
g, mom, lr=..., out=w)``): its visible output is the new weight, and its
state arguments are written in place, as the reference declares them
(``FMutateInputs``, src/operator/optimizer_op.cc). The JAX package
returns the states as hidden outputs that its imperative call drops, so
there they stay as they were (``ROADMAP.md`` C7).
"""
from __future__ import annotations

import torch

from .registry import Param, register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"]


def _prep_grad(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new momentum)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new mean, new variance); ``lr`` is the
    bias-corrected step size."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new n)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    return weight - lr * g / torch.sqrt(new_n + epsilon), new_n


def rmspropalex_update(weight, grad, n, gbar, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """Returns (new weight, new n, new g, new delta)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * gbar
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return weight + new_delta, new_n, new_g, new_delta



# ---- the registered ops ------------------------------------------------
_COMMON = {
    "lr": Param.float(),
    "wd": Param.float(0.0),
    "rescale_grad": Param.float(1.0),
    "clip_gradient": Param.float(-1.0),
}


def _register_update(name, fn, states, **params):
    n = len(states)

    @register(name, arg_names=("weight", "grad") + states,
              params=dict(_COMMON, **params), num_outputs=1 + n,
              num_visible_outputs=1,
              mutate_inputs=tuple(range(2, 2 + n)))
    def _update(octx, attrs, args, auxs):
        out = fn(*args, **attrs)
        return list(out) if n else [out], []


_register_update("sgd_update", sgd_update, ())
_register_update("sgd_mom_update", sgd_mom_update, ("mom",),
                 momentum=Param.float(0.0))
_register_update("adam_update", adam_update, ("mean", "var"),
                 beta1=Param.float(0.9), beta2=Param.float(0.999),
                 epsilon=Param.float(1e-8))
_register_update("rmsprop_update", rmsprop_update, ("n",),
                 gamma1=Param.float(0.95), epsilon=Param.float(1e-8))
_register_update("rmspropalex_update", rmspropalex_update, ("n", "g", "delta"),
                 gamma1=Param.float(0.95), gamma2=Param.float(0.9),
                 epsilon=Param.float(1e-8))
