"""Weight initializers of the port (counterpart of
``mxnet_tpu/initializer.py``; reference: python/mxnet/initializer.py).

Dispatch is the JAX package's: an ``InitDesc`` whose attrs carry an
``__init__`` spec (``Variable(init=...)``) is initialized by that
initializer; otherwise the parameter's name suffix picks the rule
(``*_weight`` draws, ``*_bias``/``*_beta`` zero, ``*_gamma`` one, ...).

Random draws come from a ``torch.Generator`` on the CPU: the ``rng``
given to the initializer, else PyTorch's default generator (seeded by
``torch.manual_seed``). A nested ``__init__`` spec draws from its
parent's generator. The draws match the JAX package's threefry draws in
distribution only, not value for value; drawing on the CPU makes a card
run and a CPU run from one seed start from the same weights.

This slice carries Zero, One, Uniform, Normal, Xavier and the RNN
cells' LSTMBias and FusedRNN with ``create``/``register``; Orthogonal,
MSRAPrelu, Bilinear, Constant, Load and Mixed wait for ROADMAP A4.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import string_types

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "One", "Zero",
           "LSTMBias", "FusedRNN", "InitDesc", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer. ``init(desc, arr)`` dispatches on the name suffix.

    ``rng``: the ``torch.Generator`` (on the CPU) random draws come from;
    None means PyTorch's default generator."""

    def __init__(self, rng=None, **kwargs):
        self._kwargs = kwargs
        self.rng = rng

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, string_types):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            klass, kwargs = json.loads(desc.attrs["__init__"])
            sub = create(klass, **kwargs)
            sub.rng = self.rng
            desc.global_init = self
            sub._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _draw(self, kind, shape, a, b):
        """``kind`` 'uniform': U(a, b); 'normal': N(0, 1) * b — float32 on
        the CPU from this initializer's generator."""
        if kind == "uniform":
            x = torch.rand(tuple(shape), generator=self.rng, dtype=torch.float32)
            return x * (b - a) + a
        return torch.randn(tuple(shape), generator=self.rng,
                           dtype=torch.float32) * b

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. " % name
            + "Default initialization is now limited to "
            '"weight", "bias", "gamma" (1.0), and "beta" (0.0).')


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, rng=None):
        super().__init__(rng=rng, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self._draw("uniform", arr.shape, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng=rng, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self._draw("normal", arr.shape, 0.0, self.sigma)


@register
class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s) with s = sqrt(magnitude / factor)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 rng=None):
        super().__init__(rng=rng, rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            arr[:] = self._draw("uniform", shape, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = self._draw("normal", shape, 0.0, scale)
        else:
            raise ValueError("Unknown random type")


@register
class LSTMBias(Initializer):
    """Zero, with ``forget_bias`` in the forget gate's quarter (gate order
    i, f, c, o)."""

    def __init__(self, forget_bias=1.0, rng=None):
        super().__init__(rng=rng, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        num_hidden = int(arr.shape[0] / 4)
        a = np.zeros(arr.shape, dtype="float32")
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a

    # the bias suffix routes here in __call__'s dispatch; same fill
    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The packed parameter vector of the ``RNN`` op
    (:mod:`.ops.rnn_ops`): each weight block drawn by ``init`` (the
    enclosing initializer when None) as a separate ``weight``, each bias
    block zero (LSTM: with the forget bias), in the packing order."""

    def __init__(self, init, num_hidden, num_layers, mode, bidirectional=False,
                 forget_bias=1.0, rng=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(
            rng=rng, init=init.dumps() if init is not None else None,
            num_hidden=num_hidden, num_layers=num_layers, mode=mode,
            bidirectional=bidirectional, forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .context import cpu
        from .ndarray import zeros
        from .ops.rnn_ops import _gates

        init = self._init
        if init is None:
            init = getattr(desc, "global_init", None) or Uniform(0.07)
        if init.rng is None:
            init.rng = self.rng
        H, L = self._num_hidden, self._num_layers
        g = _gates(self._mode)
        d = 2 if self._bidirectional else 1
        total = arr.size
        # the input size from the parameter count:
        # total = d*(g*H*(I+H) + 2*g*H) + (L-1)*d*(g*H*(H*d+H) + 2*g*H)
        rest = total - (L - 1) * d * (g * H * (H * d + H) + 2 * g * H)
        I = rest // (d * g * H) - H - 2
        flat = np.zeros(total, dtype="float32")
        off = 0
        for layer in range(L):
            isz = I if layer == 0 else H * d
            for _ in range(d):
                for shape, is_bias in (((g * H, isz), False), ((g * H, H), False),
                                       ((g * H,), True), ((g * H,), True)):
                    n = int(np.prod(shape))
                    block = zeros(shape, ctx=cpu())
                    if not is_bias:
                        init("weight", block)
                    elif self._mode == "lstm":
                        LSTMBias(self._forget_bias)("bias", block)
                    flat[off:off + n] = block.asnumpy().reshape(-1)
                    off += n
        arr[:] = flat
