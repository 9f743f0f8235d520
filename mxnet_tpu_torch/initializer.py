"""Weight initializers of the port (counterpart of
``mxnet_tpu/initializer.py``; reference: python/mxnet/initializer.py).

Dispatch is the JAX package's: an ``InitDesc`` whose attrs carry an
``__init__`` spec (``Variable(init=...)``) is initialized by that
initializer; otherwise the parameter's name suffix picks the rule
(``*_weight`` draws, ``*_bias``/``*_beta`` zero, ``*_gamma`` one, ...).

Random draws come from a ``torch.Generator`` on the CPU: the ``rng``
given to the initializer, else :mod:`.random`'s CPU generator (PyTorch's
default one, seeded by ``mx.random.seed`` and ``torch.manual_seed``
alike). A nested ``__init__`` spec draws from its parent's generator.
The draws match the JAX package's threefry draws in distribution only,
not value for value; drawing on the CPU makes a card run and a CPU run
from one seed start from the same weights.

All of the JAX package's initializers: Zero, One, Constant, Uniform,
Normal, Orthogonal, Xavier, MSRAPrelu, Bilinear (also any parameter
whose name ends in ``upsampling``), the RNN cells' LSTMBias and
FusedRNN, Load (from a dict of arrays, ``arg:``/``aux:`` prefixes
stripped) and Mixed (by regular expression), with
``create``/``register``.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from .base import string_types

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "One", "Zero", "Constant", "InitDesc",
           "Load", "Mixed", "LSTMBias", "FusedRNN", "register", "create"]

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
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
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

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel over the last two axes."""
        weight = np.zeros(arr.shape, dtype="float32").reshape(-1)
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

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
class Load:
    """Values from a dict of arrays (``arg:``/``aux:`` prefixes stripped);
    a name it lacks goes to ``default_init``, or raises."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            value = self.param[name]
            if tuple(value.shape) != tuple(arr.shape):
                raise AssertionError("Parameter %s cannot be initialized from "
                                     "loading. " % name)
            arr[:] = value
        else:
            if self.default_init is None:
                raise AssertionError("Cannot Initialize parameter %s." % name)
            self.default_init(name, arr)


@register
class Mixed:
    """The first initializer whose pattern (``re.match``) fits the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise AssertionError("patterns and initializers must have the "
                                 "same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern." % name)


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
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

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
class Orthogonal(Initializer):
    """An orthogonal (nout, prod(rest)) matrix, scaled: the SVD factor of
    a U(-1, 1) (``rand_type='uniform'``) or N(0, 1) draw that has its
    shape."""

    def __init__(self, scale=1.414, rand_type="uniform", rng=None):
        super().__init__(rng=rng, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._draw("uniform", (nout, nin), -1.0, 1.0)
        else:
            tmp = self._draw("normal", (nout, nin), 0.0, 1.0)
        tmp = tmp.numpy()
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape)


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: Xavier gaussian with
    magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25, rng=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         rng=rng)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for Deconvolution weights)."""

    def _init_weight(self, _, arr):
        self._init_bilinear(_, arr)


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
