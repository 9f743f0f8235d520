"""NDArray of the port (counterpart of ``mxnet_tpu/ndarray.py``).

An :class:`NDArray` holds one ``torch.Tensor`` on one device (a
:mod:`~.context` ``torch.device``). This slice carries what binding and
training touch: shape, dtype, context, ``asnumpy``, full-slice
assignment, basic slicing, ``copyto``/``as_in_context`` and the
constructors. The imperative op namespace (``nd.dot``, ``nd.exp``, ...)
and ``.params`` file I/O wait for later slices (``ROADMAP.md`` A3/A4).

Writes replace or update the held tensor: an executor, an optimizer and
a module that share one NDArray object all see the newest value.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from . import context as _context
from .base import torch_dtype

__all__ = ["NDArray", "array", "empty", "zeros", "ones"]


def _np_dtype(dtype):
    """The numpy name of a torch dtype (bfloat16 has none: its name)."""
    name = str(dtype).replace("torch.", "")
    return name if name == "bfloat16" else np.dtype(name)


class NDArray:
    """An n-dimensional array on a device context, over one torch tensor."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray holds a torch.Tensor, got %s" % type(data))
        self._data = data

    # ---- buffer access --------------------------------------------------
    @property
    def data(self):
        """The held ``torch.Tensor``."""
        return self._data

    def _set_data(self, value):
        self._data = value

    # ---- basic properties ----------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._data.device

    ctx = context

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)), self.context)

    def __len__(self):
        return self.shape[0]

    # ---- host ----------------------------------------------------------
    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    # ---- conversion / copy ----------------------------------------------
    def copyto(self, other):
        """Copy into another NDArray (keeping its device and dtype) or onto
        a device."""
        if isinstance(other, NDArray):
            other[:] = self
            return other
        if isinstance(other, torch.device):
            return NDArray(self._data.to(other, copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if torch.device(context) == self.context:
            return self
        return self.copyto(torch.device(context))

    # ---- indexing --------------------------------------------------------
    def __getitem__(self, key):
        """A basic slice or integer index: a view of the held tensor."""
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """``a[:] = v`` (or any index) writes ``v`` into the held tensor in
        place, cast to its dtype and moved to its device; a scalar fills."""
        if isinstance(value, NDArray):
            value = value.data
        if isinstance(value, torch.Tensor):
            src = value.detach().to(self._data.device, self._data.dtype)
        elif isinstance(value, (builtins.int, builtins.float, np.generic)):
            src = value
        else:
            arr = np.asarray(value)
            if self._data.dtype == torch.bfloat16:
                arr = arr.astype(np.float32)
            src = torch.as_tensor(arr).to(self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[key] = src


# ---- creation -----------------------------------------------------------
def _device(ctx):
    return _context.resolve(ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from an array-like on ``ctx`` (default: the card).
    numpy arrays keep their dtype except float64, which narrows to
    float32 as in the JAX package; other array-likes become float32."""
    if isinstance(source_array, NDArray):
        src = source_array.asnumpy()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
        dev = _device(ctx)
        if dtype is not None:
            return NDArray(src.to(dev, torch_dtype(dtype), copy=True))
        return NDArray(src.to(dev, copy=True))
    else:
        src = source_array
    if dtype is None:
        if isinstance(src, np.ndarray):
            dtype = src.dtype if src.dtype != np.float64 else np.float32
        else:
            dtype = np.float32
    # torch.tensor copies: the array never shares the caller's memory
    return NDArray(torch.tensor(np.asarray(src, dtype=np.dtype(dtype)),
                                device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _full(shape, value, ctx, dtype):
    if isinstance(shape, int):
        shape = (shape,)
    dt = torch.float32 if dtype is None else torch_dtype(dtype)
    return NDArray(torch.full(tuple(shape), value, dtype=dt, device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _full(shape, 1, ctx, dtype)

