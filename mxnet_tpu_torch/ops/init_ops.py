"""Array-creation ops of the port (counterpart of
``mxnet_tpu/ops/init_ops.py``; reference: src/operator/tensor/init_op.cc):
``_zeros``, ``_ones``, ``_full`` and the shape-like ``zeros_like``,
``ones_like``.

A creation op has no input, so it makes its output on the device the
graph runs on (``OpContext.device``). MXNet writes 0 for the batch it
does not know yet in a creation shape (``BaseRNNCell.begin_state`` asks
for ``(0, H)``); as in the JAX package that dimension becomes 1 and the
ops downstream broadcast it to the real batch, with the same values and
gradients. ``_arange`` (``start``, ``stop``, ``step``, each value
``repeat`` times) counts in float64 and rounds once to its dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import Param, register, register_simple


def _dtype_or(attrs, default=np.float32):
    dt = attrs.get("dtype")
    return torch_dtype(default if dt is None else dt)


def _shape_0to1(shape):
    """The creation shape with MXNet's unknown-batch 0 made 1."""
    return tuple(1 if s == 0 else s for s in shape)


def _register_creation(name, fill, params):
    @register(name, arg_names=(), params=params)
    def _create(octx, attrs, args, auxs):
        out = torch.full(_shape_0to1(attrs["shape"]), fill(attrs),
                         dtype=_dtype_or(attrs), device=octx.device)
        return [out], []


_register_creation("_zeros", lambda attrs: 0.0,
                   {"shape": Param.shape(()), "dtype": Param.dtype(None)})
_register_creation("_ones", lambda attrs: 1.0,
                   {"shape": Param.shape(()), "dtype": Param.dtype(None)})
_register_creation("_full", lambda attrs: attrs["value"],
                   {"shape": Param.shape(()), "value": Param.float(0.0),
                    "dtype": Param.dtype(None)})

register_simple("zeros_like", lambda attrs, x: torch.zeros_like(x),
                arg_names=("data",))
register_simple("ones_like", lambda attrs, x: torch.ones_like(x),
                arg_names=("data",))



def _arange(octx, attrs, args, auxs):
    start, stop, step = attrs["start"], attrs["stop"], attrs["step"]
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=octx.device).to(_dtype_or(attrs))
    if attrs["repeat"] > 1:
        out = out.repeat_interleave(attrs["repeat"])
    return [out], []


register("_arange", arg_names=(), params={
    "start": Param.float(0.0),
    "stop": Param(lambda v: None if v in (None, "None", "") else float(v), None),
    "step": Param.float(1.0),
    "repeat": Param.int(1),
    "dtype": Param.dtype(None),
})(_arange)
