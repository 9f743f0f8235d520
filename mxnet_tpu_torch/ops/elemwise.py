"""Elementwise ops of the port (counterpart of ``mxnet_tpu/ops/elemwise.py``).

Only what the Transformer-LM graph and ``Symbol`` arithmetic build: the
binary elementwise and broadcast families, the scalar family, and
``square``/``sqrt``/``negative``, and ``_copy`` (alias ``identity``,
the first node of ResNet). The rest of the file waits for the
operator-breadth slice (``ROADMAP.md`` A4). Each is one torch expression;
shapes are inferred by running it on ``meta`` tensors.
"""
from __future__ import annotations

import torch

from .registry import Param, register_simple

_BINARY = {
    "elemwise_add": (lambda x, y: x + y, ("_plus", "_Plus")),
    "elemwise_sub": (lambda x, y: x - y, ("_minus", "_Minus", "_sub")),
    "elemwise_mul": (lambda x, y: x * y, ("_mul", "_Mul")),
    "elemwise_div": (lambda x, y: x / y, ("_div", "_Div")),
}
for _name, (_fn, _aliases) in _BINARY.items():
    register_simple(_name, (lambda fn: lambda attrs, x, y: fn(x, y))(_fn),
                    arg_names=("lhs", "rhs"), alias=_aliases)

for _name, _fn in {
    "broadcast_add": lambda x, y: x + y,
    "broadcast_sub": lambda x, y: x - y,
    "broadcast_minus": lambda x, y: x - y,
    "broadcast_plus": lambda x, y: x + y,
    "broadcast_mul": lambda x, y: x * y,
    "broadcast_div": lambda x, y: x / y,
}.items():
    register_simple(_name, (lambda fn: lambda attrs, x, y: fn(x, y))(_fn),
                    arg_names=("lhs", "rhs"))

# the scalar is taken in the input's dtype, as the JAX package casts it
_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, ("_PlusScalar",)),
    "_minus_scalar": (lambda x, s: x - s, ("_MinusScalar",)),
    "_rminus_scalar": (lambda x, s: s - x, ("_RMinusScalar",)),
    "_mul_scalar": (lambda x, s: x * s, ("_MulScalar",)),
    "_div_scalar": (lambda x, s: x / s, ("_DivScalar",)),
    "_rdiv_scalar": (lambda x, s: s / x, ("_RDivScalar",)),
}
for _name, (_fn, _aliases) in _SCALAR.items():
    register_simple(_name,
                    (lambda fn: lambda attrs, x: fn(x, attrs["scalar"]))(_fn),
                    arg_names=("data",), params={"scalar": Param.float()},
                    alias=_aliases)

for _name, _fn in {
    "negative": torch.neg,
    "square": torch.square,
    "sqrt": torch.sqrt,
}.items():
    register_simple(_name, (lambda fn: lambda attrs, x: fn(x))(_fn),
                    arg_names=("data",))

# a copy of its input (the JAX package adds a zero to get one)
register_simple("_copy", lambda attrs, x: x.clone(), arg_names=("data",),
                alias=("identity",))
