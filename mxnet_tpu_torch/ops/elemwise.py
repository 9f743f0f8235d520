"""Elementwise ops of the port (counterpart of ``mxnet_tpu/ops/elemwise.py``).

The binary elementwise and broadcast families (arithmetic, ``power``,
``maximum``/``minimum``, ``hypot``, ``mod`` and the comparisons), the
scalar family, the unary maths and rounding table, ``clip``, ``Cast``,
``add_n``, the gradient-control ops (``BlockGrad``, ``_NoGradient``) and
``smooth_l1``. Each is one torch expression; shapes are inferred by
running it on ``meta`` tensors.

The JAX package's semantics, not torch's defaults:

* comparisons return 0/1 in the input's dtype and no gradient;
* ``mod`` is ``jnp.mod``, the floor-mod with the divisor's sign
  (``torch.remainder``, not ``torch.fmod``);
* ``round`` and ``rint`` round half to even, ``fix`` truncates toward 0;
* ``gamma`` is ``exp(gammaln(x))``, so it loses the sign where
  ``gamma(x) < 0`` (negative x between even and odd integers);
* ``maximum``, ``minimum`` and ``clip`` split the gradient of a tie in
  halves, as ``jnp.maximum`` does (``torch.clamp`` would pass it whole);
* a scalar operand is taken in the input's dtype (an integer input
  truncates it), as the JAX package's ``np.asarray(scalar, x.dtype)``.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import Param, register, register_simple


def _scalar(x, s):
    """The scalar ``s`` in ``x``'s dtype, as a python number."""
    return s if x.is_floating_point() else int(s)


def _full(x, s):
    """A 0-d tensor holding ``s`` in ``x``'s dtype on ``x``'s device (a
    fill, so it is safe inside a captured CUDA graph)."""
    return torch.full((), _scalar(x, s), dtype=x.dtype, device=x.device)


def _cmp(fn):
    return lambda attrs, x, y: fn(x, y).to(x.dtype).detach()


# ---- binary elementwise ------------------------------------------------
_BINARY = {
    "elemwise_add": (lambda x, y: x + y, ("_plus", "_Plus")),
    "elemwise_sub": (lambda x, y: x - y, ("_minus", "_Minus", "_sub")),
    "elemwise_mul": (lambda x, y: x * y, ("_mul", "_Mul")),
    "elemwise_div": (lambda x, y: x / y, ("_div", "_Div")),
    "_power": (torch.pow, ("_Power",)),
    "_maximum": (torch.maximum, ("_Maximum",)),
    "_minimum": (torch.minimum, ("_Minimum",)),
    "_hypot": (torch.hypot, ()),
    "_mod": (torch.remainder, ()),
}
for _name, (_fn, _aliases) in _BINARY.items():
    register_simple(_name, (lambda fn: lambda attrs, x, y: fn(x, y))(_fn),
                    arg_names=("lhs", "rhs"), alias=_aliases)

_LOGIC = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}
for _name, _fn in _LOGIC.items():
    register_simple("_" + _name, _cmp(_fn), arg_names=("lhs", "rhs"))

# ---- broadcast binary ----------------------------------------------------
for _name, _fn in {
    "broadcast_add": lambda x, y: x + y,
    "broadcast_sub": lambda x, y: x - y,
    "broadcast_minus": lambda x, y: x - y,
    "broadcast_plus": lambda x, y: x + y,
    "broadcast_mul": lambda x, y: x * y,
    "broadcast_div": lambda x, y: x / y,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
}.items():
    register_simple(_name, (lambda fn: lambda attrs, x, y: fn(x, y))(_fn),
                    arg_names=("lhs", "rhs"))

for _name, _fn in _LOGIC.items():
    register_simple("broadcast_" + _name, _cmp(_fn), arg_names=("lhs", "rhs"))

# ---- scalar ops -----------------------------------------------------------
_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, ("_PlusScalar",)),
    "_minus_scalar": (lambda x, s: x - s, ("_MinusScalar",)),
    "_rminus_scalar": (lambda x, s: s - x, ("_RMinusScalar",)),
    "_mul_scalar": (lambda x, s: x * s, ("_MulScalar",)),
    "_div_scalar": (lambda x, s: x / s, ("_DivScalar",)),
    "_rdiv_scalar": (lambda x, s: s / x, ("_RDivScalar",)),
    "_power_scalar": (lambda x, s: torch.pow(x, s), ("_PowerScalar",)),
    "_rpower_scalar": (lambda x, s: torch.pow(s, x), ("_RPowerScalar",)),
    "_mod_scalar": (lambda x, s: torch.remainder(x, s), ()),
}
for _name, (_fn, _aliases) in _SCALAR.items():
    register_simple(_name,
                    (lambda fn: lambda attrs, x: fn(x, _scalar(x, attrs["scalar"])))(_fn),
                    arg_names=("data",), params={"scalar": Param.float()},
                    alias=_aliases)

# a 0-d tensor operand: maximum/minimum split a tie's gradient as
# jnp.maximum does, and remainder differentiates in its divisor
for _name, _fn, _aliases in (
        ("_maximum_scalar", torch.maximum, ("_MaximumScalar",)),
        ("_minimum_scalar", torch.minimum, ("_MinimumScalar",)),
        ("_hypot_scalar", torch.hypot, ()),
        ("_rmod_scalar", lambda x, s: torch.remainder(s, x), ())):
    register_simple(_name,
                    (lambda fn: lambda attrs, x: fn(x, _full(x, attrs["scalar"])))(_fn),
                    arg_names=("data",), params={"scalar": Param.float()},
                    alias=_aliases)

# comparisons take the scalar as given (a float against an integer input)
for _name, _fn in _LOGIC.items():
    register_simple("_%s_scalar" % _name,
                    (lambda fn: lambda attrs, x: fn(
                        x, attrs["scalar"]).to(x.dtype).detach())(_fn),
                    arg_names=("data",), params={"scalar": Param.float()})


# ---- unary maths and rounding ------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,          # half to even, as jnp.round
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,            # toward zero, as jnp.fix
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    # exp(gammaln(x)), as the JAX package: |gamma(x)|, the sign lost
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softsign": lambda x: x / (torch.abs(x) + 1),
    "reciprocal": lambda x: 1.0 / x,
    "erf": torch.erf,
    "logical_not": lambda x: (x == 0).to(x.dtype).detach(),
}
for _name, _fn in _UNARY.items():
    register_simple(_name, (lambda fn: lambda attrs, x: fn(x))(_fn),
                    arg_names=("data",))

# ---- copies and gradient control ---------------------------------------
# a copy of its input (the JAX package adds a zero to get one)
register_simple("_copy", lambda attrs, x: x.clone(), arg_names=("data",),
                alias=("identity",))
# the placement pass's copy node: on one device, a copy
register_simple("_CrossDeviceCopy", lambda attrs, x: x.clone(),
                arg_names=("data",))
register_simple("BlockGrad", lambda attrs, x: x.detach(), arg_names=("data",),
                alias=("stop_gradient",))
register_simple("Cast", lambda attrs, x: x.to(torch_dtype(attrs["dtype"])),
                arg_names=("data",), params={"dtype": Param.dtype()},
                alias=("cast",))


def _clip(attrs, x):
    # jnp.clip is minimum(maximum(x, a_min), a_max): a tie splits
    return torch.minimum(torch.maximum(x, _full(x, attrs["a_min"])),
                         _full(x, attrs["a_max"]))


register_simple("clip", _clip, arg_names=("data",),
                params={"a_min": Param.float(), "a_max": Param.float()})


@register(
    "add_n",
    arg_names=lambda attrs: ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))],
    params={"num_args": Param.int(1)},
    key_var_num_args="num_args",
    alias=("ElementWiseSum", "_sum"),
)
def _add_n(octx, attrs, args, auxs):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return [out], []


register_simple("_grad_add", lambda attrs, x, y: x + y, arg_names=("lhs", "rhs"))


def _smooth_l1(attrs, x):
    # 0.5 (sigma x)^2 where |x| < 1/sigma^2, else |x| - 0.5/sigma^2
    sigma = _scalar(x, attrs["scalar"])
    sigma2 = sigma * sigma
    return torch.where(torch.abs(x) < 1.0 / sigma2,
                       0.5 * torch.square(sigma * x),
                       torch.abs(x) - 0.5 / sigma2)


register_simple("smooth_l1", _smooth_l1, arg_names=("data",),
                params={"scalar": Param.float(1.0)})

# lhs passed through; rhs only lends its shape and type (no gradient)
register_simple("_identity_with_attr_like_rhs",
                lambda attrs, lhs, rhs: lhs.clone(), arg_names=("lhs", "rhs"))


@register("_NoGradient", arg_names=())
def _no_gradient(octx, attrs, args, auxs):
    """A zero scalar that carries no gradient."""
    return [torch.zeros((), device=octx.device)], []
