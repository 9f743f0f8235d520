"""Sampling ops of the port (counterpart of ``mxnet_tpu/ops/sample.py``;
reference: src/operator/tensor/sample_op.cc, multisample_op.cc and
sample_multinomial_op).

Every op here is ``stochastic``: it draws from the ``torch.Generator`` in
``OpContext.rng`` (:func:`..random.generator` of the device the graph
runs on) and raises without one: a draw never falls back to another
generator. Attr schemas, names and aliases are the JAX package's, so
symbol JSON is the same byte for byte; the values drawn are not the JAX
package's threefry values. Draws are made in float32 (int64 for
``randint``) and cast to the op's ``dtype``, float32 when it has none
(``randint`` too, as in the JAX package; ``mx.random.randint`` asks for
int32).

:func:`dropout_mask` is the one function through which every dropout
mask of the port is drawn (``Dropout``, the ``RNN`` op between layers):
tests install given masks by replacing it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import Param, get_op, register

__all__ = ["dropout_mask"]


def _rng(octx, name):
    if octx.rng is None:
        raise MXNetError("%s draws random numbers and was given no generator"
                         % name)
    return octx.rng


def dropout_mask(rng, shape, keep, dtype, device):
    """A dropout mask: each element ``1 / keep`` with probability ``keep``,
    else 0 (the JAX package's ``bernoulli(keep) / keep``), in ``dtype``."""
    u = torch.rand(tuple(shape), generator=rng, device=device,
                   dtype=torch.float32)
    return (u < keep).to(dtype) / keep


def _out_dtype(attrs, default=np.float32):
    dt = attrs.get("dtype")
    return torch_dtype(default if dt is None else dt)


def _gamma(rng, alpha):
    """Gamma(alpha, 1) draws, one per element of the float32 tensor
    ``alpha``."""
    return torch._standard_gamma(alpha, generator=rng)


def _neg_binomial(rng, k, p):
    """NB(k, p) as Poisson(Gamma(k) * (1 - p) / p), elementwise."""
    lam = _gamma(rng, k) * ((1 - p) / p)
    return torch.poisson(lam, generator=rng)


def _f32(shape, value, device):
    return torch.full(tuple(shape), float(value), dtype=torch.float32,
                      device=device)


# -------------------------------------------------------- _random_<dist>
# draw(rng, attrs, shape, device) -> float32 (or int64) tensor
_RANDOM = {
    "uniform": (
        {"low": Param.float(0.0), "high": Param.float(1.0)},
        lambda rng, a, s, dev: torch.rand(s, generator=rng, device=dev)
        * (a["high"] - a["low"]) + a["low"],
        ("random_uniform", "uniform")),
    "normal": (
        {"loc": Param.float(0.0), "scale": Param.float(1.0)},
        lambda rng, a, s, dev: a["loc"] + a["scale"]
        * torch.randn(s, generator=rng, device=dev),
        ("random_normal", "normal")),
    "gamma": (
        {"alpha": Param.float(1.0), "beta": Param.float(1.0)},
        lambda rng, a, s, dev: a["beta"] * _gamma(rng, _f32(s, a["alpha"], dev)),
        ("random_gamma",)),
    "exponential": (
        {"lam": Param.float(1.0)},
        lambda rng, a, s, dev: torch.empty(s, device=dev).exponential_(
            1.0, generator=rng) / a["lam"],
        ("random_exponential",)),
    "poisson": (
        {"lam": Param.float(1.0)},
        lambda rng, a, s, dev: torch.poisson(_f32(s, a["lam"], dev),
                                             generator=rng),
        ("random_poisson",)),
    "negative_binomial": (
        {"k": Param.int(1), "p": Param.float(1.0)},
        lambda rng, a, s, dev: _neg_binomial(rng, _f32(s, a["k"], dev),
                                             a["p"]),
        ("random_negative_binomial",)),
    "randint": (
        {"low": Param.float(0.0), "high": Param.float(1.0)},
        lambda rng, a, s, dev: torch.randint(int(a["low"]), int(a["high"]), s,
                                             generator=rng, device=dev),
        ("random_randint",)),
}


def _register_random(dist, params, draw, aliases):
    name = "_random_" + dist

    @register(name, arg_names=(),
              params=dict(params, shape=Param.shape(()), dtype=Param.dtype(None)),
              stochastic=True, alias=aliases)
    def _fwd(octx, attrs, args, auxs):
        shape = tuple(attrs["shape"] or ())
        out = draw(_rng(octx, name), attrs, shape, octx.device)
        return [out.to(_out_dtype(attrs))], []

    get_op(name)._infer_shape = (
        lambda attrs, in_shapes, aux_shapes: ([], [tuple(attrs["shape"] or ())], []))


for _dist, (_params, _draw, _aliases) in _RANDOM.items():
    _register_random(_dist, _params, _draw, _aliases)


# -------------------------------------------------------- _sample_<dist>
# One draw-set per element of the parameter arrays: the output is
# param.shape + shape. draw(rng, params, device) takes the parameters
# broadcast to the output's shape (float32) and draws elementwise.
_SAMPLE = {
    "uniform": (("low", "high"),
                lambda rng, p, dev: p[0] + (p[1] - p[0])
                * torch.rand(p[0].shape, generator=rng, device=dev)),
    "normal": (("mu", "sigma"),
               lambda rng, p, dev: p[0] + p[1]
               * torch.randn(p[0].shape, generator=rng, device=dev)),
    "gamma": (("alpha", "beta"),
              lambda rng, p, dev: p[1] * _gamma(rng, p[0])),
    "exponential": (("lam",),
                    lambda rng, p, dev: torch.empty(p[0].shape, device=dev)
                    .exponential_(1.0, generator=rng) / p[0]),
    "poisson": (("lam",),
                lambda rng, p, dev: torch.poisson(p[0], generator=rng)),
    "negative_binomial": (("k", "p"),
                          lambda rng, p, dev: _neg_binomial(rng, p[0], p[1])),
}


def _register_sample(dist, arg_names, draw):
    name = "_sample_" + dist

    @register(name, arg_names=arg_names,
              params={"shape": Param.shape(()), "dtype": Param.dtype(None)},
              stochastic=True, alias=(name.lstrip("_"),))
    def _fwd(octx, attrs, args, auxs):
        shape = tuple(attrs["shape"] or ())
        pshape = tuple(args[0].shape)
        full = pshape + shape
        params = [a.to(torch.float32).reshape(pshape + (1,) * len(shape))
                  .expand(full).contiguous() for a in args]
        out = draw(_rng(octx, name), params, args[0].device)
        return [out.to(_out_dtype(attrs))], []

    def _infer(attrs, in_shapes, aux_shapes):
        p = next((s for s in in_shapes if s is not None), None)
        if p is None:
            raise MXNetError("%s: parameter shape required" % name)
        out = tuple(p) + tuple(attrs["shape"] or ())
        return [tuple(p)] * len(arg_names), [out], []

    get_op(name)._infer_shape = _infer


for _dist, (_args, _draw) in _SAMPLE.items():
    _register_sample(_dist, _args, _draw)


@register(
    "_sample_multinomial",
    arg_names=("data",),
    params={"shape": Param.shape(()), "get_prob": Param.bool(False),
            "dtype": Param.dtype(None)},
    stochastic=True,
    num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1,
    alias=("sample_multinomial",),
)
def _multinomial(octx, attrs, args, auxs):
    """Class ids drawn from each row of probabilities (the last axis), as
    many as ``shape`` holds per row; with ``get_prob`` also the log
    probability of each draw."""
    probs = args[0]
    shape = tuple(attrs["shape"] or ())
    n = int(np.prod(shape)) if shape else 1
    rows = probs.reshape(-1, probs.shape[-1]).to(torch.float32)
    draw = torch.multinomial(rows, n, replacement=True,
                             generator=_rng(octx, "_sample_multinomial"))
    lead = tuple(probs.shape[:-1])
    outs = [draw.reshape(lead + shape).to(_out_dtype(attrs, np.int32))]
    if attrs["get_prob"]:
        logp = torch.log(torch.clamp_min(rows, 1e-37)).gather(1, draw)
        outs.append(logp.reshape(lead + shape).to(probs.dtype))
    return outs, []


def _multinomial_infer(attrs, in_shapes, aux_shapes):
    p = tuple(in_shapes[0])
    out = p[:-1] + tuple(attrs["shape"] or ())
    return [p], [out] * (2 if attrs["get_prob"] else 1), []


get_op("_sample_multinomial")._infer_shape = _multinomial_infer
