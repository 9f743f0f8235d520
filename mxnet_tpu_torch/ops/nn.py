"""Layer ops of the port (counterpart of ``mxnet_tpu/ops/nn.py``).

``FullyConnected``, ``Activation``, ``softmax``/``log_softmax`` (the
decode symbol's head) and what ResNet is built from:
``Convolution``, ``Pooling`` and ``BatchNorm``. Matrix products and
convolutions are torch's (``torch.matmul``, ``F.conv*d``) in full
float32 (TF32 is off in the port for both), as the JAX package leaves
them to XLA at HIGHEST precision; bfloat16 inputs accumulate in float32
on both sides. BatchNorm is written out rather than handed to
``F.batch_norm``: its statistics, moving averages and rounding are the
JAX package's (see :func:`_batch_norm`). Also
``LeakyReLU`` (leaky, elu, prelu, rrelu), ``LRN`` and ``Dropout``, which
draws its mask through :func:`.sample.dropout_mask` from the graph's
generator. Deconvolution, the other normalisations and the sequence ops
wait for ROADMAP A4.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import sample
from .registry import Param, get_op, register, register_simple


@register(
    "FullyConnected",
    arg_names=lambda attrs: ["data", "weight"] + ([] if attrs.get("no_bias") else ["bias"]),
    params={
        "num_hidden": Param.int(),
        "no_bias": Param.bool(False),
        "flatten": Param.bool(True),
    },
)
def _fully_connected(octx, attrs, args, auxs):
    data, weight = args[0], args[1]
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = torch.matmul(x, weight.t())
    if not attrs["no_bias"]:
        out = out + args[2]
    return [out], []


def _fc_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("FullyConnected: data shape required")
    nh = attrs["num_hidden"]
    if attrs["flatten"]:
        in_dim = int(np.prod(data[1:]))
        out = (data[0], nh)
    else:
        in_dim = data[-1]
        out = tuple(data[:-1]) + (nh,)
    shapes = [tuple(data), (nh, in_dim)]
    if not attrs["no_bias"]:
        shapes.append((nh,))
    return shapes, [out], []


get_op("FullyConnected")._infer_shape = _fc_infer_shape

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}


@register("Activation", arg_names=("data",), params={"act_type": Param.str()})
def _activation(octx, attrs, args, auxs):
    fn = _ACTIVATIONS.get(attrs["act_type"])
    if fn is None:
        raise MXNetError("Activation: unknown act_type %s" % attrs["act_type"])
    return [fn(args[0])], []


# ------------------------------------------------------------ softmax family
# Both read ``axis`` only: ``temperature`` is accepted and ignored, as in
# the JAX package.
register_simple(
    "softmax", lambda attrs, x: torch.softmax(x, dim=attrs["axis"]),
    arg_names=("data",),
    params={"axis": Param.int(-1), "temperature": Param.float(1.0)})
register_simple(
    "log_softmax", lambda attrs, x: torch.log_softmax(x, dim=attrs["axis"]),
    arg_names=("data",),
    params={"axis": Param.int(-1), "temperature": Param.float(1.0)})


# ---------------------------------------------------------------- Convolution
_CONV_PARAMS = {
    "kernel": Param.shape(),
    "stride": Param.shape(()),
    "dilate": Param.shape(()),
    "pad": Param.shape(()),
    "num_filter": Param.int(),
    "num_group": Param.int(1),
    "no_bias": Param.bool(False),
    "workspace": Param.int(1024),  # accepted and ignored, as in JAX
    "cudnn_tune": Param.str(""),
    "cudnn_off": Param.bool(False),
    "layout": Param.str("None"),
}

_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_tuples(attrs, nd):
    stride = attrs["stride"] or (1,) * nd
    dilate = attrs["dilate"] or (1,) * nd
    pad = attrs["pad"] or (0,) * nd
    return stride, dilate, pad


def _layout(attrs, nd, op):
    """Channel-first by default, or NHWC (2-d only), as the JAX package
    takes its layout attr; anything else raises."""
    layout = attrs.get("layout") or "None"
    if layout in ("None", ""):
        return "NC" + "DHW"[3 - nd:]
    if layout == "NHWC":
        if nd != 2:
            raise MXNetError("%s: layout=NHWC is 2-d only" % op)
        return "NHWC"
    if layout in ("NCW", "NCHW", "NCDHW"):
        return layout
    raise MXNetError("%s: unsupported layout %s" % (op, layout))


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1)


@register(
    "Convolution",
    arg_names=lambda attrs: ["data", "weight"] + ([] if attrs.get("no_bias") else ["bias"]),
    params=dict(_CONV_PARAMS),
    alias=("Convolution_v1",),
)
def _convolution(octx, attrs, args, auxs):
    """NC(D)HW data with (O, I/groups, k...) weights, or NHWC data with
    OHWI weights (computed channel-first and permuted back)."""
    data, weight = args[0], args[1]
    nd = len(attrs["kernel"])
    stride, dilate, pad = _conv_tuples(attrs, nd)
    nhwc = _layout(attrs, nd, "Convolution") == "NHWC"
    if nhwc:
        data, weight = _to_nchw(data), _to_nchw(weight)
    out = _CONV_FNS[nd](data, weight, None, stride, pad, dilate,
                        attrs["num_group"])
    if not attrs["no_bias"]:
        out = out + args[2].reshape((1, -1) + (1,) * nd)
    return [_to_nhwc(out) if nhwc else out], []


def _conv_out_dim(x, k, s, p, d):
    return (x + 2 * p - (d * (k - 1) + 1)) // s + 1


def _conv_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("Convolution: data shape required")
    nd = len(attrs["kernel"])
    stride, dilate, pad = _conv_tuples(attrs, nd)
    nf, ng = attrs["num_filter"], attrs["num_group"]
    kernel = tuple(attrs["kernel"])
    if _layout(attrs, nd, "Convolution") == "NHWC":
        wshape = (nf,) + kernel + (data[-1] // ng,)
        spatial = tuple(_conv_out_dim(data[1 + i], kernel[i], stride[i],
                                      pad[i], dilate[i]) for i in range(nd))
        out = (data[0],) + spatial + (nf,)
    else:
        wshape = (nf, data[1] // ng) + kernel
        spatial = tuple(_conv_out_dim(data[2 + i], kernel[i], stride[i],
                                      pad[i], dilate[i]) for i in range(nd))
        out = (data[0], nf) + spatial
    shapes = [tuple(data), wshape] + ([] if attrs["no_bias"] else [(nf,)])
    return shapes, [out], []


get_op("Convolution")._infer_shape = _conv_infer_shape


# ---------------------------------------------------------------- Pooling
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_window(attrs, x_spatial):
    """(kernel, stride, [(lo, hi)] pads) of a pooling: ``global_pool``
    spans the input and ignores ``kernel``; the ``full`` convention pads
    the far edge by what a ceil-rounded output needs."""
    nd = len(x_spatial)
    if attrs["global_pool"]:
        return tuple(x_spatial), (1,) * nd, [(0, 0)] * nd
    kernel = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"] or (1,) * nd)
    pad = attrs["pad"] or (0,) * nd
    pads = []
    for i in range(nd):
        extra = 0
        if attrs["pooling_convention"] == "full":
            h = x_spatial[i]
            out_full = -(-(h + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            extra = max(0, (out_full - 1) * stride[i] + kernel[i] - h
                        - 2 * pad[i])
        pads.append((pad[i], pad[i] + extra))
    return kernel, stride, pads


def _pad_spatial(x, pads, value):
    flat = []
    for lo, hi in reversed(pads):   # F.pad lists the last dimension first
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _window_sum(x, kernel, stride):
    """Sum over each window of an unpadded channel-first x (1-d through a
    dummy dimension)."""
    nd = len(kernel)
    if nd == 1:
        return _window_sum(x.unsqueeze(-1), kernel + (1,),
                           stride + (1,)).squeeze(-1)
    return _AVG_POOL[nd](x, kernel, stride, divisor_override=1)


@register(
    "Pooling",
    arg_names=("data",),
    params={
        "kernel": Param.shape(()),
        "pool_type": Param.str("max"),
        "global_pool": Param.bool(False),
        "stride": Param.shape(()),
        "pad": Param.shape(()),
        "pooling_convention": Param.str("valid"),
        "cudnn_off": Param.bool(False),
        "layout": Param.str("None"),
    },
    alias=("Pooling_v1",),
)
def _pooling(octx, attrs, args, auxs):
    """Max pooling pads with -inf; avg pooling divides each window's sum by
    the count of its elements inside the input (padding excluded, as the
    JAX package counts them); sum pooling does not divide."""
    x = args[0]
    nd = x.dim() - 2
    nhwc = _layout(attrs, nd, "Pooling") == "NHWC"
    if nhwc:
        x = _to_nchw(x)
    kernel, stride, pads = _pool_window(attrs, tuple(x.shape[2:]))
    pt = attrs["pool_type"]
    if pt == "max":
        low = (-math.inf if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = _MAX_POOL[nd](_pad_spatial(x, pads, low), kernel, stride)
    elif pt in ("avg", "sum"):
        out = _window_sum(_pad_spatial(x, pads, 0), kernel, stride)
        if pt == "avg":
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / _window_sum(_pad_spatial(ones, pads, 0), kernel,
                                    stride)
    else:
        raise MXNetError("Pooling: unknown pool_type %s" % pt)
    return [_to_nhwc(out) if nhwc else out], []


def _pool_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    nd = len(data) - 2
    nhwc = _layout(attrs, nd, "Pooling") == "NHWC"
    sp0 = 1 if nhwc else 2
    if attrs["global_pool"]:
        out = (((data[0],) + (1,) * nd + (data[-1],)) if nhwc
               else (tuple(data[:2]) + (1,) * nd))
        return [tuple(data)], [out], []
    kernel = attrs["kernel"]
    stride = attrs["stride"] or (1,) * nd
    pad = attrs["pad"] or (0,) * nd
    sp = []
    for i in range(nd):
        span = data[sp0 + i] + 2 * pad[i] - kernel[i]
        if attrs["pooling_convention"] == "full":
            sp.append(-(-span // stride[i]) + 1)
        else:
            sp.append(span // stride[i] + 1)
    out = (((data[0],) + tuple(sp) + (data[-1],)) if nhwc
           else (tuple(data[:2]) + tuple(sp)))
    return [tuple(data)], [out], []


get_op("Pooling")._infer_shape = _pool_infer_shape


# ---------------------------------------------------------------- BatchNorm
@register(
    "BatchNorm",
    arg_names=("data", "gamma", "beta"),
    aux_names=("moving_mean", "moving_var"),
    params={
        "eps": Param.float(1e-3),
        "momentum": Param.float(0.9),
        "fix_gamma": Param.bool(True),
        "use_global_stats": Param.bool(False),
        "output_mean_var": Param.bool(False),
        "axis": Param.int(1),
        "cudnn_off": Param.bool(False),
    },
    num_outputs=3,
    num_visible_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
    output_names=("output", "mean", "var"),
    alias=("BatchNorm_v1",),
)
def _batch_norm(octx, attrs, args, auxs):
    """The JAX package's BatchNorm, not torch's: batch statistics in
    float32 in one pass, ``var = max(E[x^2] - mean^2, 0)`` (biased) with x
    converted to float32 inside each reduction; moving statistics updated
    as ``m * old + (1 - m) * batch`` from stop-gradient statistics (torch's
    momentum is ``1 - m`` and its running variance unbiased);
    ``rsqrt(var + eps)`` in float32, cast to x's dtype, and the output
    formed in x's dtype. ``fix_gamma`` replaces gamma by ones with no
    gradient. Auxiliary states stay float32."""
    x, gamma, beta = args
    mmean, mvar = auxs
    ax = attrs["axis"] % x.dim()
    red = tuple(i for i in range(x.dim()) if i != ax)
    bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.dim()))
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)
    if octx.is_train and not attrs["use_global_stats"]:
        mean = torch.mean(x, dim=red, dtype=torch.float32)
        ex2 = torch.mean(torch.square(x.float()), dim=red)
        var = torch.clamp_min(ex2 - torch.square(mean), 0.0)
        m = attrs["momentum"]
        new_mean = mmean * m + mean.detach() * (1 - m)
        new_var = mvar * m + var.detach() * (1 - m)
    else:
        mean, var = mmean, mvar
        new_mean, new_var = mmean, mvar
    inv = torch.rsqrt(var.reshape(bshape).float() + attrs["eps"]).to(x.dtype)
    out = ((x - mean.reshape(bshape).to(x.dtype)) * inv
           * gamma.reshape(bshape).to(x.dtype)
           + beta.reshape(bshape).to(x.dtype))
    return [out, mean.to(x.dtype), var.to(x.dtype)], [new_mean, new_var]


def _bn_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    c = (data[attrs.get("axis", 1) % len(data)],)
    return [tuple(data), c, c], [tuple(data), c, c], [c, c]


get_op("BatchNorm")._infer_shape = _bn_infer_shape


# ---------------------------------------------------------------- LeakyReLU
@register(
    "LeakyReLU",
    arg_names=lambda attrs: (["data", "gamma"] if attrs.get("act_type") == "prelu"
                             else ["data"]),
    params={
        "act_type": Param.str("leaky"),
        "slope": Param.float(0.25),
        "lower_bound": Param.float(0.125),
        "upper_bound": Param.float(0.334),
    },
    stochastic=lambda attrs: attrs["act_type"] == "rrelu",
)
def _leaky_relu(octx, attrs, args, auxs):
    """``rrelu`` draws one slope per sample in training, U(lower_bound,
    upper_bound), and takes their mean in inference."""
    x = args[0]
    t = attrs["act_type"]
    if t == "leaky":
        out = torch.where(x > 0, x, attrs["slope"] * x)
    elif t == "elu":
        out = torch.where(x > 0, x, attrs["slope"] * (torch.exp(x) - 1))
    elif t == "prelu":
        gamma = (args[1].reshape((1, -1) + (1,) * (x.dim() - 2))
                 if x.dim() > 1 else args[1])
        out = torch.where(x > 0, x, gamma * x)
    elif t == "rrelu":
        lo, hi = attrs["lower_bound"], attrs["upper_bound"]
        if octx.is_train:
            if octx.rng is None:
                raise MXNetError("LeakyReLU(rrelu) draws its slopes in "
                                 "training and was given no generator")
            u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                           generator=octx.rng, device=x.device)
            slope = (u * (hi - lo) + lo).to(x.dtype)
        else:
            slope = (lo + hi) / 2.0
        out = torch.where(x > 0, x, slope * x)
    else:
        raise MXNetError("LeakyReLU: unknown act_type %s" % t)
    return [out], []


def _lrelu_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    shapes = [tuple(data)]
    if attrs.get("act_type") == "prelu":
        shapes.append((data[1],))
    return shapes, [tuple(data)], []


get_op("LeakyReLU")._infer_shape = _lrelu_infer_shape


# ---------------------------------------------------------------- LRN
@register(
    "LRN",
    arg_names=("data",),
    params={
        "alpha": Param.float(1e-4),
        "beta": Param.float(0.75),
        "knorm": Param.float(2.0),
        "nsize": Param.int(),
    },
    num_outputs=2,
    num_visible_outputs=1,
    output_names=("output", "tmp_norm"),
)
def _lrn(octx, attrs, args, auxs):
    """Across-channel normalisation of NCHW data, the JAX package's:
    ``norm = (knorm + alpha / nsize * S) ** -beta`` with S the sum of
    squares over the window of ``nsize`` channels padded by ``nsize // 2``
    zeros on each side (``reduce_window``), output ``x * norm``. An even
    ``nsize`` makes that window's output one channel longer than the data,
    which the JAX package cannot broadcast either: it raises.
    (``F.local_response_norm`` pads an even window unevenly instead.)"""
    x = args[0]
    n = attrs["nsize"]
    if n % 2 == 0:
        raise MXNetError("LRN: nsize %d is even; the window (nsize // 2 "
                         "channels each side) gives C + 1 channels" % n)
    half = n // 2
    # the windowed sum over channels as a 3-d sum pooling of (N, 1, C, H, W)
    ssum = F.avg_pool3d(torch.square(x).unsqueeze(1), (n, 1, 1), stride=1,
                        padding=(half, 0, 0), divisor_override=1).squeeze(1)
    norm = torch.pow(attrs["knorm"] + (attrs["alpha"] / n) * ssum,
                     -attrs["beta"])
    return [x * norm, norm], []


def _lrn_infer_shape(attrs, in_shapes, aux_shapes):
    data = tuple(in_shapes[0])
    if attrs["nsize"] % 2 == 0:
        raise MXNetError("LRN: nsize %d is even; the window (nsize // 2 "
                         "channels each side) gives C + 1 channels"
                         % attrs["nsize"])
    return [data], [data, data], []


get_op("LRN")._infer_shape = _lrn_infer_shape


# ---------------------------------------------------------------- Dropout
@register(
    "Dropout",
    arg_names=("data",),
    params={"p": Param.float(0.5), "mode": Param.str("training")},
    stochastic=True,
    num_outputs=2,
    num_visible_outputs=1,
    output_names=("output", "mask"),
)
def _dropout(octx, attrs, args, auxs):
    """In training (or always, with ``mode='always'``) ``x * mask``, the
    mask drawn by :func:`.sample.dropout_mask` (``1 / (1 - p)`` kept, 0
    dropped), so the gradient is ``grad * mask``; otherwise the identity
    with a mask of ones. Training without a generator raises: the data
    never passes through undropped by accident."""
    x = args[0]
    p = attrs["p"]
    if not (octx.is_train or attrs["mode"] == "always") or p <= 0.0:
        return [x, torch.ones_like(x)], []
    if octx.rng is None:
        raise MXNetError("Dropout draws its mask and was given no generator")
    mask = sample.dropout_mask(octx.rng, x.shape, 1.0 - p, x.dtype, x.device)
    return [x * mask, mask], []


get_op("Dropout")._infer_shape = (
    lambda attrs, in_shapes, aux_shapes: (
        [tuple(in_shapes[0])], [tuple(in_shapes[0])] * 2, []))
