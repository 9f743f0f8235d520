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
generator. ``Deconvolution`` (``conv_transpose``), ``InstanceNorm``,
``L2Normalization``, ``SoftmaxActivation``, ``UpSampling`` (nearest, and
bilinear through the deconvolution) and ``SequenceMask``/``Last``/
``Reverse``.
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


# ---------------------------------------------------------------- Deconvolution
_DECONV_PARAMS = dict(_CONV_PARAMS)
_DECONV_PARAMS.update({"adj": Param.shape(()), "target_shape": Param.shape(())})
_DECONV_FNS = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
               3: F.conv_transpose3d}


def _check_channel_first(attrs):
    if (attrs.get("layout") or "None") not in ("None", "", "NCW", "NCHW",
                                               "NCDHW"):
        raise MXNetError("Deconvolution: only channel-first layouts supported")


def _deconvolve(data, weight, attrs):
    """The transposed convolution of the JAX package's ``Deconvolution``
    (no bias): output length ``(in - 1) * stride - 2 * pad + dilate *
    (kernel - 1) + 1 + adj`` per axis. MXNet's weight layout
    ``(C_in, num_filter / num_group, k...)`` is ``conv_transpose``'s own;
    ``adj`` is its ``output_padding``, which torch takes only below the
    stride or the dilation: past that, the whole transposed convolution
    is cut to the same window (zeros past its end)."""
    nd = len(attrs["kernel"])
    stride, dilate, pad = _conv_tuples(attrs, nd)
    adj = attrs["adj"] or (0,) * nd
    fn = _DECONV_FNS[nd]
    ng = attrs["num_group"]
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return fn(data, weight, None, stride, pad, adj, ng, dilate)
    full = fn(data, weight, None, stride, 0, 0, ng, dilate)
    k = attrs["kernel"]
    lens = [(data.shape[2 + i] - 1) * stride[i] - 2 * pad[i]
            + dilate[i] * (k[i] - 1) + 1 + adj[i] for i in range(nd)]
    extra = [max(0, pad[i] + lens[i] - full.shape[2 + i]) for i in range(nd)]
    full = F.pad(full, [e for x in reversed(extra) for e in (0, x)])
    return full[(slice(None), slice(None))
                + tuple(slice(pad[i], pad[i] + lens[i]) for i in range(nd))]


@register(
    "Deconvolution",
    arg_names=lambda attrs: ["data", "weight"] + ([] if attrs.get("no_bias") else ["bias"]),
    params=_DECONV_PARAMS,
)
def _deconvolution(octx, attrs, args, auxs):
    _check_channel_first(attrs)
    out = _deconvolve(args[0], args[1], attrs)
    if not attrs["no_bias"]:
        out = out + args[2].reshape((1, -1) + (1,) * (out.dim() - 2))
    return [out], []


def _deconv_infer_shape(attrs, in_shapes, aux_shapes):
    # the JAX package's rule, line for line: target_shape is not read
    _check_channel_first(attrs)
    data = in_shapes[0]
    nd = len(attrs["kernel"])
    stride, dilate, pad = _conv_tuples(attrs, nd)
    nf, ng = attrs["num_filter"], attrs["num_group"]
    adj = attrs["adj"] or (0,) * nd
    wshape = (data[1], nf // ng) + tuple(attrs["kernel"])
    spatial = tuple(
        (data[2 + i] - 1) * stride[i] - 2 * pad[i]
        + (dilate[i] * (attrs["kernel"][i] - 1) + 1) + adj[i]
        for i in range(nd))
    out = (data[0], nf) + spatial
    shapes = [tuple(data), wshape] + ([] if attrs["no_bias"] else [(nf,)])
    return shapes, [out], []


get_op("Deconvolution")._infer_shape = _deconv_infer_shape


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


# ---------------------------------------------------------------- InstanceNorm
@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          params={"eps": Param.float(1e-3)})
def _instance_norm(octx, attrs, args, auxs):
    x, gamma, beta = args
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = torch.square(x - mean).mean(dim=red, keepdim=True)   # as jnp.var
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean) * torch.rsqrt(var + attrs["eps"])
    return [out * gamma.reshape(bshape) + beta.reshape(bshape)], []


def _in_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    c = (data[1],)
    return [tuple(data), c, c], [tuple(data)], []


get_op("InstanceNorm")._infer_shape = _in_infer_shape


# ---------------------------------------------------------------- L2Normalization
@register("L2Normalization", arg_names=("data",),
          params={"eps": Param.float(1e-10), "mode": Param.str("instance")})
def _l2_normalization(octx, attrs, args, auxs):
    x = args[0]
    red = {"instance": tuple(range(1, x.dim())), "channel": (1,),
           "spatial": tuple(range(2, x.dim()))}.get(attrs["mode"])
    if red is None:
        raise MXNetError("L2Normalization: unknown mode %s" % attrs["mode"])
    norm = torch.sqrt(torch.square(x).sum(dim=red, keepdim=True) + attrs["eps"])
    return [x / norm], []


# ---------------------------------------------------------------- SoftmaxActivation
@register("SoftmaxActivation", arg_names=("data",),
          params={"mode": Param.str("instance")})
def _softmax_activation(octx, attrs, args, auxs):
    x = args[0]
    if attrs["mode"] == "channel":
        return [torch.softmax(x, dim=1)], []
    return [torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)], []


# ---------------------------------------------------------------- UpSampling
def _nearest(x, s):
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


@register(
    "UpSampling",
    arg_names=lambda attrs: (
        ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))]
        if attrs.get("sample_type") == "nearest" else ["data", "weight"]),
    params={
        "scale": Param.int(),
        "num_filter": Param.int(0),
        "sample_type": Param.str("nearest"),
        "multi_input_mode": Param.str("concat"),
        "num_args": Param.int(1),
        "workspace": Param.int(512),
    },
    key_var_num_args="num_args",
)
def _upsampling(octx, attrs, args, auxs):
    s = attrs["scale"]
    if attrs["sample_type"] == "nearest":
        # the first input scales by ``scale``, the others to its size
        first = _nearest(args[0], s)
        ups = [first] + [_nearest(x, first.shape[2] // x.shape[2])
                         for x in args[1:]]
        if len(ups) == 1:
            return [ups[0]], []
        if attrs["multi_input_mode"] == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return [out], []
        return [torch.cat(ups, dim=1)], []
    # bilinear: a grouped deconvolution with the given weight
    k = 2 * s - s % 2
    p = (k - s) // 2
    nf = attrs["num_filter"]
    dattrs = {"kernel": (k, k), "stride": (s, s), "pad": (p, p),
              "adj": (s % 2, s % 2), "num_group": nf, "dilate": (1, 1)}
    return [_deconvolve(args[0], args[1], dattrs)], []


def _upsampling_infer_shape(attrs, in_shapes, aux_shapes):
    s = attrs["scale"]
    data = in_shapes[0]
    if attrs["sample_type"] == "nearest":
        oh, ow = data[2] * s, data[3] * s
        if len(in_shapes) == 1:
            c = data[1]
        else:
            c = (sum(sh[1] for sh in in_shapes)
                 if attrs["multi_input_mode"] == "concat" else data[1])
        return [tuple(d) for d in in_shapes], [(data[0], c, oh, ow)], []
    k = 2 * s - s % 2
    nf = attrs["num_filter"]
    return ([tuple(data), (data[1], 1, k, k)],
            [(data[0], nf, data[2] * s, data[3] * s)], [])


get_op("UpSampling")._infer_shape = _upsampling_infer_shape


# ---------------------------------------------------------------- Sequence ops
def _seq_args(attrs):
    return ["data", "sequence_length"] if attrs.get("use_sequence_length") else ["data"]


def _lengths(t):
    """Per-sequence lengths as int64, truncated toward zero."""
    return t.detach().to(torch.int32).to(torch.int64)


@register("SequenceMask", arg_names=_seq_args,
          params={"use_sequence_length": Param.bool(False),
                  "value": Param.float(0.0), "axis": Param.int(0)})
def _sequence_mask(octx, attrs, args, auxs):
    x = args[0]
    if not attrs["use_sequence_length"]:
        return [x], []
    ax = attrs["axis"]
    xs = x.transpose(0, ax) if ax != 0 else x
    ar = torch.arange(xs.shape[0], dtype=torch.float32, device=x.device)[:, None]
    mask = (ar < args[1].detach().to(torch.float32)[None, :]).to(xs.dtype)
    mask = mask.reshape(mask.shape + (1,) * (xs.dim() - 2))
    out = xs * mask + attrs["value"] * (1 - mask)
    return [out.transpose(0, ax) if ax != 0 else out], []


def _take_time(xs, idx):
    """``xs[idx[b], b, ...]`` per sequence b: the gather along time of
    ``jnp.take_along_axis`` (a negative index counts from the end)."""
    t = xs.shape[0]
    idx = torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)
    idx = idx.reshape(idx.shape + (1,) * (xs.dim() - idx.dim())).expand(
        idx.shape + xs.shape[idx.dim():])
    return xs.gather(0, idx)


@register("SequenceLast", arg_names=_seq_args,
          params={"use_sequence_length": Param.bool(False), "axis": Param.int(0)})
def _sequence_last(octx, attrs, args, auxs):
    x = args[0]
    ax = attrs["axis"]
    xs = x.transpose(0, ax) if ax != 0 else x
    if attrs["use_sequence_length"]:
        out = _take_time(xs, (_lengths(args[1]) - 1)[None, :])[0]
    else:
        out = xs[-1]
    return [out], []


def _seqlast_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    ax = attrs.get("axis", 0)
    rest = tuple(d for i, d in enumerate(data) if i != ax)
    shapes = [tuple(data)]
    if attrs.get("use_sequence_length"):
        shapes.append((data[1 - ax],))
    return shapes, [rest], []


get_op("SequenceLast")._infer_shape = _seqlast_infer_shape


@register("SequenceReverse", arg_names=_seq_args,
          params={"use_sequence_length": Param.bool(False), "axis": Param.int(0)})
def _sequence_reverse(octx, attrs, args, auxs):
    # time is axis 0 whatever ``axis`` says, as in the JAX package
    x = args[0]
    if not attrs["use_sequence_length"]:
        return [torch.flip(x, (0,))], []
    length = _lengths(args[1])[None, :]
    ar = torch.arange(x.shape[0], device=x.device)[:, None]
    return [_take_time(x, torch.where(ar < length, length - 1 - ar, ar))], []
