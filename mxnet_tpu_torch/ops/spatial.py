"""Spatial transform ops of the port (counterpart of
``mxnet_tpu/ops/spatial.py``): ``ROIPooling``, ``BilinearSampler``,
``GridGenerator``, ``SpatialTransformer``, ``Correlation`` and
``IdentityAttachKLSparseReg``.

Gathers and masks over torch tensors whose gradients come from
autograd, as the JAX package's come from ``jax.vjp``. The sampler is the
JAX package's ``_bilinear_sample``, not ``F.grid_sample``: a grid
coordinate ``g`` in [-1, 1] maps to pixel ``(g + 1) * (size - 1) / 2``
(corners aligned), and each of the four neighbours outside the image
adds 0 (so a sample within one pixel outside the border fades in). Grid
coordinates come from ``linspace(-1, 1, n)`` counted in float64 and
rounded once. ``_image_wire_normalize`` is the uint8 input wire's
decode (:func:`wire_normalize`, captured inside the fused step's graph).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import Param, get_op, register


# ---------------------------------------------------------------- ROIPooling
@register("ROIPooling", arg_names=("data", "rois"),
          params={"pooled_size": Param.shape(), "spatial_scale": Param.float()})
def _roi_pooling(octx, attrs, args, auxs):
    """Max-pool each roi ``[batch index, x0, y0, x1, y1]`` (image
    coordinates, times ``spatial_scale``, rounded half to even) into a
    ``pooled_size`` grid; an empty bin gives 0."""
    data, rois = args
    _, _, H, W = data.shape
    ph, pw = attrs["pooled_size"]
    scale = attrs["spatial_scale"]
    r = rois.detach()
    img = data[r[:, 0].to(torch.int32).to(torch.int64)]          # (R, C, H, W)
    x0, y0, x1, y1 = (torch.round(r[:, i] * scale) for i in (1, 2, 3, 4))
    bin_h = torch.clamp_min(y1 - y0 + 1, 1.0) / ph
    bin_w = torch.clamp_min(x1 - x0 + 1, 1.0) / pw

    def edges(start, size, n):
        i = torch.arange(n, dtype=torch.float32, device=data.device)
        lo = torch.floor(start[:, None] + i[None] * size[:, None])
        hi = torch.ceil(start[:, None] + (i[None] + 1) * size[:, None])
        return lo, hi                                              # (R, n)

    hs, he = edges(y0, bin_h, ph)
    ws, we = edges(x0, bin_w, pw)
    ys = torch.arange(H, dtype=torch.float32, device=data.device)
    xs = torch.arange(W, dtype=torch.float32, device=data.device)
    ym = (ys >= hs[..., None]) & (ys < he[..., None])              # (R, ph, H)
    xm = (xs >= ws[..., None]) & (xs < we[..., None])              # (R, pw, W)
    m = ym[:, :, None, :, None] & xm[:, None, :, None, :]          # (R, ph, pw, H, W)
    masked = torch.where(m[:, None], img[:, :, None, None],
                         torch.full((), -math.inf, dtype=data.dtype,
                                    device=data.device))
    v = masked.amax(dim=(-2, -1))                                  # (R, C, ph, pw)
    return [torch.where(m.any(dim=(-2, -1))[:, None], v, torch.zeros_like(v))], []


def _roi_infer(attrs, in_shapes, aux_shapes):
    data, rois = in_shapes
    ph, pw = attrs["pooled_size"]
    return [tuple(data), tuple(rois)], [(rois[0], data[1], ph, pw)], []


get_op("ROIPooling")._infer_shape = _roi_infer


# ---------------------------------------------------------- bilinear sampling
def bilinear_sample(img, gx, gy):
    """``img`` (N, C, H, W) sampled at grid coordinates ``gx``, ``gy``
    (N, Ho, Wo) in [-1, 1]: the JAX package's ``_bilinear_sample``."""
    N, C, H, W = img.shape
    x = (gx + 1) * (W - 1) / 2
    y = (gy + 1) * (H - 1) / 2
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    flat = img.reshape(N, C, H * W)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        yi = yy.clamp(0, H - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(N, 1, -1).expand(N, C, -1)
        v = flat.gather(2, idx).reshape(N, C, *xx.shape[1:])
        return torch.where(valid[:, None], v, torch.zeros_like(v))

    return (gather(y0, x0) * (wy0 * wx0)[:, None]
            + gather(y0, x1) * (wy0 * wx1)[:, None]
            + gather(y1, x0) * (wy1 * wx0)[:, None]
            + gather(y1, x1) * (wy1 * wx1)[:, None])


@register("BilinearSampler", arg_names=("data", "grid"), params={})
def _bilinear_sampler(octx, attrs, args, auxs):
    """Grid (N, 2, Ho, Wo) of x; y in [-1, 1]."""
    data, grid = args
    return [bilinear_sample(data, grid[:, 0], grid[:, 1])], []


def _bs_infer(attrs, in_shapes, aux_shapes):
    data, grid = in_shapes
    return [tuple(data), tuple(grid)], [(data[0], data[1], grid[2], grid[3])], []


get_op("BilinearSampler")._infer_shape = _bs_infer


# ---------------------------------------------------------------- GridGenerator
def _linspace(n, x):
    return torch.linspace(-1, 1, n, dtype=torch.float64, device=x.device).to(x.dtype)


def _affine_grid(theta, H, W):
    """(N, 2, H, W) grid of ``theta`` (N, 6) over the target's
    normalized coordinates."""
    gy, gx = torch.meshgrid(_linspace(H, theta), _linspace(W, theta),
                            indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, -1)
    return torch.einsum("nij,jk->nik", theta.reshape(-1, 2, 3),
                        coords).reshape(-1, 2, H, W)


@register("GridGenerator", arg_names=("data",),
          params={"transform_type": Param.str(),
                  "target_shape": Param.shape((0, 0))})
def _grid_generator(octx, attrs, args, auxs):
    """affine: ``data`` (N, 6) -> grid (N, 2, H, W); warp: ``data`` (N, 2,
    H, W) optical flow in pixels -> the identity grid plus the flow,
    normalized."""
    x = args[0]
    if attrs["transform_type"] == "affine":
        return [_affine_grid(x, *attrs["target_shape"])], []
    _, _, H, W = x.shape
    gy, gx = torch.meshgrid(_linspace(H, x), _linspace(W, x), indexing="ij")
    flow_x = x[:, 0] * 2 / max(W - 1, 1)
    flow_y = x[:, 1] * 2 / max(H - 1, 1)
    return [torch.stack([gx[None] + flow_x, gy[None] + flow_y], dim=1)], []


def _gg_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if attrs["transform_type"] == "affine":
        H, W = attrs["target_shape"]
        return [tuple(data)], [(data[0], 2, H, W)], []
    return [tuple(data)], [tuple(data)], []


get_op("GridGenerator")._infer_shape = _gg_infer


# ---------------------------------------------------------- SpatialTransformer
@register(
    "SpatialTransformer",
    arg_names=("data", "loc"),
    params={
        "target_shape": Param.shape((0, 0)),
        "transform_type": Param.str("affine"),
        "sampler_type": Param.str("bilinear"),
        "cudnn_off": Param.bool(False),
    },
)
def _spatial_transformer(octx, attrs, args, auxs):
    data, loc = args
    grid = _affine_grid(loc, *attrs["target_shape"])
    return [bilinear_sample(data, grid[:, 0], grid[:, 1])], []


def _st_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    H, W = attrs["target_shape"]
    return [tuple(data), (data[0], 6)], [(data[0], data[1], H, W)], []


get_op("SpatialTransformer")._infer_shape = _st_infer


# ---------------------------------------------------------------- Correlation
def _corr_geometry(attrs, H, W):
    pad, k, D = attrs["pad_size"], attrs["kernel_size"], attrs["max_displacement"]
    s1, s2 = attrs["stride1"], attrs["stride2"]
    bk = k // 2
    Hp, Wp = H + 2 * pad, W + 2 * pad
    n_disp = 2 * (D // s2) + 1
    out_h = int(math.ceil((Hp - 2 * (bk + D)) / s1))
    out_w = int(math.ceil((Wp - 2 * (bk + D)) / s1))
    return bk, Hp, Wp, n_disp, out_h, out_w


@register(
    "Correlation",
    arg_names=("data1", "data2"),
    params={
        "kernel_size": Param.int(1),
        "max_displacement": Param.int(1),
        "stride1": Param.int(1),
        "stride2": Param.int(1),
        "pad_size": Param.int(0),
        "is_multiply": Param.bool(True),
    },
    num_outputs=3,
    num_visible_outputs=1,
    output_names=("output", "tmp1", "tmp2"),
)
def _correlation(octx, attrs, args, auxs):
    """For each displacement in a (2D+1)^2 window (step ``stride2``), the
    mean over channels and a k x k patch of data1(x) * data2(x + d)
    (``|data1 - data2|`` unless ``is_multiply``); data2 is shifted
    circularly over its padding, as ``jnp.roll``."""
    a, b = args
    _, _, H, W = a.shape
    pad, k, D = attrs["pad_size"], attrs["kernel_size"], attrs["max_displacement"]
    s1, s2 = attrs["stride1"], attrs["stride2"]
    bk, _, _, _, out_h, out_w = _corr_geometry(attrs, H, W)
    ap = F.pad(a, (pad, pad, pad, pad))
    bp = F.pad(b, (pad, pad, pad, pad))
    start = bk + D
    maps = []
    for dy in range(-D, D + 1, s2):
        for dx in range(-D, D + 1, s2):
            shifted = torch.roll(bp, shifts=(-dy, -dx), dims=(2, 3))
            prod = ap * shifted if attrs["is_multiply"] else torch.abs(ap - shifted)
            corr = prod.mean(dim=1)
            if k > 1:
                # the k x k window sum over k^2, zeros past the border
                corr = F.avg_pool2d(corr[:, None], k, stride=1, padding=bk,
                                    count_include_pad=True)[:, 0]
            maps.append(corr[:, start:start + out_h * s1:s1,
                             start:start + out_w * s1:s1])
    out = torch.stack(maps, dim=1)
    return [out, torch.zeros_like(ap), torch.zeros_like(bp)], []


def _corr_infer(attrs, in_shapes, aux_shapes):
    data1 = in_shapes[0]
    N, C, H, W = data1
    _, Hp, Wp, n_disp, out_h, out_w = _corr_geometry(attrs, H, W)
    return ([tuple(data1), tuple(data1)],
            [(N, n_disp * n_disp, out_h, out_w), (N, C, Hp, Wp), (N, C, Hp, Wp)],
            [])


get_op("Correlation")._infer_shape = _corr_infer


# ----------------------------------------------------- KL sparse regularization
class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparsity gradient of the
    moving average."""

    @staticmethod
    def forward(ctx, x, new_mov, rho, penalty):
        ctx.save_for_backward(new_mov)
        ctx.rho, ctx.penalty = rho, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (mov,) = ctx.saved_tensors
        rho = ctx.rho
        kl = ctx.penalty * (-rho / torch.clamp_min(mov, 1e-12)
                            + (1 - rho) / torch.clamp_min(1 - mov, 1e-12))
        return g + kl[None, :], None, None, None


@register(
    "IdentityAttachKLSparseReg",
    arg_names=("data",),
    aux_names=("moving_avg",),
    params={
        "sparseness_target": Param.float(0.1),
        "penalty": Param.float(0.001),
        "momentum": Param.float(0.9),
    },
    alias=("identity_attach_KL_sparse_reg",),
)
def _kl_sparse_reg(octx, attrs, args, auxs):
    """The moving average of the batch's mean activation is an aux state,
    updated on every call (the reference's FMutateInputs)."""
    x = args[0]
    (mov,) = auxs
    mom = attrs["momentum"]
    new_mov = mov * mom + x.detach().mean(dim=0) * (1 - mom)
    return [_KLSparseReg.apply(x, new_mov, attrs["sparseness_target"],
                               attrs["penalty"])], [new_mov]


def _kl_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    return [tuple(data)], [tuple(data)], [(data[1],)]


get_op("IdentityAttachKLSparseReg")._infer_shape = _kl_infer


# --------------------------------------------------- uint8-wire input decode
def _parse_rgb(v):
    """Optional per-channel float tuple: None / '' / 'None' stay None."""
    if v is None or (isinstance(v, str) and v in ("None", "")):
        return None
    if isinstance(v, str):
        v = v.strip("()[] ").split(",")
        v = [x for x in (s.strip() for s in v) if x]
    try:
        return tuple(float(x) for x in v)
    except TypeError:
        return (float(v),)


def wire_normalize(x, mean=None, std=None, layout="NHWC"):
    """Decode a wire-format image batch: cast to float32, subtract the
    per-channel ``mean``, divide by ``std`` (float sequences, or float32
    tensors on ``x``'s device, along the last axis of ``layout``) and
    transpose NHWC to NCHW. Torch ops on ``x``'s device, so a CUDA graph
    that reads a uint8 input buffer captures them (given tensors)."""
    y = x.to(torch.float32)
    if mean is not None:
        y = y - torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    if std is not None:
        y = y / torch.as_tensor(std, dtype=torch.float32, device=x.device)
    if layout == "NHWC" and y.dim() == 4:
        y = y.permute(0, 3, 1, 2).contiguous()
    return y


@register(
    "_image_wire_normalize",
    params={
        "mean": Param(_parse_rgb, None, kind="float tuple or None"),
        "std": Param(_parse_rgb, None, kind="float tuple or None"),
        "layout": Param.str("NHWC"),
    },
    infer_type=lambda attrs, dts: (
        [dts[0] if dts[0] is not None else np.uint8], [np.float32], []),
)
def _image_wire_normalize(octx, attrs, args, auxs):
    """The uint8 wire's decode (``io.WireSpec``): cast to float32,
    subtract the per-channel mean, divide by the std and transpose NHWC
    to NCHW (the reference normalizes in HWC before its own transpose,
    image_aug_default.cc). Differentiable for a float input, so
    ``inputs_need_grad`` reaches through it."""
    return [wire_normalize(args[0], attrs["mean"], attrs["std"],
                           attrs["layout"])], []
