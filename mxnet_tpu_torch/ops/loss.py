"""Loss heads of the port (counterpart of ``mxnet_tpu/ops/loss.py``).

Only ``SoftmaxOutput``. Its gradient is declared, not derived: backward
writes ``(p - onehot(label)) * grad_scale`` (with label smoothing,
``use_ignore`` and ``normalization``) and ignores the head gradient
unless ``out_grad`` is set — a ``torch.autograd.Function`` here, as the
JAX package uses ``jax.custom_vjp``. It is marked as a loss, so the
executor seeds its head gradient with ones. The other heads wait for
ROADMAP A4.
"""
from __future__ import annotations

import torch

from .registry import Param, get_op, register


def _softmax_fwd(data, attrs):
    if attrs["multi_output"]:
        return torch.softmax(data, dim=1)
    if attrs["preserve_shape"]:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(data.shape)


def _minus_onehot(p, lab, dim, on, off=0.0):
    """``p - (onehot(lab) * (1 - s) + s / n)`` along ``dim`` with
    ``on = (1 - s) + s / n`` and ``off = s / n``; a label outside
    ``[0, n)`` has an all-zero one-hot row, as ``jax.nn.one_hot`` gives."""
    n = p.shape[dim]
    idx = lab.clamp(0, n - 1).unsqueeze(dim)
    grad = p - off if off else p.clone()
    hit = torch.where(((lab >= 0) & (lab < n)).unsqueeze(dim),
                      p.gather(dim, idx) - on, grad.gather(dim, idx))
    return grad.scatter(dim, idx, hit)


def _softmax_grad(p, label, attrs):
    scale = attrs["grad_scale"]
    norm = attrs["normalization"]
    ignore = int(attrs["ignore_label"])
    smooth = attrs.get("smooth_alpha", 0.0) or 0.0
    if attrs["multi_output"]:
        lab = label.to(torch.int64)
        grad = _minus_onehot(p, lab, 1, 1.0)
        valid = (lab != ignore).to(p.dtype) if attrs["use_ignore"] \
            else torch.ones(lab.shape, dtype=p.dtype, device=p.device)
        grad = grad * valid.unsqueeze(1)
        if norm == "batch":
            grad = grad / float(p.shape[0])
        elif norm != "null":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
    else:
        flat = p.reshape(p.shape[0], -1)
        nclass = flat.shape[1]
        lab = label.reshape(-1).to(torch.int64)
        if smooth:
            grad = _minus_onehot(flat, lab, 1, (1 - smooth) + smooth / nclass,
                                 smooth / nclass)
        else:
            grad = _minus_onehot(flat, lab, 1, 1.0)
        valid = (lab != ignore).to(p.dtype) if attrs["use_ignore"] \
            else torch.ones(lab.shape, dtype=p.dtype, device=p.device)
        grad = grad * valid[:, None]
        if norm == "batch":
            grad = grad / float(p.shape[0])
        elif norm == "valid":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
        grad = grad.reshape(p.shape)
    return grad * scale


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs):
        p = _softmax_fwd(data, attrs)
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad = _softmax_grad(p, label, ctx.attrs)
        if ctx.attrs["out_grad"]:
            grad = grad * g
        return grad, None, None


_SOFTMAX_PARAMS = {
    "grad_scale": Param.float(1.0),
    "ignore_label": Param.float(-1.0),
    "multi_output": Param.bool(False),
    "use_ignore": Param.bool(False),
    "preserve_shape": Param.bool(False),
    "normalization": Param.str("null"),
    "out_grad": Param.bool(False),
    "smooth_alpha": Param.float(0.0),
}


@register("SoftmaxOutput", arg_names=("data", "label"),
          params=dict(_SOFTMAX_PARAMS), alias=("Softmax",))
def _softmax_output(octx, attrs, args, auxs):
    return [_SoftmaxOutput.apply(args[0], args[1], attrs)], []


def _softmax_output_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if attrs.get("multi_output"):
        label = (data[0],) + tuple(data[2:])
    else:
        label = (data[0],)
    if in_shapes[1] is not None:
        label = tuple(in_shapes[1])
    return [tuple(data), label], [tuple(data)], []


get_op("SoftmaxOutput")._infer_shape = _softmax_output_infer_shape
get_op("SoftmaxOutput").is_loss = True
