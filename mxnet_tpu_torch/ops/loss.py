"""Loss heads of the port (counterpart of ``mxnet_tpu/ops/loss.py``).

The heads' gradients are declared, not derived, each a
``torch.autograd.Function`` where the JAX package uses
``jax.custom_vjp``; the label gets a zero gradient:

* ``SoftmaxOutput`` writes ``(p - onehot(label)) * grad_scale`` (with
  label smoothing, ``use_ignore`` and ``normalization``) and ignores the
  head gradient unless ``out_grad`` is set;
* ``LinearRegressionOutput`` (``out - label``), ``MAERegressionOutput``
  (``sign(out - label)``) and ``LogisticRegressionOutput`` (a sigmoid
  forward, ``out - label``), each times ``grad_scale``, ignore the head
  gradient;
* ``SVMOutput`` writes the hinge (``use_linear``) or squared-hinge
  gradient of ``margin`` and ``regularization_coefficient``;
* ``MakeLoss`` (alias ``make_loss``) writes ``grad_scale``, divided by
  the batch (``normalization='batch'``) or by the count of outputs above
  ``valid_thresh`` (``'valid'``).

All of these are marked as losses, so the executor seeds their head
gradient with ones and ``Module`` may take its fused path with them.
``softmax_cross_entropy`` (the summed negative log-likelihood) is plain
autograd and, as in the JAX package, not marked.
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


def _softmax_grad(p, label, attrs, denom=None):
    """The head's gradient; ``denom``, when given (under a normalization),
    replaces the count it divides by: a data-parallel step's global
    count."""
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
        if denom is not None:
            grad = grad / denom
        elif norm == "batch":
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
        if denom is not None:
            grad = grad / denom
        elif norm == "batch":
            grad = grad / float(p.shape[0])
        elif norm == "valid":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
        grad = grad.reshape(p.shape)
    return grad * scale


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs, denom=None):
        p = _softmax_fwd(data, attrs)
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        ctx.denom = denom
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad = _softmax_grad(p, label, ctx.attrs, ctx.denom)
        if ctx.attrs["out_grad"]:
            grad = grad * g
        return grad, None, None, None


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



# ---------------------------------------------------------------- regression heads
class _Regression(torch.autograd.Function):
    """``link(data)`` forward; backward ``grad(out, label) * scale``."""

    @staticmethod
    def forward(ctx, data, label, link, grad, scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.scale = grad, scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = ctx.grad(out, label.reshape(out.shape)) * ctx.scale
        return grad, torch.zeros_like(label), None, None, None


def _reg_output(name, link, grad):
    @register(name, arg_names=("data", "label"),
              params={"grad_scale": Param.float(1.0)})
    def _fwd(octx, attrs, args, auxs):
        return [_Regression.apply(args[0], args[1], link, grad,
                                  attrs["grad_scale"])], []

    def _infer(attrs, in_shapes, aux_shapes):
        data = in_shapes[0]
        label = tuple(in_shapes[1]) if in_shapes[1] is not None else tuple(data)
        return [tuple(data), label], [tuple(data)], []

    get_op(name)._infer_shape = _infer
    get_op(name).is_loss = True


_reg_output("LinearRegressionOutput", torch.clone, lambda o, l: o - l)
_reg_output("MAERegressionOutput", torch.clone, lambda o, l: torch.sign(o - l))
_reg_output("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l)


# ---------------------------------------------------------------- SVMOutput
class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg, ctx.linear = margin, reg, linear
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        x, label = ctx.saved_tensors
        lab = label.to(torch.int64)
        hot = (lab[:, None] == torch.arange(x.shape[1], device=x.device)).to(x.dtype)
        sgn = 2 * hot - 1            # +1 at the true class, -1 elsewhere
        slack = ctx.margin - sgn * x
        if ctx.linear:
            grad = torch.where(slack > 0, -sgn * ctx.reg, 0.0)
        else:
            grad = torch.where(slack > 0, -2 * slack * sgn * ctx.reg, 0.0)
        return grad.to(x.dtype), torch.zeros_like(label), None, None, None


@register(
    "SVMOutput",
    arg_names=("data", "label"),
    params={
        "margin": Param.float(1.0),
        "regularization_coefficient": Param.float(1.0),
        "use_linear": Param.bool(False),
    },
)
def _svm_output(octx, attrs, args, auxs):
    return [_SVMOutput.apply(args[0], args[1], attrs["margin"],
                             attrs["regularization_coefficient"],
                             attrs["use_linear"])], []


def _svm_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    return [tuple(data), (data[0],)], [tuple(data)], []


get_op("SVMOutput")._infer_shape = _svm_infer
get_op("SVMOutput").is_loss = True


# ---------------------------------------------------------------- MakeLoss
class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attrs, denom=None):
        ctx.save_for_backward(x)
        ctx.attrs = attrs
        ctx.denom = denom
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        attrs = ctx.attrs
        grad = torch.full_like(x, attrs["grad_scale"])
        if ctx.denom is not None:
            grad = grad / ctx.denom
        elif attrs["normalization"] == "batch":
            grad = grad / x.shape[0]
        elif attrs["normalization"] == "valid":
            valid = (x > attrs["valid_thresh"]).to(x.dtype).sum()
            grad = grad / torch.clamp_min(valid, 1.0)
        return grad, None, None


@register(
    "MakeLoss",
    arg_names=("data",),
    params={
        "grad_scale": Param.float(1.0),
        "valid_thresh": Param.float(0.0),
        "normalization": Param.str("null"),
    },
    alias=("make_loss",),
)
def _make_loss(octx, attrs, args, auxs):
    return [_MakeLoss.apply(args[0], attrs)], []


get_op("MakeLoss").is_loss = True


# ---------------------------------------------------------------- cross entropy
@register("softmax_cross_entropy", arg_names=("data", "label"))
def _softmax_cross_entropy(octx, attrs, args, auxs):
    data, label = args
    logp = torch.log_softmax(data, dim=-1)
    lab = label.detach().to(torch.int32).to(torch.int64)
    return [-logp.gather(1, lab[:, None])[:, 0].sum()], []


def _sce_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    return [tuple(data), (data[0],)], [()], []


get_op("softmax_cross_entropy")._infer_shape = _sce_infer
