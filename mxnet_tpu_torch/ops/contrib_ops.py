"""Contrib ops of the port (counterpart of ``mxnet_tpu/ops/contrib_ops.py``):
the SSD MultiBox family, ``Proposal``, ``CTCLoss``, ``fft``/``ifft``,
``count_sketch`` and ``quantize``/``dequantize``.

Fixed-shape torch ops, written so that a training step holding them is
captured whole into one CUDA graph: nothing reads a value back to the
host, no output's shape depends on data, and no constant is copied from
the host (anchors are built on the device from ``arange`` and Python
scalars). Ties come out as in the JAX package on both devices: argmax
takes the first maximum, sorts are stable, and ``top_k`` is the head of
a stable descending sort (as in ``ops/ordering.py``).

* ``MultiBoxTarget`` does not copy the JAX package's fault C9
  (``ROADMAP.md``): a padded label row (class < 0) claims no anchor in
  the bipartite match. Among valid rows whose best anchor is the same,
  the later row wins, as in the JAX package; the winner comes from an
  (L, A) comparison, since a scatter with repeated indices promises no
  winner on CUDA.
* Greedy NMS (``MultiBoxDetection``, ``Proposal``) sorts by score
  (stable), builds for a block of rows the matrix "row i would suppress
  box j" once, then steps through the rows in order, the batch at once:
  two kernels per row, the values of the JAX package's loop.
* ``CTCLoss`` runs the alpha recursion over T in torch with the JAX
  package's ``logaddexp`` (its gradient ``exp(x - out)``, its -1e30 for
  log 0), so an infeasible alignment gives the same huge finite loss and
  the same gradient; autograd takes the backward.

The detection ops' and ``quantize``'s outputs carry no gradient, as the
JAX package's ``stop_gradient`` gives none.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .ordering import _topk_last
from .registry import Param, get_op, register, register_simple


def _tuple_f(default):
    def _parse(v):
        if isinstance(v, (tuple, list)):
            return tuple(float(x) for x in v)
        s = str(v).strip().strip("()[]")
        if not s:
            return ()
        return tuple(float(t) for t in s.split(",") if t.strip())

    return Param(_parse, default)


def _corners(cx, cy, half):
    """(..., K, 4) boxes [cx - w, cy - h, cx + w, cy + h] for each (w, h)
    of ``half`` (float32 values held as Python floats)."""
    return torch.stack([torch.stack([cx - w, cy - h, cx + w, cy + h], -1)
                        for w, h in half], -2)


# ---------------------------------------------------------------- MultiBoxPrior
@register(
    "_contrib_MultiBoxPrior",
    arg_names=("data",),
    params={
        "sizes": _tuple_f((1.0,)),
        "ratios": _tuple_f((1.0,)),
        "clip": Param.bool(False),
        "steps": _tuple_f((-1.0, -1.0)),
        "offsets": _tuple_f((0.5, 0.5)),
    },
    alias=("MultiBoxPrior",),
)
def _multibox_prior(octx, attrs, args, auxs):
    """Anchors (1, H*W*K, 4): per cell, one box per size at ratio 1 (half
    extents size/2), then one per further ratio r at sizes[0] (half
    extents s0*sqrt(r)/2 and s0/sqrt(r)/2), in float32 as the JAX package
    forms them."""
    x = args[0]
    H, W = x.shape[2], x.shape[3]
    if H < 1 or W < 1:
        raise MXNetError(
            "MultiBoxPrior: input feature map has zero spatial size %dx%d — "
            "the input image is too small for this network's downsampling "
            "(SSD-300 needs ~300px inputs)" % (H, W))
    sizes = np.asarray(attrs["sizes"], np.float32)
    r = np.sqrt(np.asarray(attrs["ratios"], np.float32)[1:])
    half = [(s / 2, s / 2) for s in sizes]
    half += [(sizes[0] * q / 2, sizes[0] / q / 2) for q in r]
    half = [(float(w), float(h)) for w, h in half]
    step_y, step_x = attrs["steps"]
    if step_y <= 0 or step_x <= 0:
        step_y, step_x = 1.0 / H, 1.0 / W
    off_y, off_x = attrs["offsets"]
    f32 = dict(dtype=torch.float32, device=x.device)
    cy = (torch.arange(H, **f32) + off_y) * step_y
    cx = (torch.arange(W, **f32) + off_x) * step_x
    boxes = _corners(cx[None, :].expand(H, W).reshape(-1),
                     cy[:, None].expand(H, W).reshape(-1), half)
    boxes = boxes.reshape(1, -1, 4)
    if attrs["clip"]:
        boxes = boxes.clamp(0.0, 1.0)
    return [boxes], []


def _mbp_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    K = len(attrs["sizes"]) + len(attrs["ratios"]) - 1
    return [tuple(data)], [(1, data[2] * data[3] * K, 4)], []


get_op("_contrib_MultiBoxPrior")._infer_shape = _mbp_infer


# ------------------------------------------------------------- box utilities
def _iou_corner(a, b):
    """IoU between (..., 4) corner boxes a and b (broadcasting)."""
    ix0 = torch.maximum(a[..., 0], b[..., 0])
    iy0 = torch.maximum(a[..., 1], b[..., 1])
    ix1 = torch.minimum(a[..., 2], b[..., 2])
    iy1 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix1 - ix0).clamp_min(0.0) * (iy1 - iy0).clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0.0) * (a[..., 3] - a[..., 1]).clamp_min(0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0.0) * (b[..., 3] - b[..., 1]).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)


def _encode_loc(anchors, gt, variances):
    """Center-form offsets of ``gt`` from ``anchors``, over the variances."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp_min(1e-12)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp_min(1e-12)
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-12)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-12)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    v0, v1, v2, v3 = variances
    return torch.stack([(gcx - acx) / aw / v0, (gcy - acy) / ah / v1,
                        torch.log(gw / aw) / v2, torch.log(gh / ah) / v3], -1)


def _decode_loc(anchors, pred, variances, clip):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    v0, v1, v2, v3 = variances
    cx = pred[..., 0] * v0 * aw + acx
    cy = pred[..., 1] * v1 * ah + acy
    w = torch.exp(pred[..., 2] * v2) * aw / 2
    h = torch.exp(pred[..., 3] * v3) * ah / 2
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], -1)
    return out.clamp(0.0, 1.0) if clip else out


# ---------------------------------------------------------------- MultiBoxTarget
@register(
    "_contrib_MultiBoxTarget",
    arg_names=("anchor", "label", "cls_pred"),
    params={
        "overlap_threshold": Param.float(0.5),
        "ignore_label": Param.float(-1.0),
        "negative_mining_ratio": Param.float(-1.0),
        "negative_mining_thresh": Param.float(0.5),
        "minimum_negative_samples": Param.int(0),
        "variances": _tuple_f((0.1, 0.1, 0.2, 0.2)),
    },
    num_outputs=3,
    output_names=("loc_target", "loc_mask", "cls_target"),
    alias=("MultiBoxTarget",),
)
def _multibox_target(octx, attrs, args, auxs):
    """Anchor matching and target encoding, the batch at once: each valid
    ground-truth row claims its best anchor (the bipartite step; C9:
    padded rows claim none), the other anchors match their best row above
    ``overlap_threshold``; matched anchors get class + 1 and encoded
    offsets, the rest background 0 — or, with hard-negative mining,
    ``ignore_label`` unless among the ``int(ratio * positives)``
    negatives of highest largest non-background logit (stable rank)."""
    anchors = args[0].detach().reshape(-1, 4)     # (A, 4)
    labels = args[1].detach()                     # (N, L, 5), class < 0 = pad
    cls_preds = args[2].detach()                  # (N, C, A)
    A = anchors.shape[0]
    N, L, _ = labels.shape
    dev = anchors.device
    valid = labels[:, :, 0] >= 0                                      # (N, L)
    gt = labels[:, :, 1:5]
    ious = _iou_corner(anchors[None, :, None, :], gt[:, None, :, :])  # (N, A, L)
    ious = torch.where(valid[:, None, :], ious, -1.0)
    # 1) each valid row claims its best anchor; the later row wins a tie
    best_anchor = ious.argmax(dim=1)                                  # (N, L)
    claims = ((best_anchor[:, :, None] == torch.arange(A, device=dev))
              & valid[:, :, None])                                    # (N, L, A)
    rows = torch.arange(L, device=dev)[None, :, None]
    forced = torch.where(claims, rows, -1).amax(dim=1)                # (N, A)
    # 2) threshold matching for the rest
    best_gt = ious.argmax(dim=2)
    best_iou = ious.amax(dim=2)
    matched = torch.where(forced >= 0, forced,
                          torch.where(best_iou > attrs["overlap_threshold"],
                                      best_gt, -1))
    is_pos = matched >= 0
    safe = matched.clamp_min(0)
    cls_t = torch.where(is_pos, labels[:, :, 0].gather(1, safe) + 1.0, 0.0)
    gt_m = gt.gather(1, safe[:, :, None].expand(N, A, 4))
    loc_t = torch.where(is_pos[:, :, None],
                        _encode_loc(anchors, gt_m, attrs["variances"]), 0.0)
    mask = is_pos[:, :, None].expand(N, A, 4).to(torch.float32)
    ratio = attrs["negative_mining_ratio"]
    if ratio > 0:
        num_pos = is_pos.sum(dim=1).to(torch.float32)
        max_neg = (num_pos * ratio).to(torch.int32).clamp_min(
            attrs["minimum_negative_samples"])
        neg_ok = ~is_pos & (best_iou < attrs["negative_mining_thresh"])
        neg_score = torch.where(neg_ok, cls_preds[:, 1:, :].amax(dim=1), -math.inf)
        order = torch.sort(-neg_score, dim=1, stable=True)[1]
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(N, A))
        keep_neg = neg_ok & (rank < max_neg[:, None])
        cls_t = torch.where(is_pos, cls_t,
                            torch.where(keep_neg, 0.0, attrs["ignore_label"]))
    return [loc_t.reshape(N, -1), mask.reshape(N, -1), cls_t], []


def _mbt_infer(attrs, in_shapes, aux_shapes):
    anchor, label, cls_pred = in_shapes
    A = anchor[1]
    N = label[0]
    return (
        [tuple(anchor), tuple(label), tuple(cls_pred)],
        [(N, A * 4), (N, A * 4), (N, A)],
        [],
    )


get_op("_contrib_MultiBoxTarget")._infer_shape = _mbt_infer


# ------------------------------------------------------------ greedy NMS
#: elements of one block of the suppression matrix (rows x N x A); a
#: block of rows is formed at once, so SSD's 400 rows over 8732 anchors
#: at batch 32 take one block (447 MB in float32)
_NMS_BLOCK = 1 << 27


def _nms(boxes, scores, cls_ids, nms_threshold, force_suppress, topk):
    """Greedy NMS over (N, A) score-sorted boxes (stable): for each of the
    first ``topk`` rows i in order, a kept box i suppresses every later
    box j of its class (any class with ``force_suppress``) whose IoU with
    it exceeds the threshold. Boxes of score -inf start suppressed.
    Returns the sorted boxes, scores, classes and the kept mask."""
    N, A = scores.shape
    order = torch.sort(-scores, dim=1, stable=True)[1]
    b = boxes.gather(1, order[:, :, None].expand(N, A, 4))
    s = scores.gather(1, order)
    c = cls_ids.gather(1, order)
    n_iter = A if topk is None or topk <= 0 else min(topk, A)
    keep = (s > -math.inf).to(torch.float32)
    cols = torch.arange(A, device=scores.device)
    block = max(1, min(n_iter, _NMS_BLOCK // max(N * A, 1)))
    for i0 in range(0, n_iter, block):
        i1 = min(i0 + block, n_iter)
        # sup[n, r, j]: row i0 + r would suppress box j
        sup = ((_iou_corner(b[:, i0:i1, None, :], b[:, None, :, :]) > nms_threshold)
               & (cols > cols[i0:i1, None]))
        if not force_suppress:
            sup &= c[:, i0:i1, None] == c[:, None, :]
        sup = sup.to(torch.float32)
        for i in range(i0, i1):
            hit = sup[:, i - i0] * keep[:, i:i + 1]
            keep.addcmul_(keep, hit, value=-1.0)
    return b, s, c, keep > 0


# ------------------------------------------------------------ MultiBoxDetection
@register(
    "_contrib_MultiBoxDetection",
    arg_names=("cls_prob", "loc_pred", "anchor"),
    params={
        "clip": Param.bool(True),
        "threshold": Param.float(0.01),
        "background_id": Param.int(0),
        "nms_threshold": Param.float(0.5),
        "force_suppress": Param.bool(False),
        "variances": _tuple_f((0.1, 0.1, 0.2, 0.2)),
        "nms_topk": Param.int(-1),
    },
    alias=("MultiBoxDetection",),
)
def _multibox_detection(octx, attrs, args, auxs):
    """Decode and per-class greedy NMS → (N, A, 6) rows
    [class_id, score, x0, y0, x1, y1] in score order, -1 in suppressed
    slots."""
    cls_prob, loc_pred, anchors = (a.detach() for a in args)
    N, C, A = cls_prob.shape
    anchors = anchors.reshape(-1, 4)
    bg = attrs["background_id"]
    if C > 1:
        cls_only = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
        ids = cls_only.argmax(dim=1)
        ids = torch.where(ids >= bg, ids + 1, ids)     # skip the background slot
    else:
        cls_only = cls_prob
        ids = cls_only.argmax(dim=1)
    score = cls_only.amax(dim=1)
    boxes = _decode_loc(anchors, loc_pred.reshape(N, A, 4), attrs["variances"],
                        attrs["clip"])
    score = torch.where(score > attrs["threshold"], score, -math.inf)
    b, s, c, keep = _nms(boxes, score, ids, attrs["nms_threshold"],
                         attrs["force_suppress"], attrs["nms_topk"])
    ok = keep & (s > -math.inf)
    cls_col = torch.where(ok, (c - (1 if C > 1 else 0)).to(torch.float32), -1.0)
    out = torch.cat([cls_col[..., None], torch.where(ok, s, -1.0)[..., None],
                     torch.where(ok[..., None], b, -1.0)], dim=-1)
    return [out], []


def _mbd_infer(attrs, in_shapes, aux_shapes):
    N, C, A = in_shapes[0]
    return [tuple(s) for s in in_shapes], [(N, A, 6)], []


get_op("_contrib_MultiBoxDetection")._infer_shape = _mbd_infer


# ---------------------------------------------------------------- Proposal
@register(
    "_contrib_Proposal",
    arg_names=("cls_prob", "bbox_pred", "im_info"),
    params={
        "rpn_pre_nms_top_n": Param.int(6000),
        "rpn_post_nms_top_n": Param.int(300),
        "threshold": Param.float(0.7),
        "rpn_min_size": Param.int(16),
        "scales": _tuple_f((4.0, 8.0, 16.0, 32.0)),
        "ratios": _tuple_f((0.5, 1.0, 2.0)),
        "feature_stride": Param.int(16),
        "output_score": Param.bool(False),
        "iou_loss": Param.bool(False),
    },
    num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
    output_names=lambda attrs: ["output", "score"] if attrs.get("output_score") else ["output"],
)
def _proposal(octx, attrs, args, auxs):
    """RPN proposals: scale x ratio anchors on the feature grid (their
    sizes rounded half to even on the host, as the JAX package rounds
    them with numpy), bbox deltas applied, clipped to the image, boxes
    under ``rpn_min_size`` scored -inf, the pre-NMS top n by foreground
    score, greedy NMS (class-blind), the post-NMS top n as rois
    (batch_idx, x0, y0, x1, y1)."""
    cls_prob, bbox_pred, im_info = (a.detach() for a in args)
    N, twoK, H, W = cls_prob.shape
    K = twoK // 2
    stride = attrs["feature_stride"]
    base = (stride - 1) / 2.0
    size = stride * stride
    half = []
    for r in attrs["ratios"]:
        w0 = np.round(np.sqrt(size / r))
        h0 = np.round(w0 * r)
        half += [(float(np.float32(w0 * s) / 2), float(np.float32(h0 * s) / 2))
                 for s in attrs["scales"]]
    f32 = dict(dtype=torch.float32, device=cls_prob.device)
    sy = torch.arange(H, **f32) * stride + base
    sx = torch.arange(W, **f32) * stride + base
    anchors = _corners(sx[None, :].expand(H, W).reshape(-1),
                       sy[:, None].expand(H, W).reshape(-1), half).reshape(-1, 4)
    fg = cls_prob[:, K:].permute(0, 2, 3, 1).reshape(N, -1)          # (N, H*W*K)
    deltas = bbox_pred.reshape(N, K, 4, H, W).permute(0, 3, 4, 1, 2).reshape(N, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(deltas[..., 2].clamp(-10, 10)) * aw
    h = torch.exp(deltas[..., 3].clamp(-10, 10)) * ah
    zero = torch.zeros((), **f32)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - w / 2, zero), im_w - 1),
        torch.minimum(torch.maximum(cy - h / 2, zero), im_h - 1),
        torch.minimum(torch.maximum(cx + w / 2, zero), im_w - 1),
        torch.minimum(torch.maximum(cy + h / 2, zero), im_h - 1)], -1)
    min_size = attrs["rpn_min_size"] * im_info[:, 2:3]
    keep_size = (((boxes[..., 2] - boxes[..., 0] + 1) >= min_size)
                 & ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size))
    fg = torch.where(keep_size, fg, -math.inf)
    pre_n = min(attrs["rpn_pre_nms_top_n"], fg.shape[1])
    top_s, top_i = _topk_last(fg, pre_n, is_ascend=False)
    top_b = boxes.gather(1, top_i[:, :, None].expand(N, pre_n, 4))
    post_n = attrs["rpn_post_nms_top_n"]
    b, s, _, keep = _nms(top_b, top_s, torch.zeros_like(top_i), attrs["threshold"],
                         True, post_n * 4)
    sel_s, sel_i = _topk_last(torch.where(keep, s, -math.inf),
                                min(post_n, pre_n), is_ascend=False)
    rois = b.gather(1, sel_i[:, :, None].expand(N, sel_i.shape[1], 4))
    pad = post_n - rois.shape[1]
    if pad > 0:
        rois = torch.cat([rois, torch.zeros((N, pad, 4), **f32)], 1)
        sel_s = torch.cat([sel_s, torch.full((N, pad), -math.inf, **f32)], 1)
    batch_idx = torch.arange(N, **f32)[:, None, None].expand(N, post_n, 1)
    outs = [torch.cat([batch_idx, rois], -1).reshape(-1, 5)]
    if attrs["output_score"]:
        outs.append(sel_s.reshape(-1, 1))
    return outs, []


def _proposal_infer(attrs, in_shapes, aux_shapes):
    N = in_shapes[0][0]
    post = attrs["rpn_post_nms_top_n"]
    outs = [(N * post, 5)]
    if attrs.get("output_score"):
        outs.append((N * post, 1))
    return [tuple(s) for s in in_shapes], outs, []


get_op("_contrib_Proposal")._infer_shape = _proposal_infer


# ---------------------------------------------------------------- CTCLoss
def _replace_inf(x):
    return torch.where(x == math.inf, 0.0, x)


class _LogAddExp(torch.autograd.Function):
    """``jax.lax.logaddexp``: its forward (a NaN difference gives the
    sum) and its gradient ``exp(x - out)``, +inf read as 0."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b,
                          torch.maximum(a, b) + torch.log1p(torch.exp(-delta.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _replace_inf(out)
        return (g * torch.exp(_replace_inf(a) - o),
                g * torch.exp(_replace_inf(b) - o))


_NEG = -1e30   # the JAX package's log 0


@register(
    "_contrib_CTCLoss",
    arg_names=("data", "label"),
    params={},
    num_outputs=2,
    num_visible_outputs=1,
    output_names=("output", "grad"),
    alias=("CTCLoss", "_contrib_ctc_loss", "WarpCTC"),
)
def _ctc_loss(octx, attrs, args, auxs):
    """CTC negative log-likelihood (N,) of ``data`` (T, N, C) against
    ``label`` (N, L), 0-padded, blank 0: the alpha recursion in log space
    over T; the second output (``grad``) is zeros."""
    data, label = args
    T, N, C = data.shape
    L = label.shape[1]
    dev = data.device
    lae = _LogAddExp.apply
    logp = torch.log_softmax(data, dim=-1)
    lab = label.detach().to(torch.int64)
    S = 2 * L + 1
    # the extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.stack([torch.zeros_like(lab), lab], -1).reshape(N, 2 * L)
    ext = torch.cat([ext, torch.zeros((N, 1), dtype=torch.int64, device=dev)], 1)
    lab_len = (lab > 0).sum(1)
    ext_len = 2 * lab_len + 1
    # state s may come from s - 2 when ext[s] is a label unlike ext[s - 2]
    can_skip = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                          (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])], 1)
    neg = torch.full((N, 2), _NEG, dtype=logp.dtype, device=dev)
    first = torch.where(lab_len > 0, logp[0].gather(1, ext[:, 1:2])[:, 0], _NEG)
    alpha = torch.cat([logp[0, :, :1], first[:, None],
                       torch.full((N, S - 2), _NEG, dtype=logp.dtype, device=dev)], 1)
    for t in range(1, T):
        shift1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        shift2 = torch.where(can_skip, torch.cat([neg, alpha[:, :-2]], 1), _NEG)
        alpha = lae(lae(alpha, shift1), shift2) + logp[t].gather(1, ext)
    last = alpha.gather(1, (ext_len - 1).clamp_min(0)[:, None])[:, 0]
    prev = alpha.gather(1, (ext_len - 2).clamp_min(0)[:, None])[:, 0]
    return [-lae(last, prev), torch.zeros_like(data)], []


def _ctc_infer(attrs, in_shapes, aux_shapes):
    data, label = in_shapes
    return [tuple(data), tuple(label)], [(data[1],), tuple(data)], []


get_op("_contrib_CTCLoss")._infer_shape = _ctc_infer
get_op("_contrib_CTCLoss").is_loss = True


# ---------------------------------------------------------------- FFT / IFFT
def _fft(attrs, x):
    """Complex64 FFT over the last axis, real and imaginary parts
    interleaved (..., 2n)."""
    f = torch.fft.fft(x.to(torch.complex64), dim=-1)
    return torch.view_as_real(f).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def _ifft(attrs, x):
    """The inverse of interleaved (..., 2n) input: the real part, times n
    (the reference's unnormalized cuFFT)."""
    n = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (n, 2))
    c = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(c, dim=-1).real * n


register_simple(
    "_contrib_fft", _fft, arg_names=("data",),
    params={"compute_size": Param.int(128)}, alias=("fft",),
)
register_simple(
    "_contrib_ifft", _ifft, arg_names=("data",),
    params={"compute_size": Param.int(128)}, alias=("ifft",),
)


# ---------------------------------------------------------------- count_sketch
@register(
    "_contrib_count_sketch",
    arg_names=("data", "h", "s"),
    params={"out_dim": Param.int(), "processing_batch_size": Param.int(32)},
    alias=("count_sketch",),
)
def _count_sketch(octx, attrs, args, auxs):
    """``out[..., h[i]] += s[i] * x[..., i]`` (repeated ``h`` sum; on CUDA
    in no fixed order)."""
    x, h, s = args
    hi = h.detach().reshape(-1).to(torch.int64)
    si = s.detach().reshape(-1)
    out = torch.zeros(x.shape[:-1] + (attrs["out_dim"],), dtype=x.dtype,
                      device=x.device)
    return [out.index_add(-1, hi, x * si)], []


def _cs_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    return [tuple(s) for s in in_shapes], [tuple(data[:-1]) + (attrs["out_dim"],)], []


get_op("_contrib_count_sketch")._infer_shape = _cs_infer


# ---------------------------------------------------------------- quantize
@register(
    "_contrib_quantize",
    arg_names=("data", "min_range", "max_range"),
    params={"out_type": Param.str("uint8")},
    num_outputs=3,
    output_names=("output", "min_range", "max_range"),
    alias=("quantize",),
)
def _quantize(octx, attrs, args, auxs):
    """``round((x - min) * qmax / (max - min))`` (half to even) clipped to
    [0, qmax], as uint8 (qmax 255) or int8 (127); the ranges pass
    through."""
    x, mn, mx = args
    u8 = attrs["out_type"] == "uint8"
    qmax = 255.0 if u8 else 127.0
    span = (mx - mn).clamp_min(1e-12)
    scale = torch.full_like(span, qmax) / span
    q = torch.clamp(torch.round((x - mn) * scale), 0, qmax).detach()
    return [q.to(torch.uint8 if u8 else torch.int8), mn, mx], []


@register(
    "_contrib_dequantize",
    arg_names=("data", "min_range", "max_range"),
    params={"out_type": Param.str("float32")},
    alias=("dequantize",),
)
def _dequantize(octx, attrs, args, auxs):
    q, mn, mx = args
    qmax = 255.0 if q.dtype == torch.uint8 else 127.0
    return [q.to(torch.float32) * (mx - mn) / qmax + mn], []
