"""The port's contrib ops against the JAX package on crafted cases: the
MultiBox family (duplicate best anchors, padded label rows, equal
negative scores, boxes exactly at the NMS threshold), ``Proposal``
(boxes under ``rpn_min_size``, whose -inf scores tie), ``CTCLoss`` (an
infeasible alignment), ``fft``/``ifft``, ``count_sketch`` (repeated
buckets) and ``quantize``/``dequantize`` (.5 ties).

Tolerances: classes, masks, kept sets and quantized values exact;
boxes, scores and encodings within 1e-5; the CTC loss within 1e-5 of
the largest and its gradient within 1e-4 of the largest. C9
(``ROADMAP.md``): where padded label rows follow a valid row whose best
anchor is anchor 0, the JAX package drops that row's match and the port
keeps it.
"""
import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T

TOL = 1e-5
CTC_GRAD_TOL = 1e-4


def _f(a):
    return np.asarray(a, np.float32)


def _run(mx, op, inputs, **attrs):
    out = getattr(mx.nd, op)(*[mx.nd.array(a, ctx=mx.cpu(), dtype=a.dtype)
                               for a in inputs], **attrs)
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _both(op, inputs, **attrs):
    return _run(T, op, inputs, **attrs), _run(J, op, inputs, **attrs)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------ MultiBoxTarget
C9_ANCHORS = _f([[[0, 0, .6, .6], [.5, .5, 1, 1], [.2, .7, .5, 1]]])
C9_VALID = [1, 0, 0, .3, .3]      # IoU 0.36 with anchor 0: under the 0.5 threshold
C9_PAD = [-1, -1, -1, -1, -1]


def _target(mx, anchors, labels, preds=None, **attrs):
    preds = np.zeros((labels.shape[0], 3, anchors.shape[1]), np.float32) \
        if preds is None else preds
    return _run(mx, "_contrib_MultiBoxTarget", [anchors, labels, preds], **attrs)


def test_c9_padded_rows_claim_no_anchor():
    """C9: the valid row, then a padded one. The JAX package lets the
    padded row (IoUs all -1, argmax anchor 0) overwrite the valid row's
    forced match of anchor 0; the port matches it."""
    lab = _f([[C9_VALID, C9_PAD]])
    t_loc, t_mask, t_cls = _target(T, C9_ANCHORS, lab)
    j_loc, j_mask, j_cls = _target(J, C9_ANCHORS, lab)
    np.testing.assert_array_equal(t_cls, [[2, 0, 0]])
    np.testing.assert_array_equal(j_cls, [[0, 0, 0]])
    np.testing.assert_array_equal(t_mask, [[1, 1, 1, 1] + [0] * 8])
    np.testing.assert_array_equal(j_mask, np.zeros((1, 12)))
    # with the rows swapped the JAX package matches too, and both agree
    swapped = _f([[C9_PAD, C9_VALID]])
    t, j = _target(T, C9_ANCHORS, swapped), _target(J, C9_ANCHORS, swapped)
    np.testing.assert_array_equal(t[2], [[2, 0, 0]])
    for a, b in zip(t, j):
        _close(a, b)
    np.testing.assert_array_equal(t_loc, t[0])


def test_duplicate_best_anchor_later_row_wins():
    """Two valid rows whose best anchor is the same: the later row takes
    it (both packages), and the earlier one, under the threshold
    elsewhere, stays unmatched (C10, as the JAX package does)."""
    anchors = _f([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]])
    lab = _f([[[3, 0, 0, .4, .4], [5, .05, .05, .5, .5], C9_PAD]])
    t, j = _target(T, anchors, lab), _target(J, anchors, lab)
    np.testing.assert_array_equal(t[2], [[6, 0, 0]])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[1], j[1])
    _close(t[0], j[0])


def test_mining_ranks_equal_negatives_by_index():
    """Hard-negative mining among equal scores keeps the lower anchor
    indices (a stable rank), and int(ratio * positives) truncates."""
    r = np.random.RandomState(0)
    xy = r.uniform(0, 0.8, (40, 2))
    anchors = _f(np.concatenate([xy, xy + 0.15], 1))[None]
    lab = _f([[[0] + list(anchors[0, 7]), [1] + list(anchors[0, 21]), C9_PAD]])
    preds = np.zeros((1, 3, 40), np.float32)
    preds[0, 1, ::3] = 1.0           # equal logits on every third anchor
    for ratio in (1.5, 3.0, 2.7):
        t = _target(T, anchors, lab, preds, negative_mining_ratio=ratio)
        j = _target(J, anchors, lab, preds, negative_mining_ratio=ratio)
        np.testing.assert_array_equal(t[2], j[2])
        np.testing.assert_array_equal(t[1], j[1])
        _close(t[0], j[0])
        assert (t[2] == 0).sum() == int(np.float32(ratio) * (t[2] > 0).sum())


def test_target_random_batch_matches_jax():
    r = np.random.RandomState(1)
    xy = r.uniform(0, 0.7, (2, 60, 2))
    anchors = _f(np.concatenate([xy[0], xy[0] + r.uniform(0.1, 0.3, (60, 2))], 1))[None]
    lab = -np.ones((4, 5, 5), np.float32)
    for i in range(4):
        for k in range(i + 1 if i < 4 else 1):
            a = anchors[0, r.randint(1, 60)]
            lab[i, k] = [r.randint(0, 3)] + list(a + r.uniform(-0.03, 0.03, 4))
    preds = _f(r.standard_normal((4, 4, 60)))
    for attrs in ({}, {"negative_mining_ratio": 3.0, "minimum_negative_samples": 2},
                  {"overlap_threshold": 0.3, "negative_mining_ratio": 2.0,
                   "negative_mining_thresh": 0.4, "ignore_label": -2.0,
                   "variances": (0.2, 0.2, 0.1, 0.1)}):
        t = _target(T, anchors, _f(lab), preds, **attrs)
        j = _target(J, anchors, _f(lab), preds, **attrs)
        np.testing.assert_array_equal(t[2], j[2])
        np.testing.assert_array_equal(t[1], j[1])
        _close(t[0], j[0])


# ------------------------------------------------------------ MultiBoxDetection
def _detect(mx, cls_prob, anchors, **attrs):
    loc = np.zeros((cls_prob.shape[0], anchors.shape[1] * 4), np.float32)
    return _run(mx, "_contrib_MultiBoxDetection", [cls_prob, loc, anchors], **attrs)[0]


def test_nms_boxes_exactly_at_the_threshold():
    """Zero offsets decode to the anchors exactly. IoU(0, 1) is exactly
    0.5 (kept: suppression needs more than the threshold), IoU(0, 2) is
    0.5625 (suppressed unless the classes differ), and anchor 3 is only
    suppressed by class-blind NMS."""
    anchors = _f([[[0, 0, .5, .5], [0, 0, .5, .25], [0, 0, .5, .375],
                   [.125, 0, .625, .5]]])
    prob = np.zeros((1, 3, 4), np.float32)
    prob[0, 1] = [.9, .8, .7, .05]
    prob[0, 2] = [.05, .1, .2, .6]
    prob[0, 0] = 1 - prob[0, 1] - prob[0, 2]
    for attrs in ({}, {"force_suppress": True}, {"nms_topk": 1},
                  {"threshold": 0.65}, {"background_id": 2}):
        t = _detect(T, prob, anchors, nms_threshold=0.5, **attrs)
        j = _detect(J, prob, anchors, nms_threshold=0.5, **attrs)
        np.testing.assert_array_equal(t[..., 0], j[..., 0])   # classes, kept set
        _close(t, j)
    kept = _detect(T, prob, anchors, nms_threshold=0.5)[0]
    assert kept[kept[:, 0] >= 0][:, 1].tolist() == pytest.approx([.9, .8, .6])


def test_detection_random_batch_matches_jax():
    r = np.random.RandomState(2)
    xy = r.uniform(0, 0.7, (300, 2))
    anchors = _f(np.concatenate([xy, xy + r.uniform(0.1, 0.3, (300, 2))], 1))[None]
    logits = r.standard_normal((3, 5, 300))
    prob = _f(np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    loc = _f(0.5 * r.standard_normal((3, 1200)))
    for attrs in ({}, {"nms_topk": 40, "nms_threshold": 0.3},
                  {"force_suppress": True, "clip": False, "threshold": 0.3,
                   "variances": (0.2, 0.2, 0.3, 0.3)}):
        t, j = _both("_contrib_MultiBoxDetection", [prob, loc, anchors], **attrs)
        np.testing.assert_array_equal(t[0][..., 0], j[0][..., 0])
        _close(t[0], j[0])


def test_prior_matches_jax():
    x = np.zeros((1, 2, 7, 5), np.float32)
    for attrs in ({"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5, 3, 1.0 / 3)},
                  {"sizes": (0.7,), "ratios": (1, 2), "clip": True,
                   "steps": (0.1, 0.3), "offsets": (0.2, 0.7)}):
        t, j = _both("_contrib_MultiBoxPrior", [x], **attrs)
        np.testing.assert_array_equal(t[0], j[0])


def test_prior_of_an_empty_feature_map_raises():
    with pytest.raises(T.base.MXNetError, match="zero spatial size"):
        _run(T, "_contrib_MultiBoxPrior", [np.zeros((1, 2, 0, 3), np.float32)])


# ---------------------------------------------------------------- Proposal
def test_proposal_min_size_ties_match_jax():
    """Most boxes fall under rpn_min_size: their -inf scores tie, and the
    top-k and the final pick take them lower index first."""
    r = np.random.RandomState(3)
    cls = _f(r.uniform(0, 1, (2, 12, 5, 5)))      # 2 scales x 3 ratios
    bbox = _f(0.3 * r.standard_normal((2, 24, 5, 5)))
    info = _f([[40, 40, 1.0], [36, 30, 1.5]])
    for attrs in ({"rpn_min_size": 12, "rpn_post_nms_top_n": 20, "rpn_pre_nms_top_n": 50},
                  {"rpn_min_size": 30, "rpn_post_nms_top_n": 80, "rpn_pre_nms_top_n": 60,
                   "output_score": True, "threshold": 0.4}):
        t, j = _both("_contrib_Proposal", [cls, bbox, info], scales=(2, 4),
                     ratios=(0.5, 1, 2), feature_stride=8, **attrs)
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close(a, b)


# ---------------------------------------------------------------- CTCLoss
def _ctc(mx, data, label):
    sym = mx.sym.CTCLoss(mx.sym.Variable("data"), mx.sym.Variable("label"))
    exe = sym.simple_bind(ctx=mx.cpu(), data=data.shape, label=label.shape,
                          grad_req={"data": "write", "label": "null"})
    exe.arg_dict["data"][:] = data
    exe.arg_dict["label"][:] = label
    loss = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return loss, exe.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("T_len,label", [
    (8, [[1, 2, 0], [3, 3, 1], [2, 0, 0]]),      # padding, a repeat, one label
    (2, [[1, 2, 0], [3, 3, 1], [0, 0, 0]]),      # infeasible (T too short), empty
])
def test_ctc_loss_and_gradient_match_jax(T_len, label):
    r = np.random.RandomState(4)
    data = _f(r.standard_normal((T_len, 3, 5)))
    label = _f(label)
    t_loss, t_grad = _ctc(T, data, label)
    j_loss, j_grad = _ctc(J, data, label)
    assert np.isfinite(t_loss).all()
    np.testing.assert_allclose(t_loss, j_loss, rtol=TOL)
    err = np.abs(t_grad - j_grad).max() / np.abs(j_grad).max()
    assert err <= CTC_GRAD_TOL, err
    if T_len == 2:
        assert t_loss[1] > 1e29          # the -1e30 of an infeasible path


def test_ctc_aliases_share_the_op():
    data = _f(np.random.RandomState(5).standard_normal((4, 2, 3)))
    label = _f([[1, 2], [2, 0]])
    ref = _run(T, "_contrib_CTCLoss", [data, label])[0]
    for name in ("CTCLoss", "_contrib_ctc_loss", "WarpCTC"):
        np.testing.assert_array_equal(_run(T, name, [data, label])[0], ref)


# ------------------------------------------------------- fft, sketch, quantize
@pytest.mark.parametrize("shape", [(3, 8), (2, 3, 5)])
def test_fft_ifft_match_jax(shape):
    x = _f(np.random.RandomState(6).standard_normal(shape))
    t, j = _both("_contrib_fft", [x])
    _close(t[0], j[0], 1e-5)
    t, j = _both("_contrib_ifft", [t[0]])
    _close(t[0], j[0], 1e-5)
    np.testing.assert_allclose(t[0], x * shape[-1], rtol=1e-4, atol=1e-4)


def test_count_sketch_repeated_buckets_match_jax():
    r = np.random.RandomState(7)
    x = _f(r.standard_normal((4, 10)))
    h = _f([[0, 3, 3, 1, 0, 3, 2, 2, 0, 3]])
    s = _f([[1, -1, 1, 1, -1, 1, -1, 1, 1, -1]])
    t, j = _both("_contrib_count_sketch", [x, h, s], out_dim=5)
    _close(t[0], j[0])


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_half_to_even_matches_jax(out_type):
    # (x - min) * scale lands on k + 0.5 for these: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    qmax = 255.0 if out_type == "uint8" else 127.0
    x = _f(np.array([0.5, 1.5, 2.5, 3.25, -4.0, 300.0]) / qmax)
    mn, mx = _f([0.0]), _f([1.0])
    t, j = _both("_contrib_quantize", [x, mn, mx], out_type=out_type)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t[0][:3].tolist() == [0, 2, 2]
    d_t, d_j = _both("_contrib_dequantize", [t[0], mn, mx])
    _close(d_t[0], d_j[0])
