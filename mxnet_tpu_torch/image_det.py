"""Box-aware detection augmenters of the port (counterpart of
``mxnet_tpu/image_det.py``) — the SSD training pipeline (reference:
src/io/image_det_aug_default.cc DefaultImageDetAugmenter: crop samplers
with IoU/coverage constraints :460-477 + TryCrop :287-352, pad :480-489 +
TryPad :356-363, mirror :366-371, force/shrink/fit final resize :615-660;
param table :95-165).

Everything is numpy (host-side, per image) and plugs into
``ImageDetRecordIter``'s decode workers the way ``Augmenter.apply_np``
does for classification, except that a detection augmenter transforms
``(image, boxes)`` together and draws from the ``random.Random`` it is
handed (each decode worker's own, seeded).

Boxes are float32 rows ``[id, x0, y0, x1, y1, *extra]`` with corner
coordinates normalized to [0, 1]; rows with ``id < 0`` are padding and are
never produced here (padding happens at batch assembly). The crop
sampler enforces each constraint on its own (the JAX package's reading of
the reference's parameter docs, see :class:`DetRandomCropAug`).
"""
from __future__ import annotations

import random as pyrandom

import numpy as np

from .base import MXNetError
from .image import imresize_np

__all__ = [
    "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
    "DetRandomPadAug", "DetRandomCropAug", "DetForceResizeAug",
    "DetResizeShorterAug", "CreateDetAugmenter",
]


class DetAugmenter:
    """Base: ``apply_np(image_hwc, boxes, rng=random) -> (image_hwc,
    boxes)``. ``rng`` is a ``random.Random``-like source; the record-iter
    workers pass per-thread instances seeded from the iterator's ``seed``
    so single-threaded decode is fully reproducible (with >1 thread the
    per-thread streams are deterministic but record→thread assignment is
    not — same property as the reference's OMP decode pool)."""

    def apply_np(self, arr, boxes, rng=pyrandom):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a geometry-free classification augmenter (color jitter,
    normalize, cast): the image transforms, the boxes pass through
    (reference: the HSL/contrast block of Process, :517-548)."""

    def __init__(self, aug):
        self.aug = aug

    def apply_np(self, arr, boxes, rng=pyrandom):
        return self.aug.apply_np(arr), boxes


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes together (reference: TryMirror :366-371)."""

    def __init__(self, p=0.5):
        self.p = p

    def apply_np(self, arr, boxes, rng=pyrandom):
        if rng.random() < self.p:
            arr = arr[:, ::-1]
            if boxes.shape[0]:
                boxes = boxes.copy()
                x0 = boxes[:, 1].copy()
                boxes[:, 1] = 1.0 - boxes[:, 3]
                boxes[:, 3] = 1.0 - x0
        return arr, boxes


def _project(boxes, rect):
    """Re-express boxes in the coordinate frame of ``rect`` = (x, y, w, h)
    (normalized), clipping to [0, 1] (reference: ImageDetObject.Project)."""
    x, y, w, h = rect
    out = boxes.copy()
    out[:, 1] = np.maximum(0.0, (boxes[:, 1] - x) / w)
    out[:, 2] = np.maximum(0.0, (boxes[:, 2] - y) / h)
    out[:, 3] = np.minimum(1.0, (boxes[:, 3] - x) / w)
    out[:, 4] = np.minimum(1.0, (boxes[:, 4] - y) / h)
    return out


def _intersect_area(rect, boxes):
    x, y, w, h = rect
    ix = (np.minimum(x + w, boxes[:, 3]) - np.maximum(x, boxes[:, 1]))
    iy = (np.minimum(y + h, boxes[:, 4]) - np.maximum(y, boxes[:, 2]))
    return np.maximum(ix, 0.0) * np.maximum(iy, 0.0)


class DetRandomPadAug(DetAugmenter):
    """Expand the canvas by up to ``max_pad_scale`` with ``fill_value``
    and shift the boxes in (reference: GeneratePadBox :480-489 + the pad
    block of Process :560-576; the reference skips scales < 1.05)."""

    def __init__(self, p, max_pad_scale, fill_value=127, skip_thresh=1.05):
        self.p = p
        self.max_pad_scale = float(max_pad_scale)
        self.fill_value = fill_value
        self.skip_thresh = skip_thresh

    def apply_np(self, arr, boxes, rng=pyrandom):
        if self.max_pad_scale <= 1.0 or rng.random() >= self.p:
            return arr, boxes
        scale = rng.uniform(1.0, self.max_pad_scale)
        if scale < self.skip_thresh:
            return arr, boxes
        x0 = rng.uniform(0.0, scale - 1.0)
        y0 = rng.uniform(0.0, scale - 1.0)
        h, w = arr.shape[:2]
        top = int(y0 * h)
        left = int(x0 * w)
        nh, nw = int(scale * h), int(scale * w)
        canvas = np.full((nh, nw, arr.shape[2]), self.fill_value,
                         dtype=arr.dtype)
        canvas[top : top + h, left : left + w] = arr
        if boxes.shape[0]:
            boxes = _project(boxes, (-x0, -y0, scale, scale))
        return canvas, boxes


class DetRandomCropAug(DetAugmenter):
    """SSD-style constrained random crop: per-image, shuffle the samplers,
    draw crop boxes until one satisfies the sampler's IoU / sample-coverage
    / object-coverage constraints against at least one ground-truth box,
    then keep the objects the emit mode retains (``center``: centroid
    inside the crop; ``overlap``: gt coverage > ``emit_overlap_thresh``)
    and re-project them (reference: GenerateCropBox :460-477, TryCrop
    :287-352, sampler loop :579-612).

    Deviation from the reference, documented: the reference's TryCrop only
    enforces the constraints when *every* min is > 0 AND every max is < 1
    simultaneously (:303-306) — with the stock SSD sampler settings
    (max_* left at 1.0) that makes every crop box valid and only the emit
    mode filters. Here each constraint is enforced independently whenever
    it is restrictive (min > 0 or max < 1), which is the SSD paper's
    sampler and what the reference's parameter docs describe.
    """

    def __init__(self, p, min_scales, max_scales, min_aspect_ratios,
                 max_aspect_ratios, min_overlaps, max_overlaps,
                 min_sample_coverages, max_sample_coverages,
                 min_object_coverages, max_object_coverages,
                 max_trials, emit_mode="center", emit_overlap_thresh=0.3):
        n = len(min_scales)
        for name, t in [("max_crop_scales", max_scales),
                        ("min_crop_aspect_ratios", min_aspect_ratios),
                        ("max_crop_aspect_ratios", max_aspect_ratios),
                        ("min_crop_overlaps", min_overlaps),
                        ("max_crop_overlaps", max_overlaps),
                        ("min_crop_sample_coverages", min_sample_coverages),
                        ("max_crop_sample_coverages", max_sample_coverages),
                        ("min_crop_object_coverages", min_object_coverages),
                        ("max_crop_object_coverages", max_object_coverages),
                        ("max_crop_trials", max_trials)]:
            if len(t) != n:
                raise MXNetError(
                    "DetRandomCropAug: %s has %d entries, expected %d "
                    "(one per sampler)" % (name, len(t), n))
        if emit_mode not in ("center", "overlap"):
            raise MXNetError("crop_emit_mode must be 'center' or 'overlap'")
        self.p = p
        self.samplers = list(zip(min_scales, max_scales, min_aspect_ratios,
                                 max_aspect_ratios, min_overlaps,
                                 max_overlaps, min_sample_coverages,
                                 max_sample_coverages, min_object_coverages,
                                 max_object_coverages, max_trials))
        self.emit_mode = emit_mode
        self.emit_overlap_thresh = emit_overlap_thresh

    def _gen_crop_box(self, smin, smax, armin, armax, img_ar, rng):
        # reference GenerateCropBox: scale then aspect ratio bounded by
        # [scale^2, 1/scale^2] and the image's own aspect ratio
        scale = rng.uniform(smin, smax) + 1e-12
        min_ratio = max(armin / img_ar, scale * scale)
        max_ratio = min(armax / img_ar, 1.0 / (scale * scale))
        if min_ratio > max_ratio:
            return None
        ratio = np.sqrt(rng.uniform(min_ratio, max_ratio))
        w = min(1.0, scale * ratio)
        h = min(1.0, scale / ratio)
        return (rng.uniform(0.0, 1.0 - w),
                rng.uniform(0.0, 1.0 - h), w, h)

    def _try_crop(self, rect, boxes, sampler):
        (_, _, _, _, omin, omax, scmin, scmax, ocmin, ocmax, _) = sampler
        if boxes.shape[0] == 0:
            return boxes  # no objects: any crop is fine (reference :296)
        x, y, w, h = rect
        inter = _intersect_area(rect, boxes)
        gt_area = ((boxes[:, 3] - boxes[:, 1]) * (boxes[:, 4] - boxes[:, 2]))
        ok = np.ones(boxes.shape[0], bool)
        # ratios are semantically <= 1; clip so float64 rect x float32 box
        # arithmetic (e.g. 1.0000001 coverage) can't fail a max-bound of 1.0
        if omin > 0.0 or omax < 1.0:
            iou = np.minimum(inter / (w * h + gt_area - inter + 1e-12), 1.0)
            ok &= (iou >= omin) & (iou <= omax)
        if scmin > 0.0 or scmax < 1.0:
            cov = np.minimum(inter / (w * h), 1.0)
            ok &= (cov >= scmin) & (cov <= scmax)
        if ocmin > 0.0 or ocmax < 1.0:
            cov = np.minimum(inter / (gt_area + 1e-12), 1.0)
            ok &= (cov >= ocmin) & (cov <= ocmax)
        if not ok.any():
            return None
        # emit: which objects survive the crop
        if self.emit_mode == "center":
            cx = (boxes[:, 1] + boxes[:, 3]) * 0.5
            cy = (boxes[:, 2] + boxes[:, 4]) * 0.5
            keep = (cx >= x) & (cx <= x + w) & (cy >= y) & (cy <= y + h)
        else:
            keep = (inter / (gt_area + 1e-12)) > self.emit_overlap_thresh
        if not keep.any():
            return None
        return _project(boxes[keep], rect)

    def apply_np(self, arr, boxes, rng=pyrandom):
        if rng.random() >= self.p:
            return arr, boxes
        h, w = arr.shape[:2]
        order = list(range(len(self.samplers)))
        rng.shuffle(order)
        for idx in order:
            sampler = self.samplers[idx]
            for _ in range(int(sampler[-1])):
                rect = self._gen_crop_box(sampler[0], sampler[1], sampler[2],
                                          sampler[3], w / float(h), rng)
                if rect is None:
                    continue
                new_boxes = self._try_crop(rect, boxes, sampler)
                if new_boxes is None:
                    continue
                x, y, cw, ch = rect
                left, top = int(x * w), int(y * h)
                # >=1 px: a near-zero scale draw must not produce an empty
                # crop (the force-resize would raise and the worker would
                # drop the record as corrupt)
                cw_px = max(1, int(cw * w))
                ch_px = max(1, int(ch * h))
                return (arr[top : top + ch_px, left : left + cw_px],
                        new_boxes)
        return arr, boxes  # every sampler failed: keep the original


class DetForceResizeAug(DetAugmenter):
    """Final resize to exactly (w, h) — boxes are normalized, unaffected
    (reference: resize_mode 'force' :615-623)."""

    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def apply_np(self, arr, boxes, rng=pyrandom):
        if arr.shape[1] != self.size[0] or arr.shape[0] != self.size[1]:
            arr = imresize_np(arr, self.size[0], self.size[1], self.interp)
        return arr, boxes


class DetResizeShorterAug(DetAugmenter):
    """Scale the shorter edge to ``size`` before other augmenters
    (reference: the resize prologue of Process :495-509)."""

    def __init__(self, size, interp=1):
        self.size, self.interp = size, interp

    def apply_np(self, arr, boxes, rng=pyrandom):
        h, w = arr.shape[:2]
        if h > w:
            nw, nh = self.size, self.size * h // w
        else:
            nw, nh = self.size * w // h, self.size
        return imresize_np(arr, nw, nh, self.interp), boxes


def CreateDetAugmenter(data_shape, resize=0, rand_crop_prob=0.0,
                       min_crop_scales=(0.0,), max_crop_scales=(1.0,),
                       min_crop_aspect_ratios=(1.0,),
                       max_crop_aspect_ratios=(1.0,),
                       min_crop_overlaps=(0.0,), max_crop_overlaps=(1.0,),
                       min_crop_sample_coverages=(0.0,),
                       max_crop_sample_coverages=(1.0,),
                       min_crop_object_coverages=(0.0,),
                       max_crop_object_coverages=(1.0,),
                       num_crop_sampler=1, crop_emit_mode="center",
                       emit_overlap_thresh=0.3, max_crop_trials=(25,),
                       rand_pad_prob=0.0, max_pad_scale=1.0,
                       rand_mirror_prob=0.0, fill_value=127, inter_method=1,
                       brightness=0.0, contrast=0.0, saturation=0.0,
                       mean=None, std=None):
    """Build the detection augmenter list (reference: param table
    image_det_aug_default.cc:95-165 — same names and defaults; processing
    order matches Process: resize → color → mirror → pad → crop → final
    force-resize → normalize)."""
    from . import image as _img

    def _tup(v, name):
        t = [float(x) for x in (v if isinstance(v, (tuple, list)) else [v])]
        if len(t) == 1 and num_crop_sampler > 1:
            t = t * num_crop_sampler  # reference ValidateCropParameters
        if len(t) != num_crop_sampler:
            raise MXNetError("%s: %d entries for %d crop samplers"
                             % (name, len(t), num_crop_sampler))
        return t

    auglist = []
    if resize and resize > 0:
        auglist.append(DetResizeShorterAug(resize, inter_method))
    if brightness:
        auglist.append(DetBorrowAug(_img.BrightnessJitterAug(brightness)))
    if contrast:
        auglist.append(DetBorrowAug(_img.ContrastJitterAug(contrast)))
    if saturation:
        auglist.append(DetBorrowAug(_img.SaturationJitterAug(saturation)))
    if rand_mirror_prob > 0:
        auglist.append(DetHorizontalFlipAug(rand_mirror_prob))
    if rand_pad_prob > 0 and max_pad_scale > 1.0:
        auglist.append(DetRandomPadAug(rand_pad_prob, max_pad_scale,
                                       fill_value))
    if rand_crop_prob > 0 and num_crop_sampler > 0:
        auglist.append(DetRandomCropAug(
            rand_crop_prob,
            _tup(min_crop_scales, "min_crop_scales"),
            _tup(max_crop_scales, "max_crop_scales"),
            _tup(min_crop_aspect_ratios, "min_crop_aspect_ratios"),
            _tup(max_crop_aspect_ratios, "max_crop_aspect_ratios"),
            _tup(min_crop_overlaps, "min_crop_overlaps"),
            _tup(max_crop_overlaps, "max_crop_overlaps"),
            _tup(min_crop_sample_coverages, "min_crop_sample_coverages"),
            _tup(max_crop_sample_coverages, "max_crop_sample_coverages"),
            _tup(min_crop_object_coverages, "min_crop_object_coverages"),
            _tup(max_crop_object_coverages, "max_crop_object_coverages"),
            [int(x) for x in _tup(max_crop_trials, "max_crop_trials")],
            crop_emit_mode, emit_overlap_thresh))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    auglist.append(DetBorrowAug(_img.CastAug()))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist
