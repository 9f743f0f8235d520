"""Image utilities and the Python ``ImageIter`` of the port (counterpart
of ``mxnet_tpu/image.py``; reference: python/mxnet/image.py — imdecode,
scale_down, resize_short, fixed_crop, random_crop, center_crop,
color_normalize, the augmenter list CreateAugmenter :404, ImageIter
:502).

Everything runs on the host in numpy: the ``*_np`` functions are the
cores, and the NDArray forms wrap their results as host (CPU) NDArrays,
as the reference's image functions return CPU arrays. Decode and resize
go through cv2 when it imports (the reference's own decoder), else PIL
(``MXNET_IMAGE_DECODE_BACKEND=pil`` forces PIL). Arrays are HWC,
uint8 or float; ``imdecode`` gives RGB unless ``to_rgb`` is False.
Random augmenters draw from Python's ``random`` module (and
``LightingAug`` from numpy's), as the JAX package's do, so a seeded run
of either package makes the same images.
"""
from __future__ import annotations

import io as _io
import os
import random as pyrandom

import numpy as np

from . import ndarray as nd
from .context import cpu
from .base import env_str as _env_str
from .io import DataBatch, DataDesc, DataIter
from . import recordio

__all__ = [
    "imdecode", "imresize", "scale_down", "resize_short", "fixed_crop", "random_crop",
    "center_crop", "color_normalize", "random_size_crop", "HorizontalFlipAug",
    "CreateAugmenter", "ImageIter",
]


def _host_nd(arr, dtype=None):
    """A host NDArray of ``arr`` (image functions return CPU arrays)."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def _to_np(src):
    """numpy view of an image (NDArray or array-like), no copy when possible."""
    return src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)


def python_decoder():
    """The library :func:`imdecode_np` decodes with here: ``"cv2"`` or
    ``"PIL"``."""
    if _env_str("MXNET_IMAGE_DECODE_BACKEND", "").lower() != "pil":
        try:
            import cv2  # noqa: F401
            return "cv2"
        except ImportError:
            pass
    return "PIL"


def imdecode_np(buf, to_rgb=True, flag=1):
    """Decode an image byte buffer to a numpy HWC uint8 array.

    The numpy core of :func:`imdecode`; ImageRecordIter's decode workers
    call it directly, so the per-image path makes no NDArray.
    """
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy().tobytes()
    elif isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    if _env_str("MXNET_IMAGE_DECODE_BACKEND", "").lower() != "pil":
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            raw = np.frombuffer(buf, np.uint8)
            arr = cv2.imdecode(
                raw, cv2.IMREAD_GRAYSCALE if flag == 0 else cv2.IMREAD_COLOR)
            if arr is not None:  # None: format cv2 lacks -> try PIL below
                if flag == 0:
                    arr = arr[:, :, None]
                elif to_rgb:
                    arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
                return np.ascontiguousarray(arr)
    from PIL import Image

    img = Image.open(_io.BytesIO(buf))
    if flag == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return arr.astype(np.uint8)


def imdecode(buf, to_rgb=True, flag=1, **kwargs):
    """Decode an image byte buffer to an NDArray (HWC).

    (reference: image.py imdecode → cv2.imdecode op src/io/image_io.cc)

    Backend: cv2 when importable (the reference's own decoder; it
    releases the GIL, so ImageRecordIter's decode threads overlap), else
    PIL. ``MXNET_IMAGE_DECODE_BACKEND=pil`` forces the PIL path.
    """
    return _host_nd(imdecode_np(buf, to_rgb=to_rgb, flag=flag),
                    dtype=np.uint8)


def imresize_np(arr, w, h, interp=2):
    """Resize a numpy HWC image to exactly (w, h).

    cv2 backend when importable (interp uses cv2's interpolation codes,
    the reference's convention: 0 nearest, 1 bilinear, 2 bicubic...);
    PIL fallback maps any nonzero interp to bilinear.
    """
    arr = np.asarray(arr)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    if _env_str("MXNET_IMAGE_DECODE_BACKEND", "").lower() != "pil":
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            out = cv2.resize(arr.squeeze(-1) if squeeze else arr, (w, h),
                             interpolation=int(interp))
            return out[:, :, None] if squeeze else out
    from PIL import Image

    im = Image.fromarray(arr.squeeze(-1) if squeeze else arr.astype(np.uint8))
    im = im.resize((w, h), Image.BILINEAR if interp else Image.NEAREST)
    out = np.asarray(im)
    if squeeze:
        out = out[:, :, None]
    return out


def imresize(src, w, h, interp=2):
    """Resize to exactly (w, h) (reference: cv2.resize wrapper)."""
    out = imresize_np(_to_np(src), w, h, interp)
    return _host_nd(out.astype(np.uint8), dtype=np.uint8)


def scale_down(src_size, size):
    """Scale target size down to fit in src (reference: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short_np(arr, size, interp=2):
    """numpy core of :func:`resize_short`."""
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize_np(arr, new_w, new_h, interp)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge == size (reference: image.py resize_short)."""
    return _host_nd(resize_short_np(_to_np(src), size, interp).astype(np.uint8),
                    dtype=np.uint8)


def fixed_crop_np(arr, x0, y0, w, h, size=None, interp=2):
    """numpy core of :func:`fixed_crop`."""
    out = arr[y0 : y0 + h, x0 : x0 + w]
    if size is not None and (w, h) != size:
        out = imresize_np(out, size[0], size[1], interp)
    return out


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """(reference: image.py fixed_crop)"""
    out = fixed_crop_np(_to_np(src), x0, y0, w, h, size, interp)
    return _host_nd(np.ascontiguousarray(out), dtype=np.uint8)


def random_crop_np(arr, size, interp=2):
    """numpy core of :func:`random_crop`."""
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop_np(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    """(reference: image.py random_crop)"""
    out, rect = random_crop_np(_to_np(src), size, interp)
    return _host_nd(np.ascontiguousarray(out), dtype=np.uint8), rect


def center_crop_np(arr, size, interp=2):
    """numpy core of :func:`center_crop`."""
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop_np(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """(reference: image.py center_crop)"""
    out, rect = center_crop_np(_to_np(src), size, interp)
    return _host_nd(np.ascontiguousarray(out), dtype=np.uint8), rect


def random_size_crop_np(arr, size, min_area=0.08, ratio=(3 / 4.0, 4 / 3.0),
                        interp=2):
    """numpy core of :func:`random_size_crop`."""
    h, w = arr.shape[:2]
    area = w * h
    for _ in range(10):
        new_area = pyrandom.uniform(min_area, 1.0) * area
        new_ratio = pyrandom.uniform(*ratio)
        new_w = int(round(np.sqrt(new_area * new_ratio)))
        new_h = int(round(np.sqrt(new_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return (fixed_crop_np(arr, x0, y0, new_w, new_h, size, interp),
                    (x0, y0, new_w, new_h))
    return center_crop_np(arr, size, interp)


def random_size_crop(src, size, min_area=0.08, ratio=(3 / 4.0, 4 / 3.0), interp=2):
    """Random area+aspect crop (reference: image.py random_size_crop)."""
    out, rect = random_size_crop_np(_to_np(src), size, min_area, ratio, interp)
    return _host_nd(np.ascontiguousarray(out), dtype=np.uint8), rect


def color_normalize_np(arr, mean, std=None):
    """numpy core of :func:`color_normalize`."""
    arr = np.asarray(arr, np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return arr


def color_normalize(src, mean, std=None):
    """(reference: image.py color_normalize)"""
    return _host_nd(color_normalize_np(_to_np(src), mean, std))


# ---- augmenters (reference: image.py CreateAugmenter :404) ----------------
class Augmenter:
    """Base augmenter. Standard augmenters implement ``apply_np`` (numpy
    HWC in/out) and inherit this NDArray-boundary ``__call__``;
    ImageRecordIter's decode workers chain ``apply_np`` directly, so the
    per-image path makes no NDArray. Custom augmenters may override
    ``__call__`` alone — the
    iterator falls back to the NDArray chain when any augmenter lacks
    ``apply_np``."""

    _out_dtype = np.uint8

    def apply_np(self, arr):
        raise NotImplementedError

    def __call__(self, src):
        out = self.apply_np(_to_np(src))
        if self._out_dtype is None:           # float output (Cast/Normalize)
            return _host_nd(out)
        return _host_nd(np.ascontiguousarray(out), dtype=self._out_dtype)


def supports_np(aug):
    """True when ``aug``'s numpy fast path (``apply_np``) is safe to use
    in place of ``__call__``.

    Walks the MRO from the most-derived class: a class that customizes
    ``__call__`` without (re)defining ``apply_np`` in the same class makes
    the fast path unsafe — the custom ``__call__`` must run (this is the
    fallback the Augmenter docstring promises, and it covers subclasses of
    concrete augmenters too). A class defining ``apply_np`` at or above the
    first ``__call__`` override opts in (e.g. HorizontalFlipAug defines
    both together).  Both iterators (ImageRecordIter workers and
    ImageIter.next) use this single predicate.
    """
    for klass in type(aug).__mro__:
        if klass is Augmenter:
            return False              # reached base: no real apply_np
        owns_call = "__call__" in vars(klass)
        owns_np = "apply_np" in vars(klass)
        if owns_np:
            return True
        if owns_call:
            return False              # custom __call__ shadows the fast path
    return False


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return resize_short_np(arr, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return imresize_np(arr, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return random_crop_np(arr, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return center_crop_np(arr, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area=0.08, ratio=(3 / 4.0, 4 / 3.0), interp=2):
        self.size, self.min_area, self.ratio, self.interp = size, min_area, ratio, interp

    def apply_np(self, arr):
        return random_size_crop_np(arr, self.size, self.min_area, self.ratio,
                                   self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    @staticmethod
    def _flip(arr):
        return arr[:, ::-1]

    def apply_np(self, arr):
        if pyrandom.random() < self.p:
            return self._flip(arr)
        return arr

    def __call__(self, src):
        # preserve the no-op identity (the flipless branch returns src as-is)
        if pyrandom.random() < self.p:
            return _host_nd(self._flip(_to_np(src)).copy(), dtype=np.uint8)
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def apply_np(self, arr):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return np.clip(np.asarray(arr, np.float32) * alpha,
                       0, 255).astype(np.uint8)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def apply_np(self, arr):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        arr = np.asarray(arr, np.float32)
        gray = arr.mean()
        return np.clip(arr * alpha + gray * (1 - alpha),
                       0, 255).astype(np.uint8)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def apply_np(self, arr):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        arr = np.asarray(arr, np.float32)
        coef = np.array([0.299, 0.587, 0.114], np.float32)
        gray = (arr * coef).sum(axis=2, keepdims=True)
        return np.clip(arr * alpha + gray * (1 - alpha),
                       0, 255).astype(np.uint8)


class LightingAug(Augmenter):
    """PCA lighting noise (reference: image.py pca_noise part of HSL aug)."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def apply_np(self, arr):
        alpha = np.random.normal(0, self.alphastd, size=(3,)).astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return np.clip(np.asarray(arr, np.float32) + rgb,
                       0, 255).astype(np.uint8)


class ColorNormalizeAug(Augmenter):
    _out_dtype = None

    def __init__(self, mean, std):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def apply_np(self, arr):
        arr = np.asarray(arr, np.float32)
        if self.mean is not None:
            arr = arr - self.mean
        if self.std is not None:
            arr = arr / self.std
        return arr


class CastAug(Augmenter):
    _out_dtype = None

    def apply_np(self, arr):
        return np.asarray(arr, np.float32)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Build the standard augmenter list (reference: image.py:404)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3, (3.0 / 4.0, 4.0 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([
            [-0.5675, 0.7192, 0.4009],
            [-0.5808, -0.0045, -0.8140],
            [-0.5836, -0.6948, 0.4203],
        ])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Pure-python image iterator over .rec files or image lists
    (reference: image.py ImageIter :502)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label", **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
        else:
            self.imgrec = None
        self.imglist = None
        if path_imglist:
            imglist_d = {}
            imgkeys = []
            with open(path_imglist) as fin:
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    label = np.array([float(i) for i in line[1:-1]], np.float32)
                    key = int(line[0])
                    imglist_d[key] = (label, line[-1])
                    imgkeys.append(key)
            self.imglist = imglist_d
            self.seq = imgkeys
        elif isinstance(imglist, list):
            imglist_d = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if isinstance(img[0], (list, np.ndarray)):
                    label = np.array(img[0], np.float32)
                else:
                    label = np.array([img[0]], np.float32)
                imglist_d[key] = (label, img[1])
                imgkeys.append(str(key))
            self.imglist = imglist_d
            self.seq = imgkeys
        elif self.imgidx is not None:
            self.seq = self.imgidx
        else:
            self.seq = None
        if num_parts > 1 and self.seq is not None:
            # distributed sharding (the dmlc::InputSplit part_index contract)
            n_per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n_per : (part_index + 1) * n_per]
        self.path_root = path_root
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.provide_data = [DataDesc(data_name, (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name, (batch_size, label_width))]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,))]
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(reference: image.py ImageIter.next_sample)"""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                if self.imglist is None:
                    return header.label, img
                return self.imglist[idx][0], img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.zeros((batch_size, self.label_width), np.float32)
        # same numpy fast path as ImageRecordIter's workers (one shared
        # eligibility rule: supports_np)
        use_np = all(supports_np(a) for a in self.auglist)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                if use_np:
                    arr = imdecode_np(s)
                    for aug in self.auglist:
                        arr = aug.apply_np(arr)
                    arr = np.asarray(arr)
                else:
                    data = imdecode(s)
                    for aug in self.auglist:
                        data = aug(data)
                    arr = data.asnumpy()
                batch_data[i] = arr
                lab = np.asarray(label).reshape(-1)
                batch_label[i] = lab[: self.label_width]
                i += 1
        except StopIteration:
            if not i:
                raise
        # HWC -> CHW
        batch_data = batch_data.transpose(0, 3, 1, 2)
        label_out = batch_label if self.label_width > 1 else batch_label[:, 0]
        return DataBatch(
            [_host_nd(batch_data)], [_host_nd(label_out)], batch_size - i
        )
