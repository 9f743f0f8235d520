"""Utilities of the port (counterpart of ``mxnet_tpu/utils``): small
helpers the examples and tools use, and the test helpers re-exported so
``mx.utils`` is the one helper namespace, as in the JAX package."""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as np
import torch

from ..test_utils import (  # noqa: F401 — the comparison helpers
    assert_almost_equal, check_consistency, check_numeric_gradient,
    check_symbolic_backward, check_symbolic_forward,
)

__all__ = [
    "seed_everything", "makedirs", "split_data", "clip_global_norm",
    "assert_almost_equal", "check_consistency", "check_numeric_gradient",
    "check_symbolic_backward", "check_symbolic_forward",
]


def seed_everything(seed):
    """Seed Python's, numpy's and the port's generators (:mod:`..random`:
    torch's CPU generator and each card's) in one call."""
    from .. import random as mxrandom

    seed = int(seed)
    _pyrandom.seed(seed)
    np.random.seed(seed % (2**32))
    mxrandom.seed(seed)


def makedirs(d):
    """``mkdir -p``."""
    os.makedirs(d, exist_ok=True)


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` into ``num_slice`` NDArrays (the
    last takes the remainder when ``even_split`` is False)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along axis %d"
            % (data.shape, num_slice, batch_axis))
    if size < num_slice:
        raise ValueError(
            "too many slices: axis %d has size %d < num_slice %d"
            % (batch_axis, size, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def clip_global_norm(arrays, max_norm):
    """Scale the NDArrays in place so their global L2 norm is at most
    ``max_norm``; returns the norm before clipping. The sum of squares is
    reduced on the arrays' device and read back once."""
    if not arrays:
        return 0.0
    with torch.no_grad():
        total = sum(torch.sum(a.data.float() * a.data.float())
                    for a in arrays)
        norm = float(np.sqrt(float(total)))
        if norm > max_norm:
            scale = max_norm / (norm + 1e-12)
            for a in arrays:
                a.data.mul_(scale)
    return norm
