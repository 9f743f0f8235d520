"""Device context (reference: python/mxnet/context.py).

The JAX package aliases ``mx.gpu(i)`` to a TPU chip; in the port a context
is a ``torch.device``: ``cpu()`` is the host and ``gpu(i)`` is CUDA card
``i``. :func:`default_device` is where entry points run when the caller
names no device: the first card, never the CPU by default.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device"]


def cpu(device_id=0):
    """The host (reference: python/mxnet/context.py:95). PyTorch has one
    CPU device; ``device_id`` is accepted for script compatibility."""
    del device_id
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return torch.device("cuda", int(device_id))


def default_device():
    """``cuda:0``. Raises :class:`MXNetError` when CUDA is absent: an entry
    point that was not asked for the CPU must not fall back to it quietly."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (pass device='cpu')")
    return torch.device("cuda", 0)


def resolve(device):
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
