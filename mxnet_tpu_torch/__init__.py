"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart is found by path. It imports ``torch`` and numpy, never JAX
and nothing of ``mxnet_tpu``. Every TPU (Pallas) kernel on a ported path
is a hand-written CUDA kernel for Hopper (``csrc/``), built at first use
by :mod:`.ops._build`; each has a plain PyTorch version beside it that
runs for tensors on the CPU.

Ported so far: the serving engine (:mod:`.serving`) with the flash
prefill and paged decode kernels (:mod:`.ops.attention`).
"""
import torch

from . import base, context
from .base import MXNetError
from .context import cpu, default_device, gpu

# the JAX package contracts float32 at full precision (ops/registry.py
# fp32_precision); TF32 would keep about three decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["base", "context", "MXNetError", "cpu", "gpu", "default_device"]
