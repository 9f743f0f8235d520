"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart is found by path. It imports ``torch`` and numpy, never JAX
and nothing of ``mxnet_tpu``. Every TPU (Pallas) kernel on a ported path
is a hand-written CUDA kernel for Hopper (``csrc/``), built at first use
by :mod:`.ops._build`; each has a plain PyTorch version beside it that
runs for tensors on the CPU.

Ported so far: the serving engine (:mod:`.serving`) with the flash
prefill and paged decode kernels, and symbolic training through
``Module.fit`` (:mod:`.symbol`, :mod:`.executor`, :mod:`.module`, the
Transformer-LM's ops, initializers, SGD and Adam, ``NDArrayIter``,
metrics) with the flash-attention backward kernels; speculative decoding
with the multi-query paged kernel, and checkpoints (``nd.save``/``load``,
``model.save_checkpoint``/``load_checkpoint``, ``Module.load``) in the JAX
package's file format. The namespaces are
the JAX package's, so a training script needs only its import line
changed: ``import mxnet_tpu_torch as mx``.
"""
import torch

from . import base, context
from .base import MXNetError
from .context import cpu, default_device, gpu

# the JAX package contracts float32 at full precision (ops/registry.py
# fp32_precision); TF32 would keep about three decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import ndarray, symbol  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import symbol as sym  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from .name import NameManager, Prefix  # noqa: E402
from .executor import Executor  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import optimizer  # noqa: E402
from . import optimizer as opt  # noqa: E402
from . import metric, io, callback, models  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from . import model  # noqa: E402

__version__ = "0.1.0"

__all__ = ["base", "context", "MXNetError", "cpu", "gpu", "default_device",
           "nd", "ndarray", "sym", "symbol", "AttrScope", "NameManager",
           "Prefix", "Executor", "init", "initializer", "opt", "optimizer",
           "metric", "io", "callback", "models", "mod", "module", "model"]
