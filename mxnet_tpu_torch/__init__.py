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
package's file format; ResNet-50 on the fused step (one CUDA graph per
input shape); the bucketed LSTM LM (``mx.rnn``, the ``RNN`` op,
``BucketingModule`` over one shared fused state), optimizer-state files
and ``fit(auto_resume=...)``; the image-classification zoo through
``tools/train_imagenet.py`` with ``mx.random`` (one generator per
device, registered with every CUDA graph that draws), the sampling ops,
``Dropout``/``LRN``/``LeakyReLU``, ``mx.lr_scheduler``, the rest of the
optimizers, initializers and metrics, and ``model.FeedForward``; the
operator surface and DCGAN; SSD-300 with the contrib ops (``MultiBox*``,
``Proposal``, ``CTCLoss``, ``fft``, ``count_sketch``, ``quantize``),
``metric.MApMetric`` and ``tools/train_ssd.py``; ``Custom`` operators
(:mod:`.operator`) and ``SequentialModule``/``PythonModule``; imperative
autograd (``contrib.autograd``, over the flash kernels too), the Caffe
layers, the torch bridge, the notebook callbacks, the op docs and the
reference's test helpers; the data pipeline: RecordIO (``recordio``),
``image``/``image_det`` augmenters, ``ImageRecordIter`` and
``ImageDetRecordIter`` (``io_image``) on the Python pipeline or the
native host stage (``csrc/native``, built with ``g++`` at first use), and
the uint8 wire decoded inside the fused step's CUDA graph. The
namespaces are
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
from . import operator  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import symbol as sym  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from .name import NameManager, Prefix  # noqa: E402
from .executor import Executor  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import random  # noqa: E402
from . import lr_scheduler  # noqa: E402
from . import optimizer  # noqa: E402
from . import optimizer as opt  # noqa: E402
from . import metric, io, callback, rnn, models  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from . import model  # noqa: E402
from . import visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from . import log  # noqa: E402
from . import recordio, image, image_det, io_image  # noqa: E402
from . import image as img  # noqa: E402
from . import contrib  # noqa: E402
from . import test_utils  # noqa: E402
from . import notebook  # noqa: E402
from . import op_doc, symbol_doc, ndarray_doc  # noqa: E402
from . import torch_bridge  # noqa: E402
from . import torch_bridge as th  # noqa: E402
from . import torch_bridge as torch  # noqa: E402,F811

__version__ = "0.1.0"

__all__ = ["base", "context", "MXNetError", "cpu", "gpu", "default_device",
           "nd", "ndarray", "operator", "sym", "symbol", "AttrScope", "NameManager",
           "Prefix", "Executor", "init", "initializer", "random",
           "lr_scheduler", "opt", "optimizer",
           "metric", "io", "callback", "rnn", "models", "mod", "module",
           "model", "visualization", "viz", "log", "recordio", "image", "img",
           "image_det", "io_image", "contrib", "test_utils", "notebook",
           "op_doc", "symbol_doc", "ndarray_doc", "torch_bridge", "th",
           "torch"]
