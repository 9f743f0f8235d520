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
the uint8 wire decoded inside the fused step's CUDA graph; the script
surface (``mx.Context`` and its ``with`` scope, ``mx.tpu``,
``mx.current_context``, ``mx.context.auto``, ``mx.utils``, the rest of
``mx.io``) and ``mx.kv``: the single-process store and the
parameter-server cluster of ``tools/launch.py`` (``dist_sync``,
``dist_async``; :mod:`.kvstore_server`, the engine and the transport in
``csrc/native``), whose fused step runs its gradient and its update as
two CUDA graphs with the exchange on the host between them, with its
HA and elastic half (replicated server groups with failover and
checkpoints, the membership registry, :mod:`.elastic`, the cluster-stats
publisher); model
parallelism: meshes of positions over the cards (``parallel``), ring and
Ulysses attention over the flash kernels, the GPipe pipeline, the Switch
MoE, the dense, sp, pp and ep LM trainers behind
``mod.ParallelLMModule``, ``group2ctx`` placement (:mod:`.placed`) and
several contexts per module (``executor_manager``). The
namespaces are the JAX package's, so a training script needs only its
import line changed: ``import mxnet_tpu_torch as mx``.

A process started with ``DMLC_ROLE=server`` serves its key shard inside
this import and exits when the cluster stops (a ``scheduler`` exits at
once), as ``import mxnet_tpu`` does.
"""
import torch

from . import base, context
from .base import MXNetError
from .context import Context, cpu, current_context, default_device, gpu, tpu

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
from . import utils  # noqa: E402
from . import engine  # noqa: E402
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from .kvstore import KVStore  # noqa: E402
from . import kvstore_server  # noqa: E402
from . import elastic  # noqa: E402
from . import fault, analysis, parallel  # noqa: E402
from . import profiler, compileobs, guard  # noqa: E402
from . import compile_cache, graphpass, rtc  # noqa: E402
from . import monitor  # noqa: E402
from . import monitor as mon  # noqa: E402
from . import placed, executor_manager  # noqa: E402
from . import random as rnd  # noqa: E402
from .model import FeedForward  # noqa: E402
from .optimizer import Optimizer  # noqa: E402
from .base import not_ported as _not_ported  # noqa: E402

# the JAX package's top-level names the port has not reached yet
__getattr__ = _not_ported(__name__, {
    "export_artifact": "A8b", "export_predict_artifact": "A8b",
    "export_train_artifact": "A8b"})

__version__ = "0.1.0"

__all__ = ["base", "context", "MXNetError", "Context", "cpu", "gpu", "tpu",
           "current_context", "default_device", "utils", "engine", "kv",
           "kvstore", "KVStore", "kvstore_server", "elastic", "fault", "analysis",
           "parallel", "placed", "executor_manager", "rnd", "profiler",
           "compileobs", "compile_cache", "graphpass", "rtc", "guard",
           "monitor", "mon",
           "FeedForward", "Optimizer",
           "nd", "ndarray", "operator", "sym", "symbol", "AttrScope", "NameManager",
           "Prefix", "Executor", "init", "initializer", "random",
           "lr_scheduler", "opt", "optimizer",
           "metric", "io", "callback", "rnn", "models", "mod", "module",
           "model", "visualization", "viz", "log", "recordio", "image", "img",
           "image_det", "io_image", "contrib", "test_utils", "notebook",
           "op_doc", "symbol_doc", "ndarray_doc", "torch_bridge", "th",
           "torch"]

# the persistent compile cache, when MXNET_COMPILE_CACHE_DIR names one
compile_cache.maybe_enable_from_env()

# a server-role process serves here until the cluster stops (reference:
# python/mxnet/__init__.py -> kvstore_server._init_kvstore_server_module)
if __import__("os").environ.get("DMLC_ROLE") in ("server", "scheduler"):
    kvstore_server._init_kvstore_server_module()
