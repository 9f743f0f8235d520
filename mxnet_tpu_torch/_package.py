"""The package's contents, imported by ``mxnet_tpu_torch/__init__.py`` (which
skips them while the standalone linter is being located)."""
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
from . import export_artifact  # noqa: E402
from .export_artifact import (export_predict_artifact,  # noqa: E402
                              export_train_artifact)

__version__ = "0.1.0"

__all__ = ["base", "context", "MXNetError", "Context", "cpu", "gpu", "tpu",
           "current_context", "default_device", "utils", "engine", "kv",
           "kvstore", "KVStore", "kvstore_server", "elastic", "fault", "analysis",
           "parallel", "placed", "executor_manager", "rnd", "profiler",
           "compileobs", "compile_cache", "graphpass", "rtc", "guard",
           "monitor", "mon",
           "FeedForward", "Optimizer", "export_artifact",
           "export_predict_artifact", "export_train_artifact",
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
