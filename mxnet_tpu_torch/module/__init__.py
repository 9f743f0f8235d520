"""Modules of the port (counterpart of ``mxnet_tpu/module``): the fit
loop in :mod:`.base_module`, :class:`.Module` over one context (the
classic executor-group path and the fused one),
:class:`.BucketingModule`, one Module per bucket over shared parameters
and one shared fused state, :class:`.SequentialModule`, a chain of
modules acting as one, and :class:`.PythonModule`/
:class:`.PythonLossModule`, modules written in Python."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule
from .executor_group import DataParallelExecutorGroup
from ..base import not_ported as _not_ported

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module",
           "PythonLossModule", "PythonModule", "SequentialModule",
           "DataParallelExecutorGroup"]

__getattr__ = _not_ported(__name__, {"ParallelLMModule": "A6b",
                                     "parallel_module": "A6b"})
