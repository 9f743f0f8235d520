"""Modules of the port (counterpart of ``mxnet_tpu/module``): the fit
loop in :mod:`.base_module`, :class:`.Module` over one context or several
(the classic executor-group path and the fused one),
:class:`.BucketingModule`, one Module per bucket over shared parameters
and one shared fused state, :class:`.SequentialModule`, a chain of
modules acting as one, :class:`.PythonModule`/
:class:`.PythonLossModule`, modules written in Python, and
:class:`.ParallelLMModule`, the dense, sp, pp and ep LM trainers behind
the Module protocol."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module
from .parallel_module import ParallelLMModule
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module",
           "ParallelLMModule", "PythonLossModule", "PythonModule",
           "SequentialModule", "DataParallelExecutorGroup"]
