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

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module",
           "PythonLossModule", "PythonModule", "SequentialModule"]
