"""Modules of the port (counterpart of ``mxnet_tpu/module``): the fit
loop in :mod:`.base_module`, :class:`.Module` over one context (the
classic executor-group path and the fused one) and
:class:`.BucketingModule`, one Module per bucket over shared parameters
and one shared fused state. SequentialModule and PythonModule wait for
``ROADMAP.md`` A4."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module"]
