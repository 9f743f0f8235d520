"""Modules of the port (counterpart of ``mxnet_tpu/module``): the fit loop
in :mod:`.base_module`, the classic executor-group path of
:class:`.Module` over one context. BucketingModule, SequentialModule and
PythonModule wait for ``ROADMAP.md`` A1/A4."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]
