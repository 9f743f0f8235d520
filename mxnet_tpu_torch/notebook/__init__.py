"""Notebook utilities of the port (counterpart of ``mxnet_tpu/notebook``;
reference: python/mxnet/notebook/): training callbacks for Jupyter."""
from . import callback  # noqa: F401
