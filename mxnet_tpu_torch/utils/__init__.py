"""Utilities of the port (counterpart of ``mxnet_tpu/utils``)."""
