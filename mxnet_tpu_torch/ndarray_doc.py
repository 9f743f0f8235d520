"""NDArray operator documentation of the port (counterpart of
``mxnet_tpu/ndarray_doc.py``): :mod:`.op_doc` under the reference's
module name."""
from .op_doc import attach_docs, build_doc  # noqa: F401
