"""Contrib namespace of the port (counterpart of
``mxnet_tpu/contrib/__init__.py``; reference:
python/mxnet/contrib/__init__.py): imperative autograd, the contrib ops
under their short names (``mx.contrib.nd``, ``mx.contrib.sym``) and the
Caffe layers."""
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import caffe  # noqa: F401
