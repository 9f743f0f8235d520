"""contrib ndarray namespace of the port (counterpart of
``mxnet_tpu/contrib/ndarray.py``): every registered ``_contrib_<name>``
op as the imperative function ``<name>``."""
import sys

from .. import ndarray as _nd
from .. import symbol as _sym  # noqa: F401 - registers the op modules
from ..ops.registry import list_ops

_mod = sys.modules[__name__]
for _name in list_ops():
    if _name.startswith("_contrib_"):
        setattr(_mod, _name[len("_contrib_"):], getattr(_nd, _name))
