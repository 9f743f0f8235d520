"""contrib symbol namespace of the port (counterpart of
``mxnet_tpu/contrib/symbol.py``): every registered ``_contrib_<name>``
op as the symbol function ``<name>``."""
import sys

from .. import symbol as _sym
from ..ops.registry import list_ops

_mod = sys.modules[__name__]
for _name in list_ops():
    if _name.startswith("_contrib_"):
        setattr(_mod, _name[len("_contrib_"):], getattr(_sym, _name))
