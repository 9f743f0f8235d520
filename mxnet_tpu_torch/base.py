"""Core shared utilities of the PyTorch/CUDA port.

The port's counterpart of ``mxnet_tpu/base.py``: the error type, the
``MXNET_*`` environment helpers, the attr string forms the symbol layer
serializes with, and one dtype helper. The JAX package's dtype tables
stay behind (they name ``jnp`` types); PyTorch dtypes are resolved by
:func:`torch_dtype`.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

__all__ = ["MXNetError", "env_flag", "env_int", "env_float", "env_bool",
           "env_str",
           "torch_dtype", "attr_str", "parse_shape", "parse_bool",
           "string_types"]

string_types = (str,)


class MXNetError(Exception):
    """Error raised by the framework (reference: python/mxnet/base.py MXNetError)."""


def env_flag(name, default="0"):
    """Boolean MXNET_*-style env var: anything but 0/empty/false/no/off is
    on (the JAX package's convention, which its kill switches such as
    ``MXNET_MODULE_NO_FUSED`` read)."""
    return os.environ.get(name, default).strip().lower() not in (
        "0", "", "false", "no", "off")


def _env_number(name, default, cast):
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        return cast(raw)
    except ValueError:
        logging.warning("ignoring unparseable %s=%r (using %r)",
                        name, raw, default)
        return default


def env_int(name, default=None):
    """Integer MXNET_*-style env var; unset/empty or unparseable values fall
    back to ``default`` (with a warning for garbage)."""
    return _env_number(name, default, int)


def env_float(name, default=None):
    """Float MXNET_*-style env var; same fallback contract as
    :func:`env_int`."""
    return _env_number(name, default, float)


_BOOL_TOKENS = {"1": True, "true": True, "yes": True, "on": True,
                "0": False, "false": False, "no": False, "off": False}


def env_bool(name, default=False):
    """Strict boolean MXNET_*-style env var: accepts 1/0, true/false, yes/no,
    on/off (case-insensitive). Unset/empty falls back to ``default``;
    anything else warns and falls back."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    val = _BOOL_TOKENS.get(raw.strip().lower())
    if val is None:
        logging.warning("ignoring unparseable %s=%r (using %r)",
                        name, raw, default)
        return default
    return val


def env_str(name, default=None, choices=None):
    """String MXNET_*-style env var. Unset/empty falls back to ``default``.
    With ``choices``, a value outside the set warns and falls back; the
    comparison is case-insensitive and the matching choice is returned as
    spelled in ``choices``."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    raw = raw.strip()
    if choices is None:
        return raw
    for c in choices:
        if raw.lower() == str(c).lower():
            return c
    logging.warning("ignoring %s=%r (not one of %s; using %r)",
                    name, raw, "/".join(str(c) for c in choices), default)
    return default


def torch_dtype(dtype):
    """Resolve a torch dtype, a numpy dtype (or type) or a dtype name such
    as ``"bfloat16"`` to the torch dtype. Configurations written for the
    JAX package name their dtypes the numpy way."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise MXNetError("no torch dtype named %r" % (name,))
    return out


def parse_shape(s):
    """Parse a shape attr string like ``(1, 2, 3)``/``[1,2]``/``3`` into a tuple."""
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    if isinstance(s, (int, np.integer)):
        return (int(s),)
    s = s.strip()
    if s in ("None", ""):
        return None
    s = s.strip("()[]")
    if not s.strip():
        return ()
    return tuple(int(float(tok)) for tok in s.split(",") if tok.strip())


def parse_bool(s):
    if isinstance(s, bool):
        return s
    if isinstance(s, (int, np.integer)):
        return bool(s)
    return str(s).strip().lower() in ("true", "1", "yes")


def attr_str(v):
    """Serialize an attr value to the string form used in graph JSON (the
    reference stores every op attr as its dmlc::Parameter text form), so
    ``tojson`` output is interchangeable with the JAX package's."""
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(attr_str(x) for x in v) + ")"
    if v is None:
        return "None"
    return str(v)
