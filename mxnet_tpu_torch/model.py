"""Checkpoint helpers of the port (counterpart of ``mxnet_tpu/model.py``;
reference: python/mxnet/model.py save_checkpoint :319 / load_checkpoint
:349).

The checkpoint format is the JAX package's: ``prefix-symbol.json``
(``Symbol.tojson``) and ``prefix-%04d.params`` (an ``nd.save`` dict with
``arg:``/``aux:`` name prefixes), both written crash-safely, so either
package reads the other's checkpoints. The JAX package's ``FeedForward``,
``load_latest_valid_checkpoint`` and the ``.resume`` mid-epoch sidecar are
not ported (``ROADMAP.md`` A7).
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save the symbol (when given) and the parameters of ``epoch``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    # the JAX package also retires a stale .resume sidecar here: not ported
    logging.info('Saved checkpoint to "%s"', param_name)


def _split_params(save_dict):
    """Split a checkpoint save_dict into (arg_params, aux_params) by the
    ``arg:``/``aux:`` key prefixes."""
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Load ``(symbol, arg_params, aux_params)``; the parameters are
    NDArrays on the host."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = _split_params(save_dict)
    return (symbol, arg_params, aux_params)
