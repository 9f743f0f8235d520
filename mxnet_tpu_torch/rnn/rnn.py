"""RNN checkpoint helpers of the port (counterpart of
``mxnet_tpu/rnn/rnn.py``; reference: python/mxnet/rnn/rnn.py): the
checkpoint functions of :mod:`..model` with each cell's weights unpacked
per gate on the way to the file and packed again on the way back."""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint`` of ``arg_params`` unpacked by ``cells``."""
    for cell in _cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``model.load_checkpoint`` with the arguments packed by ``cells``."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback: :func:`save_rnn_checkpoint` every ``period``
    epochs, named with the count of completed epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
