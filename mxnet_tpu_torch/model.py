"""Checkpoint helpers of the port (counterpart of ``mxnet_tpu/model.py``;
reference: python/mxnet/model.py save_checkpoint :319 / load_checkpoint
:349).

The checkpoint format is the JAX package's: ``prefix-symbol.json``
(``Symbol.tojson``) and ``prefix-%04d.params`` (an ``nd.save`` dict with
``arg:``/``aux:`` name prefixes), both written crash-safely, so either
package reads the other's checkpoints. The epoch number in a file name
counts completed epochs.

``load_latest_valid_checkpoint`` is what ``fit(auto_resume=prefix)``
resumes from: the newest epoch whose params file loads, torn or corrupt
ones skipped. The ``.resume`` sidecar (``prefix-%04d.resume``, JSON, the
JAX package's format) adds the position within the epoch in progress:
batches consumed, the iterator's state, the numpy RNG and the optimizer's
update counts, bound to its params file by the file's CRC footer.

The kvstore helpers (``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``) are the JAX package's,
which ``Module`` calls: which store a ``kvstore`` argument makes, whether
the store runs the optimizer (``update_on_kvstore``), and one classic
update through the store.

``FeedForward`` is the reference's legacy estimator (``fit``,
``predict``, ``score``, ``save``/``load``, ``create``), a thin adapter
over ``Module`` as in the JAX package: it runs on the card unless given
``ctx=mx.cpu()``.
"""
from __future__ import annotations

import json
import logging
import os
import re
from collections import namedtuple

import numpy as np

from . import io
from . import ndarray as nd
from . import symbol as sym
from .context import current_context
from .utils.atomic_file import atomic_write, footer_crc

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "load_latest_valid_checkpoint",
           "save_resume_state", "load_resume_state", "clear_resume_state",
           "decode_rng", "optimizer_counts", "restore_optimizer_counts",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store, update_on_kvstore)`` for a ``kvstore`` argument
    (reference: model.py:40-77): None or a non-distributed type string
    with one device make no store; a type string otherwise makes one with
    :func:`.kvstore.create`, a store object is taken as it is. The store
    runs the optimizer unless it is 'local' and a parameter holds more
    than 16M values."""
    from . import kvstore as kvs

    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(p.shape) for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Initialize every parameter's key (its index) from ``arg_params``;
    when the store updates, pull its value back into the device copies
    (reference: model.py:79). A relaunched elastic worker skips it: its
    pulls would carry an epoch it has not adopted yet, and the elastic
    join pulls the parameters once it has."""
    if getattr(kvstore, "_elastic_join", False):
        return
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push each gradient and pull the updated weight (reference:
    model.py:88); a dist store runs its bucketed sync
    (``bucketed_push_pull``), else key by key. Parameters without a
    gradient are skipped."""
    pairs = [(index, grad_list, arg_list)
             for index, (arg_list, grad_list)
             in enumerate(zip(param_arrays, grad_arrays))
             if grad_list[0] is not None]
    bucketed = getattr(kvstore, "bucketed_push_pull", None)
    if bucketed is not None and bucketed(pairs):
        return
    for index, grad_list, arg_list in pairs:
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """The worker's update (reference: model.py:99): with a store, push
    each gradient and pull the sum back into it first."""
    pairs = []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                       grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            pairs.append((index * num_device + k, g, w))
    updater.update_all(pairs)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save the symbol (when given) and the parameters of ``epoch``, and
    retire a ``.resume`` sidecar of the same epoch number (it described an
    older write of this params file). The ``checkpoint_between_files``
    fault point sits between the two files."""
    from . import fault

    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    fault.hit("checkpoint_between_files")
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    clear_resume_state(prefix, epoch)
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


def load_latest_valid_checkpoint(prefix):
    """``(symbol, arg_params, aux_params, epoch)`` of the newest
    ``prefix-EPOCH.params`` that loads (CRC and format checked), or None
    when none does. Epochs that fail — a torn write, a flipped byte, keys
    that are not ``arg:``/``aux:`` — are logged and skipped. An unloadable
    ``prefix-symbol.json`` gives ``symbol`` None (the params still
    resume)."""
    dirname = os.path.dirname(prefix) or "."
    pat = re.compile(re.escape(os.path.basename(prefix)) + r"-(\d+)\.params$")
    try:
        entries = os.listdir(dirname)
    except OSError:
        return None
    # the matched file name: a hand-saved 'prefix-7.params' loads from the
    # file that matched, not from a re-derived '%04d' name
    epochs = sorted(((int(m.group(1)), os.path.join(dirname, f))
                     for f in entries if (m := pat.match(f))), reverse=True)
    if not epochs:
        return None
    symbol = None
    try:
        symbol = sym.load("%s-symbol.json" % prefix)
    except Exception as exc:  # noqa: BLE001 — params-only resume
        logging.warning("auto-resume: cannot load %s-symbol.json (%s); "
                        "resuming with params only", prefix, exc)
    for epoch, param_file in epochs:
        try:
            arg_params, aux_params = _split_params(nd.load(param_file))
        except Exception as exc:  # noqa: BLE001 — any unloadable epoch
            logging.warning("skipping corrupt/unloadable checkpoint %s: %s",
                            param_file, exc)
            continue
        return (symbol, arg_params, aux_params, epoch)
    return None


# ---- the mid-epoch .resume sidecar ----------------------------------------
_RESUME_VERSION = 1


def _resume_name(prefix, epoch):
    return "%s-%04d.resume" % (prefix, epoch)


def _encode_rng(state):
    """``np.random.get_state()`` as a JSON-able dict (MT19937 only)."""
    if state is None:
        return None
    algo, keys, pos, has_gauss, cached = state
    return {"algo": str(algo), "keys": [int(k) for k in keys],
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def decode_rng(enc):
    """The sidecar's RNG encoding as ``np.random.set_state`` takes it;
    None passes through."""
    if enc is None:
        return None
    return (enc["algo"], np.array(enc["keys"], dtype=np.uint32),
            int(enc["pos"]), int(enc["has_gauss"]), float(enc["cached"]))


def save_resume_state(prefix, epoch, nbatch, iter_state=None, numpy_rng=None,
                      optimizer_counts=None):
    """Write the ``.resume`` sidecar beside ``prefix-EPOCH.params``, which
    must be written first: the sidecar records that file's CRC, and a
    loader ignores a sidecar whose CRC does not match the params beside
    it."""
    crc = footer_crc("%s-%04d.params" % (prefix, epoch))
    rec = {"version": _RESUME_VERSION, "epoch": int(epoch),
           "nbatch": int(nbatch), "params_crc": crc,
           "iter_state": iter_state, "numpy_rng": _encode_rng(numpy_rng),
           "optimizer_counts": optimizer_counts}
    with atomic_write(_resume_name(prefix, epoch), checksum=False) as f:
        f.write(json.dumps(rec))


def load_resume_state(prefix, epoch):
    """The validated sidecar dict of ``prefix-EPOCH.params``, or None (no
    sidecar, unreadable, another version, or a CRC that is not the params
    file's: each logged, each an epoch-boundary resume)."""
    name = _resume_name(prefix, epoch)
    if not os.path.exists(name):
        return None
    try:
        with open(name) as f:
            rec = json.load(f)
        if rec.get("version") != _RESUME_VERSION:
            raise ValueError("unknown resume version %r" % rec.get("version"))
        if int(rec["epoch"]) != int(epoch) or int(rec["nbatch"]) < 0:
            raise ValueError("sidecar epoch/nbatch out of range")
    except Exception as exc:  # noqa: BLE001 — a malformed sidecar degrades
        logging.warning("auto-resume: ignoring unreadable resume sidecar %s "
                        "(%s); resuming at the epoch boundary", name, exc)
        return None
    crc = footer_crc("%s-%04d.params" % (prefix, epoch))
    if rec.get("params_crc") is not None and rec["params_crc"] != crc:
        logging.warning("auto-resume: resume sidecar %s does not match the "
                        "params file beside it (torn mid-epoch checkpoint?); "
                        "resuming at the epoch boundary", name)
        return None
    return rec


def clear_resume_state(prefix, epoch):
    """Delete the ``.resume`` sidecar of ``epoch``, if there is one."""
    try:
        os.remove(_resume_name(prefix, epoch))
    except OSError:
        pass


def optimizer_counts(module):
    """The optimizer's schedule position, which a ``.states`` file does not
    carry: ``num_update``, ``begin_num_update`` and the per-index update
    counts (keyed by index on the classic path, by parameter name on the
    fused one). None without an optimizer."""
    opt = getattr(module, "_optimizer", None)
    if opt is None:
        return None
    return {"num_update": opt.num_update,
            "begin_num_update": opt.begin_num_update,
            "index_update_count": dict(opt._index_update_count)}


def restore_optimizer_counts(module, counts):
    """Put :func:`optimizer_counts` (as read back from JSON) into the
    module's optimizer."""
    opt = getattr(module, "_optimizer", None)
    if opt is None or not counts:
        return
    opt.num_update = counts["num_update"]
    opt.begin_num_update = counts["begin_num_update"]
    # JSON made every key a string: the classic path's indices go back to
    # ints, the fused path's parameter names stay names
    opt._index_update_count = {
        (int(k) if re.fullmatch(r"-?\d+", str(k)) else k): v
        for k, v in counts["index_update_count"].items()}


class FeedForward:
    """The reference's legacy estimator (reference: model.py:387): a thin
    adapter over ``Module``. Parameters are kept as host NDArrays between
    calls; ``kwargs`` are the optimizer's parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod

        self.symbol = symbol
        if ctx is None:
            ctx = [current_context()]
        elif not isinstance(ctx, list):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = (initializer if initializer is not None
                            else init_mod.Uniform(0.01))
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    @staticmethod
    def _names(descs):
        return [d[0] if isinstance(d, tuple) else d.name for d in descs]

    def _module_for(self, data, with_label):
        from .module import Module

        return Module(self.symbol, data_names=self._names(data.provide_data),
                      label_names=(self._names(data.provide_label)
                                   if with_label else None),
                      context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            auto_resume=None, guard=None):
        """Train through ``Module.fit`` (reference: model.py
        FeedForward.fit); ``auto_resume`` and ``guard`` as there."""
        from .module import Module

        data = self._prepare_iter(X, y, is_train=True)
        mod = Module(self.symbol, data_names=self._names(data.provide_data),
                     label_names=self._names(data.provide_label),
                     context=self.ctx, logger=logger or logging)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict({"learning_rate": 0.01}, **self.kwargs),
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, auto_resume=auto_resume, guard=guard)
        self.arg_params, self.aux_params = mod.get_params()
        self._module = mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy arrays (a list when the symbol
        has several)."""
        data = self._prepare_iter(X, None, is_train=False)
        if reset:
            data.reset()
        mod = self._module_for(data, with_label=False)
        mod.bind(data.provide_data, for_training=False)
        mod.set_params(self.arg_params, self.aux_params or {},
                       allow_missing=True)
        outputs = mod.predict(data, num_batch=num_batch)
        if isinstance(outputs, list):
            return [o.asnumpy() for o in outputs]
        return outputs.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The value of ``eval_metric`` over ``X``."""
        data = self._prepare_iter(X, None, is_train=False)
        if reset:
            data.reset()
        mod = self._module_for(data, with_label=True)
        mod.bind(data.provide_data, data.provide_label, for_training=False)
        mod.set_params(self.arg_params, self.aux_params or {},
                       allow_missing=True)
        res = mod.score(data, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback)
        return res[0][1]

    def _prepare_iter(self, X, y, is_train):
        if isinstance(X, io.DataIter):
            return X
        if isinstance(X, (np.ndarray, nd.NDArray)):
            if y is None and is_train:
                raise ValueError("y must be specified when X is numpy.ndarray")
            if isinstance(X, nd.NDArray):
                X = X.asnumpy()
            y = y if y is not None else np.zeros(X.shape[0])
            return io.NDArrayIter(
                X, y, batch_size=min(self.numpy_batch_size, X.shape[0]),
                shuffle=is_train,
                last_batch_handle="roll_over" if is_train else "pad")
        raise TypeError("X must be DataIter or numpy/NDArray")

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise ValueError("save: give the epoch (num_epoch is unset)")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """A FeedForward made and fitted in one call."""
        from . import initializer as init_mod

        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer or init_mod.Uniform(0.01),
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
