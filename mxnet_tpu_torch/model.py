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
``FeedForward`` waits for ``ROADMAP.md`` A1.
"""
from __future__ import annotations

import json
import logging
import os
import re

import numpy as np

from . import ndarray as nd
from . import symbol as sym
from .utils.atomic_file import atomic_write, footer_crc

__all__ = ["save_checkpoint", "load_checkpoint", "load_latest_valid_checkpoint",
           "save_resume_state", "load_resume_state", "clear_resume_state",
           "decode_rng", "optimizer_counts", "restore_optimizer_counts"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save the symbol (when given) and the parameters of ``epoch``, and
    retire a ``.resume`` sidecar of the same epoch number (it described an
    older write of this params file)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
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
