"""Host input-pipeline benchmark and stage attribution ladder (the port's
counterpart of ``tools/bench_pipeline.py``).

Generates a synthetic JPEG dataset, packs it with the port's
``tools/im2rec.py``, then measures a ladder that splits a fit from
records into decode, batch, wire and step:

  A  raw JPEG decode per image (PIL, cv2)
  B  ``ImageRecordIter`` into a null consumer (decode + augment + batch +
     prefetch) at 1, 2 and 4 threads, float32 wire, then uint8 wire
  B' the same on the native stage (``backend='native'``: C++ decode,
     augment and batch, ``csrc/native/pipe.cc``; nvJPEG on a card built
     without libjpeg, ``_native.decoder()`` names it)
  C  the batches through ``io.DeviceFeedIter`` onto the device (pinned
     upload on a side stream) and the on-device wire decode
     (``io.apply_wire``), nothing else; C' the same from the native stage
  D  ``Module.fit`` of a small conv net: float32 wire, uint8 wire, uint8
     wire + ``MXNET_FEED_DEPTH`` 2, uint8 wire + the native stage

Every rung reports the median over ``--reps`` windows with its min-max
band, and the ``pipeline.stage_seconds`` telemetry histograms are
published while the ladder runs. One JSON line per measurement, the JAX
tool's metric names and fields plus ``device`` and, on a card, its
``name`` and ``power_limit``; a markdown attribution table at the end.
A rung that cannot run as asked (no native stage, no cv2) raises: no
rung is replaced by an ``*_unavailable`` flag.

    python -m mxnet_tpu_torch.tools.bench_pipeline [--n 512] [--size 224] \\
        [--reps 5] [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import io as _io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import _device

_FIELDS = {}


def emit(metric, value, unit, extra=None):
    rec = {"metric": metric, "value": float(value), "unit": unit}
    if extra:
        rec.update(extra)
    rec.update(_FIELDS)
    print(json.dumps(rec), flush=True)
    return rec


def _band(vals):
    """(median, lo, hi) over a list of window rates."""
    return statistics.median(vals), min(vals), max(vals)


def _emit_band(metric, vals, unit, extra=None):
    med, lo, hi = _band(vals)
    extra = dict(extra or {})
    extra.update({"band_lo": lo, "band_hi": hi, "windows": len(vals)})
    emit(metric, med, unit, extra)
    return med, lo, hi


def gen_dataset(workdir, n, size):
    """n JPEGs with enough structure that decode cost is realistic (the
    JAX tool's images, byte for byte)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    img_dir = os.path.join(workdir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    lst_path = os.path.join(workdir, "data.lst")
    with open(lst_path, "w") as lst:
        for i in range(n):
            # blocky texture compresses like a photo, not like noise
            base = rng.rand(size // 8, size // 8, 3) * 255
            arr = np.kron(base, np.ones((8, 8, 1)))[:size, :size]
            arr += rng.randn(size, size, 3) * 8
            im = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
            name = "img_%05d.jpg" % i
            im.save(os.path.join(img_dir, name), quality=90)
            lst.write("%d\t%d\t%s\n" % (i, i % 10, name))
    return img_dir, lst_path


def pack(workdir, img_dir, lst_path):
    """Pack with the port's im2rec (pass-through: the JPEG bytes are
    stored, the iterator decodes). Its progress lines go to stderr."""
    from . import im2rec

    prefix = lst_path[:-4]
    with contextlib.redirect_stdout(sys.stderr):
        im2rec.main([prefix, img_dir + os.sep, "--pass-through"])
    rec = prefix + ".rec"
    if not os.path.exists(rec):
        raise RuntimeError("im2rec did not produce %s" % rec)
    return rec


def bench_decode(img_dir, n_meas=200):
    """Rung A: PIL and cv2 decode rates (images/s)."""
    import cv2
    from PIL import Image

    files = sorted(os.listdir(img_dir))[:n_meas]
    blobs = []
    for f in files:
        with open(os.path.join(img_dir, f), "rb") as fin:
            blobs.append(fin.read())
    t0 = time.perf_counter()
    for b in blobs:
        np.asarray(Image.open(_io.BytesIO(b)).convert("RGB"))
    pil_rate = len(blobs) / (time.perf_counter() - t0)
    emit("decode_pil_imgs_per_sec", pil_rate, "img/s")
    t0 = time.perf_counter()
    for b in blobs:
        cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
    cv_rate = len(blobs) / (time.perf_counter() - t0)
    emit("decode_cv2_imgs_per_sec", cv_rate, "img/s",
         {"speedup_vs_pil": cv_rate / pil_rate})
    return pil_rate, cv_rate


def _make_iter(rec, size, batch, threads, wire_dtype=None, backend=None):
    """Every rung pins the wire and the backend: an unpinned iterator
    takes the native stage and the uint8 wire where it can."""
    import mxnet_tpu_torch as mx

    it = mx.io_image.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, size, size), batch_size=batch,
        preprocess_threads=threads, shuffle=False,
        wire_dtype=wire_dtype or "float32", backend=backend or "python")
    if backend == "native" and it._native is None:
        it.close()
        raise RuntimeError("the native stage did not start: %s"
                           % it._native_fallback_why)
    return it


def _decoder(backend):
    if backend != "native":
        return {}
    from .. import _native

    return {"decoder": _native.decoder()}


def _windows(it, batch, n_batches, reps, consume):
    """``reps`` timed windows of ``n_batches`` each over a restarting
    iterator; returns per-window images/s. ``consume(batch)`` is the
    rung's consumer (None: a null consumer)."""
    rates = []
    src = iter(it)
    for _ in range(reps):
        got = 0
        t0 = time.perf_counter()
        while got < n_batches * batch:
            try:
                b = next(src)
            except StopIteration:
                it.reset()
                src = iter(it)
                continue
            if consume is not None:
                consume(b)
            got += b.data[0].shape[0]
        rates.append(got / (time.perf_counter() - t0))
    return rates


def bench_iter(rec, size, batch, threads, n_batches=30, reps=5,
               wire_dtype=None, backend=None):
    """Rung B (B' with ``backend='native'``): into a null consumer."""
    it = _make_iter(rec, size, batch, threads, wire_dtype, backend)
    next(iter(it))  # warm one batch (thread spin-up)
    rates = _windows(it, batch, n_batches, reps, None)
    it.close()
    return _emit_band(
        "recorditer_imgs_per_sec", rates, "img/s",
        dict({"threads": threads, "batch": batch, "size": size,
              "wire": wire_dtype or "float32", "backend": backend or "python"},
             **_decoder(backend)))


def bench_transfer(rec, size, batch, threads, dev, n_batches=30, reps=5,
                   wire_dtype=None, backend=None):
    """Rung C (C' with ``backend='native'``): each batch through the
    device feed onto ``dev`` and its on-device wire decode, synchronized,
    nothing else."""
    import mxnet_tpu_torch as mx

    inner = _make_iter(rec, size, batch, threads, wire_dtype, backend)
    it = mx.io.DeviceFeedIter(inner, ctx=dev)

    def consume(b):
        staged = mx.io.apply_wire(b)
        for a in list(staged.data) + list(staged.label or []):
            if a.data.device != dev:
                raise RuntimeError("rung C: a batch array lies on %s, not %s"
                                   % (a.data.device, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    consume(next(iter(it)))  # warm the feed and the decode
    rates = _windows(it, batch, n_batches, reps, consume)
    it.close()
    inner.close()
    wire_mb = batch * size * size * 3 * (1 if wire_dtype == "uint8" else 4) / 1e6
    return _emit_band(
        "rec_device_put_imgs_per_sec", rates, "img/s",
        dict({"threads": threads, "batch": batch, "wire": wire_dtype or "float32",
              "backend": backend or "python", "wire_mb_per_batch": wire_mb},
             **_decoder(backend)))


def bench_overlapped(rec, size, batch, threads, dev, reps=5, wire_dtype=None,
                     feed_depth=0, backend=None):
    """Rung D: ``ImageRecordIter`` driving a small conv net's fit. The
    rate is measured per epoch (the first dropped: it builds the step),
    so one fit yields ``reps`` windows."""
    import mxnet_tpu_torch as mx

    it = _make_iter(rec, size, batch, threads, wire_dtype, backend)
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=16, kernel=(3, 3),
                             stride=(2, 2), name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(4, 4), stride=(4, 4), pool_type="max")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    ctx = mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)
    mod = mx.mod.Module(net, context=ctx)
    epoch_marks = []  # (epoch, t) per batch

    def cb(param):
        epoch_marks.append((param.epoch, time.perf_counter()))

    # verbatim save/restore of the caller's value (None: it was unset)
    old_depth = os.environ.get("MXNET_FEED_DEPTH")  # fwlint: disable=env-raw-read — restored verbatim below
    if feed_depth:
        os.environ["MXNET_FEED_DEPTH"] = str(feed_depth)
    try:
        mod.fit(it, num_epoch=reps + 1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.01},
                initializer=mx.init.Xavier(), batch_end_callback=[cb],
                force_init=True)
    finally:
        if feed_depth:
            if old_depth is None:
                os.environ.pop("MXNET_FEED_DEPTH", None)
            else:
                os.environ["MXNET_FEED_DEPTH"] = old_depth
    it.close()
    rates = []
    for epoch in range(1, reps + 1):  # epoch 0 builds the step
        marks = [t for e, t in epoch_marks if e == epoch]
        if len(marks) >= 2:
            rates.append(batch * (len(marks) - 1) / (marks[-1] - marks[0]))
    if not rates:
        raise RuntimeError("rung D: no epoch had two batches to time "
                           "(n too small for the batch)")
    fused = getattr(mod, "_fused", None) is not None
    return _emit_band(
        "rec_training_imgs_per_sec", rates, "img/s",
        dict({"threads": threads, "batch": batch,
              "wire": wire_dtype or "float32", "feed_depth": feed_depth,
              "backend": backend or "python", "fused": fused},
             **_decoder(backend)))


def _kv_split():
    """The kv_sync-vs-compute split of the rung that just ran, from the
    registry totals (on a single-process ladder the kv numbers are 0 by
    construction; the columns keep a dist ladder attributable)."""
    from .. import telemetry

    _, push = telemetry.totals("kvstore.push_latency_seconds")
    _, pull = telemetry.totals("kvstore.pull_latency_seconds")
    _, barrier = telemetry.totals("kv.barrier")
    _, overlap = telemetry.totals("kv.overlap_seconds")
    _, compute = telemetry.totals("fit.compute_seconds")
    kv_sync = max(push + pull + barrier - overlap, 0.0)
    return {"kv_sync_s": kv_sync, "kv_overlap_s": overlap,
            "compute_s": max(compute - kv_sync, 0.0)}


def _fmt_split(sp):
    return "kv %.2f / ovl %.2f / comp %.2f" % (
        sp["kv_sync_s"], sp["kv_overlap_s"], sp["compute_s"])


def _stage_p50s():
    """p50 of each pipeline stage histogram (seconds), from the registry."""
    from .. import telemetry

    out = {}
    snap = telemetry.dump(include_events=False)
    for key, h in snap.get("histograms", {}).items():
        if key.startswith("pipeline.stage_seconds") and h.get("count"):
            stage = key.split("stage=")[-1].rstrip("}")
            out[stage] = h.get("p50")
        if key.startswith("fit.data_wait_seconds") and h.get("count"):
            out["fit.data_wait"] = h.get("p50")
        if key.startswith("fit.compute_seconds") and h.get("count"):
            out["fit.compute"] = h.get("p50")
    return out


def _fmt(med, lo, hi):
    return "**%.0f** (%.0f-%.0f)" % (med, lo, hi)


def _fresh_registry():
    from .. import telemetry

    telemetry.reset()
    telemetry.enable()


def run(a, dev):
    """The whole ladder; returns the attribution table's rows."""
    workdir = a.keep or tempfile.mkdtemp(prefix="mxt_pipe_")
    rec = os.path.join(workdir, "data.rec")
    if not os.path.exists(rec):
        img_dir, lst = gen_dataset(workdir, a.n, a.size)
        rec = pack(workdir, img_dir, lst)
    else:
        img_dir = os.path.join(workdir, "imgs")
    emit("host_cpu_count", os.cpu_count(), "cores")
    _fresh_registry()
    nb = a.batches
    rows = []

    # A: raw decode capacity
    _, cv_rate = bench_decode(img_dir, n_meas=min(a.n, 200))
    rows.append(("A raw JPEG decode (cv2)", None, "%.0f" % cv_rate))

    # B: iterator -> null consumer, per thread count, then the wire
    for threads in (1, 2, 4):
        b_f = bench_iter(rec, a.size, a.batch, threads, nb, a.reps)
        if threads == 2:
            rows.append(("B decode+augment+batch -> null (2 thr, fp32)",
                         None, _fmt(*b_f)))
    b_u = bench_iter(rec, a.size, a.batch, 2, nb, a.reps, wire_dtype="uint8")
    rows.append(("B decode+augment+batch -> null (2 thr, uint8)", None,
                 _fmt(*b_u)))
    # B': the native stage at the same thread count
    b_n = bench_iter(rec, a.size, a.batch, 2, nb, a.reps,
                     wire_dtype="uint8", backend="native")
    rows.append(("B' NATIVE decode+augment+batch -> null (2 thr, uint8)",
                 None, _fmt(*b_n)))
    emit("native_vs_python_b_speedup", b_n[0] / b_u[0], "x",
         {"b_python": b_u[0], "b_native": b_n[0]})

    # C: + the device feed and the wire decode; each C/D rung starts from
    # an empty registry so its split covers that rung alone
    splits = {}
    results = {}
    for key, wire, backend in (("c_fp32", None, None), ("c_uint8", "uint8", None),
                               ("c_native", "uint8", "native")):
        _fresh_registry()
        results[key] = bench_transfer(rec, a.size, a.batch, 2, dev, nb, a.reps,
                                      wire_dtype=wire, backend=backend)
        splits[key] = _kv_split()
        emit("kv_split_" + key, 0, "s", splits[key])
    fp32_mb = a.batch * a.size * a.size * 3 * 4 / 1e6
    rows.append(("C + host->device upload (fp32, %.1f MB/batch)" % fp32_mb,
                 _fmt_split(splits["c_fp32"]), _fmt(*results["c_fp32"])))
    rows.append(("C + host->device upload (uint8, %.1f MB/batch)"
                 % (fp32_mb / 4), _fmt_split(splits["c_uint8"]),
                 _fmt(*results["c_uint8"])))
    rows.append(("C' + host->device upload (uint8, NATIVE decode)",
                 _fmt_split(splits["c_native"]), _fmt(*results["c_native"])))
    emit("native_c_vs_bprime", results["c_native"][0] / b_n[0], "x",
         {"c_native": results["c_native"][0], "b_native": b_n[0]})

    # D: the whole train step
    for key, wire, depth, backend, label in (
            ("fp32", None, 0, None, "D full train step (fp32 wire)"),
            ("uint8", "uint8", 0, None, "D full train step (uint8 wire)"),
            ("uint8_feed", "uint8", 2, None,
             "D full train step (uint8 wire + feed depth 2)"),
            ("uint8_native", "uint8", 0, "native",
             "D full train step (uint8 wire + NATIVE decode)")):
        _fresh_registry()
        d = bench_overlapped(rec, a.size, a.batch, 2, dev, a.reps,
                             wire_dtype=wire, feed_depth=depth, backend=backend)
        sp = _kv_split()
        emit("stage_p50s_" + key, 0, "s", {"p50": _stage_p50s()})
        emit("kv_split_d_" + key, 0, "s", sp)
        rows.append((label, _fmt_split(sp), _fmt(*d)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5,
                    help="measurement windows per ladder rung (median + band)")
    ap.add_argument("--batches", type=int, default=None,
                    help="batches per window of rungs B and C (default 30, "
                         "8 with --quick)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--keep", default=None,
                    help="directory to build the dataset in (reused)")
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    if a.quick:
        a.n, a.size, a.reps = 64, 96, 3
    if a.batches is None:
        a.batches = 8 if a.quick else 30
    dev = _device.resolve(a.device)
    _FIELDS.clear()
    _FIELDS.update(_device.fields(dev))
    rows = run(a, dev)
    print("\n### attribution ladder\n")
    print("| ladder rung | img/s (median, band) | kv_sync / overlap / "
          "compute (s) |")
    print("|---|---|---|")
    for name, split, val in rows:
        print("| %s | %s | %s |" % (name, val, split or "—"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
