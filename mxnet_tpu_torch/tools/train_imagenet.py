"""Train an ImageNet-1k classifier of the zoo through ``Module.fit`` — the
port's twin of the JAX package's ``examples/train_imagenet.py``
(reference: example/image-classification/train_imagenet.py and
common/fit.py), with its flags:

    python3 -m mxnet_tpu_torch.tools.train_imagenet --network alexnet

``--network`` picks any zoo network (resnet, resnext, inception-bn,
inception-v3, inception-resnet-v2, googlenet, vgg, alexnet, lenet, mlp);
the fit is the example's: SGD with momentum 0.9 and weight decay 1e-4, a
``MultiFactorScheduler`` dividing the rate by ``--lr-factor`` at each of
``--lr-step-epochs`` (fractions of an epoch allowed), Xavier(gaussian,
in, 2) weights, ``acc`` and top-5 accuracy, ``--dtype bfloat16`` through
the module's float32-master mixed precision. The kvstore name goes to
``fit`` as a string (``--kv-store device``, the default, and ``local`` on
a card take the fused step: one CUDA graph per input shape).

With a ``--data-dir`` holding ``train.rec`` (and optionally
``val.rec``; pack them with ``tools/im2rec.py``) the data comes through
``ImageRecordIter`` with the example's flags: a random 224 crop (or the
``--image-shape``) and a random mirror for training, the centre crop for
validation, ``--rgb-mean``/``--rgb-std`` applied on the device over the
uint8 wire (inside the fused step's CUDA graph) and ``--data-nthreads``
decode threads: on the native stage, which reads the file in order, or,
with a ``train.idx`` beside it, shuffled on the Python pipeline. On a card the training batches go through ``io.DeviceFeedIter``
(pinned buffers, a side stream).

Otherwise data is synthetic and seeded (as is ``mx.random``, at 0): images whose
label sets a per-class mean (a coarse 7x7 grid of +-0.25 colour blocks
drawn per class) plus N(0, 0.25^2) noise, made once, in bulk, on the
device, so the loss falls and top-5 accuracy rises within a short run
(top-1 of a 1000-way head barely moves in 30 steps).

The run prints one JSON line: images/s and host wall per step (median of
the steps after the first two, each synchronized), the train metrics the
fit ends with (since the Speedometer's last line, which resets them),
the last validation metrics, and where it ran (the card's ``nvidia-smi``
name and power limit). It runs on the card unless ``--device cpu`` is
given.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native, models
from mxnet_tpu_torch.base import MXNetError

NETWORKS = {
    "resnet": lambda a: models.resnet(num_classes=a.num_classes,
                                      num_layers=a.num_layers,
                                      image_shape=a.image_shape),
    "resnext": lambda a: models.resnext(num_classes=a.num_classes,
                                        num_layers=a.num_layers,
                                        image_shape=a.image_shape,
                                        num_group=a.num_group),
    "inception-bn": lambda a: models.inception_bn(num_classes=a.num_classes),
    "inception-v3": lambda a: models.inception_v3(num_classes=a.num_classes),
    "inception-resnet-v2": lambda a: models.inception_resnet_v2(
        num_classes=a.num_classes),
    "googlenet": lambda a: models.googlenet(num_classes=a.num_classes),
    "vgg": lambda a: models.vgg(num_classes=a.num_classes,
                                num_layers=a.num_layers),
    "alexnet": lambda a: models.alexnet(num_classes=a.num_classes),
    "lenet": lambda a: models.lenet(num_classes=a.num_classes),
    "mlp": lambda a: models.mlp(num_classes=a.num_classes),
}

#: the per-class mean is a GRID x GRID layout of colour blocks of
#: +-AMPLITUDE, the noise N(0, NOISE**2); at +-1 and N(0, 1) AlexNet,
#: vgg-16 and googlenet reached a NaN loss within a few steps at the
#: example's lr 0.1 on an H100
GRID = 7
AMPLITUDE = 0.25
NOISE = 0.25


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default="resnet", choices=sorted(NETWORKS))
    ap.add_argument("--num-layers", type=int, default=50)
    ap.add_argument("--num-group", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--num-examples", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr-factor", type=float, default=0.1)
    ap.add_argument("--lr-step-epochs", default="30,60,90")
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--kv-store", default="device")
    ap.add_argument("--data-dir", default="imagenet/")
    ap.add_argument("--data-nthreads", type=int, default=4)
    ap.add_argument("--rgb-mean", default="123.68,116.779,103.939")
    ap.add_argument("--rgb-std", default="1,1,1")
    ap.add_argument("--model-prefix", default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--disp-batches", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    return ap.parse_args(argv)


class SyntheticImageIter(mx.io.DataIter):
    """``num_batches`` seeded batches held on ``device``: label ``y``
    uniform over the classes, image = class ``y``'s mean + N(0, NOISE^2)
    noise, the mean a GRID x GRID grid of +-AMPLITUDE blocks per channel,
    drawn per class.
    Made in bulk once; each epoch walks the batches in order."""

    def __init__(self, batch_size, data_shape, num_classes, num_batches,
                 device):
        super().__init__(batch_size)
        gen = torch.Generator(device=device).manual_seed(0)
        n = batch_size * num_batches
        c, h, w = data_shape
        codes = (torch.randint(0, 2, (num_classes, c, GRID, GRID),
                               generator=gen, device=device).float() * 2 - 1
                 ) * AMPLITUDE
        labels = torch.randint(0, num_classes, (n,), generator=gen,
                               device=device)
        means = torch.nn.functional.interpolate(codes[labels], size=(h, w),
                                                mode="nearest")
        noise = torch.randn((n, c, h, w), generator=gen, device=device) * NOISE
        self._data = (means + noise).reshape(num_batches, batch_size, c, h, w)
        self._label = labels.float().reshape(num_batches, batch_size)
        self.provide_data = [mx.io.DataDesc("data", (batch_size,) + tuple(data_shape))]
        self.provide_label = [mx.io.DataDesc("softmax_label", (batch_size,))]
        self._n = num_batches
        self._i = 0

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self._n:
            raise StopIteration
        i = self._i
        self._i += 1
        return mx.io.DataBatch(data=[mx.nd.NDArray(self._data[i])],
                               label=[mx.nd.NDArray(self._label[i])], pad=0)


def record_iters(args, data_shape, device):
    """(train, val) over ``--data-dir``'s ``train.rec`` and ``val.rec``
    (val None without one), with the example's augmentation and the
    mean/std on the uint8 wire; on a card the training batches are fed
    through a ``DeviceFeedIter``."""
    if os.path.getsize(os.path.join(args.data_dir, "train.rec")) == 0:
        raise MXNetError("%s: train.rec holds no records" % args.data_dir)
    mean = [float(x) for x in args.rgb_mean.split(",")]
    std = [float(x) for x in args.rgb_std.split(",")]
    common = dict(data_shape=data_shape, batch_size=args.batch_size,
                  mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
                  std_r=std[0], std_g=std[1], std_b=std[2],
                  preprocess_threads=args.data_nthreads)
    # a train.idx lets the Python pipeline shuffle; without one the native
    # stage (where its gate passes) reads the file in order
    idx = os.path.join(args.data_dir, "train.idx")
    shuffled = os.path.exists(idx)
    train = mx.io_image.ImageRecordIter(
        path_imgrec=os.path.join(args.data_dir, "train.rec"),
        path_imgidx=idx if shuffled else None, shuffle=shuffled,
        rand_crop=True, rand_mirror=True, **common)
    if device.type == "cuda":
        train = mx.io.DeviceFeedIter(train, ctx=device)
    val_rec = os.path.join(args.data_dir, "val.rec")
    val = (mx.io_image.ImageRecordIter(path_imgrec=val_rec, **common)
           if os.path.exists(val_rec) else None)
    return train, val


def make_iters(args, data_shape, device):
    """(train, val): the records of ``--data-dir`` when it holds
    ``train.rec``, else the synthetic batches and the first four of them
    as the validation set (the JAX example's fallback takes its first
    four batches too)."""
    if os.path.exists(os.path.join(args.data_dir, "train.rec")):
        return record_iters(args, data_shape, device)
    num_batches = max(args.num_examples // args.batch_size, 1)
    train = SyntheticImageIter(args.batch_size, data_shape, args.num_classes,
                               num_batches, device)
    val = SyntheticImageIter(args.batch_size, data_shape, args.num_classes,
                             min(4, num_batches), device)
    return train, val


def lr_schedule(args, epoch_size):
    """The example's MultiFactorScheduler over ``--lr-step-epochs``, each
    a (possibly fractional) number of epochs of ``epoch_size`` updates;
    None without steps."""
    steps = [int(float(e) * epoch_size) for e in args.lr_step_epochs.split(",")
             if e.strip()]
    if not steps:
        return None
    return mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                factor=args.lr_factor)


def device_record(device):
    """Where the run was measured: the card's name and its ``nvidia-smi``
    name and power limit, or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip()}


def data_record(train):
    """Where the batches came from: the iterator, and for records the
    pipeline's backend, decoder and decode threads."""
    inner = getattr(train, "_iter", train)
    if not isinstance(inner, mx.io_image.ImageRecordIter):
        return {"source": type(inner).__name__}
    native = inner._native is not None
    return {"source": "ImageRecordIter",
            "backend": "native" if native else "python",
            "decoder": (_native.decoder() if native
                        else mx.image.python_decoder()),
            "threads": inner.preprocess_threads,
            "wire": "uint8" if inner._wire is not None else "float32",
            "feed": type(train).__name__}


def fit(args, batch_end_callback=(), eval_data=True):
    """Build the network and train it as the example does; returns
    ``(module, record)``. ``batch_end_callback``: more callbacks after the
    tool's own; ``eval_data`` False skips the per-epoch validation."""
    device = mx.context.resolve(args.device)
    mx.random.seed(0)
    data_shape = tuple(int(x) for x in args.image_shape.split(","))
    net = NETWORKS[args.network](args)
    train, val = make_iters(args, data_shape, device)
    epoch_size = max(args.num_examples // args.batch_size, 1)
    sched = lr_schedule(args, epoch_size)
    mod = mx.mod.Module(net, context=device,
                        compute_dtype=("bfloat16" if args.dtype == "bfloat16"
                                       else None))
    stamps = []

    def stamp(param):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stamps.append(time.perf_counter())

    metric = mx.metric.create(["acc", mx.metric.TopKAccuracy(top_k=5)])
    val_metric = mx.metric.create(["acc", mx.metric.TopKAccuracy(top_k=5)])
    callbacks = [stamp, mx.callback.Speedometer(args.batch_size,
                                                args.disp_batches)]
    callbacks += list(batch_end_callback)
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val if eval_data and val is not None else None,
            num_epoch=args.num_epochs, kvstore=args.kv_store, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched},
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2),
            batch_end_callback=callbacks,
            epoch_end_callback=([mx.callback.do_checkpoint(args.model_prefix)]
                                if args.model_prefix else None),
            eval_metric=metric, validation_metric=val_metric)
    per_step = np.diff([t0] + stamps)
    warm = min(2, len(per_step) - 1)
    step_s = float(np.median(per_step[warm:]))
    record = {
        "network": args.network, "batch_size": args.batch_size,
        "image_shape": args.image_shape, "dtype": args.dtype,
        "steps": len(stamps), "fused": mod._fused is not None,
        "first_step_s": float(per_step[0]), "step_s": step_s,
        "images_per_sec": args.batch_size / step_s,
        "train": dict(metric.get_name_value()),
        "val": (dict(val_metric.get_name_value())
                if eval_data and val is not None else None),
        "data": data_record(train),
        "device": device_record(device),
    }
    # the pipelines' threads stop here: a decode thread left prefetching
    # calls the CUDA runtime while a later step of this process is
    # captured into a CUDA graph, which ends the capture
    for it in (train, val):
        close_iter(it)
    return mod, record


def close_iter(it):
    """Stop ``it``'s threads: a device feed's and those of the iterator it
    feeds from (an iterator without threads is left alone)."""
    for obj in (it, getattr(it, "_iter", None)):
        if obj is not None and callable(getattr(obj, "close", None)):
            obj.close()


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    _, record = fit(args)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
