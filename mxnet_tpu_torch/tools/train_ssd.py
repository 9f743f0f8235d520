"""Train SSD-300 through ``Module.fit`` — the port's twin of the JAX
package's ``examples/train_ssd.py`` (reference: example/ssd/train.py),
with its flags and defaults:

    python3 -m mxnet_tpu_torch.tools.train_ssd --evaluate

The fit is the example's: VGG16-reduced SSD-300 (``models.ssd``) over
``--num-classes`` classes, SGD lr ``--lr`` momentum 0.9 weight decay
5e-4, ``Xavier`` weights, ``MultiBoxMetric`` (cross-entropy of the
class head over the anchors that are not ignored, and the SmoothL1
localisation loss). The kvstore name goes to ``fit`` as a string
(``--kv-store device``, the default, and ``local`` on a card take the
fused step: one CUDA graph per step, the multibox matching and the NMS
inside it).

Data is the example's seeded synthetic set (numpy ``RandomState(0)``):
uniform images in [0, 1) and one to three boxes per image, labels
(n, 8, 5) rows [class, x0, y0, x1, y1] padded with -1;
``np.random`` is seeded at 0 for the iterator's shuffle and
``mx.random`` at 0. A ``--data-dir`` holding ``train.rec`` (detection
records: a label of ``[2, 5, class, x0, y0, x1, y1, ...]``, as
``im2rec --pack-label`` writes) is read through ``ImageDetRecordIter``
with the example's SSD augmentation (0.5 mirror, up to 4x zoom-out pad,
five crop samplers at the paper's IoU floors, mean subtraction), with
``--data-nthreads`` decode threads; ``--evaluate`` then reads the same
records without augmentation.

With ``--evaluate`` the trained parameters go into the inference symbol
(``get_symbol``: softmax, MultiBoxDetection) and ``MApMetric`` (IoU
0.5, score 0.1, VOC07 11-point) scores the training set, unshuffled.
The run prints one JSON line: images/s and host wall per step (median
of the steps after the first two, each synchronized), the last
CrossEntropy and SmoothL1 of the fit, the mAP with ``--evaluate``, and
where it ran (the card's ``nvidia-smi`` name and power limit). It runs
on the card unless ``--device cpu`` is given.
"""
import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.tools.train_imagenet import device_record

IMAGE_SHAPE = (3, 300, 300)
MAX_OBJECTS = 8


class MultiBoxMetric(mx.metric.EvalMetric):
    """Cross-entropy of the class head and the SmoothL1 localisation loss
    (reference: example/ssd/train/metric.py), on the host."""

    def __init__(self):
        super().__init__("MultiBox")
        self.num = 2
        self.name = ["CrossEntropy", "SmoothL1"]
        self.reset()

    def reset(self):
        self.num_inst = [0, 0]
        self.sum_metric = [0.0, 0.0]

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy()
        loc_loss = preds[1].asnumpy()
        cls_label = preds[2].asnumpy()
        valid = (cls_label >= 0).astype(np.float32)
        label = cls_label.astype(np.int64)
        prob = np.moveaxis(cls_prob, 1, -1).reshape(-1, cls_prob.shape[1])
        p = prob[np.arange(prob.shape[0]), np.maximum(label.reshape(-1), 0)]
        ce = (-np.log(np.maximum(p, 1e-10)) * valid.reshape(-1)).sum()
        self.sum_metric[0] += float(ce)
        self.num_inst[0] += int(valid.sum())
        self.sum_metric[1] += float(loc_loss.sum())
        self.num_inst[1] += int(valid.sum())

    def get(self):
        return (self.name,
                [s / n if n else float("nan") for s, n in zip(self.sum_metric, self.num_inst)])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-classes", type=int, default=20)
    ap.add_argument("--num-examples", type=int, default=32)
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.004)
    ap.add_argument("--kv-store", default="device")
    ap.add_argument("--data-dir", default="voc/")
    ap.add_argument("--data-nthreads", type=int, default=4)
    ap.add_argument("--model-prefix", default=None)
    ap.add_argument("--evaluate", action="store_true",
                    help="after training, score mAP@0.5 through "
                         "MultiBoxDetection (reference: example/ssd/"
                         "evaluate.py + eval_metric.py)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    return ap.parse_args(argv)


def synthetic_set(num_examples, num_classes):
    """The example's seeded set: (images, labels) as numpy arrays."""
    rng = np.random.RandomState(0)
    X = rng.rand(num_examples, *IMAGE_SHAPE).astype(np.float32)
    Y = -np.ones((num_examples, MAX_OBJECTS, 5), np.float32)
    for i in range(num_examples):
        for j in range(rng.randint(1, 4)):
            x0, y0 = rng.rand(2) * 0.6
            Y[i, j] = [rng.randint(0, num_classes), x0, y0,
                       x0 + 0.2 + rng.rand() * 0.2, y0 + 0.2 + rng.rand() * 0.2]
    return X, Y


def get_iter(args, shuffle=True):
    """The training iterator (the example's ``get_iter``); with
    ``shuffle`` False the same data in order without augmentation (the
    example's ``get_eval_iter``), for ``--evaluate``."""
    rec = os.path.join(args.data_dir, "train.rec")
    if os.path.exists(rec):
        if os.path.getsize(rec) == 0:
            raise MXNetError("%s: train.rec holds no records" % args.data_dir)
        common = dict(path_imgrec=rec, data_shape=IMAGE_SHAPE,
                      batch_size=args.batch_size, label_name="label",
                      mean_r=123.68, mean_g=116.779, mean_b=103.939,
                      preprocess_threads=args.data_nthreads)
        if not shuffle:
            return mx.io_image.ImageDetRecordIter(**common)
        return mx.io_image.ImageDetRecordIter(
            rand_mirror_prob=0.5,
            rand_pad_prob=0.5, max_pad_scale=4.0, fill_value=123,
            rand_crop_prob=0.833, num_crop_sampler=5,
            min_crop_scales=0.3, max_crop_scales=1.0,
            min_crop_aspect_ratios=0.5, max_crop_aspect_ratios=2.0,
            min_crop_overlaps=(0.1, 0.3, 0.5, 0.7, 0.9),
            max_crop_overlaps=1.0, max_crop_trials=50, **common)
    X, Y = synthetic_set(args.num_examples, args.num_classes)
    return mx.io.NDArrayIter({"data": X}, {"label": Y}, args.batch_size,
                             shuffle=shuffle, label_name="label")


def fit(args, batch_end_callback=()):
    """Build SSD-300 and train it as the example does; returns
    ``(module, record)``. ``batch_end_callback``: more callbacks after the
    tool's own."""
    device = mx.context.resolve(args.device)
    mx.random.seed(0)
    np.random.seed(0)
    net = ssd.get_symbol_train(num_classes=args.num_classes)
    train = get_iter(args)
    mod = mx.mod.Module(net, label_names=["label"], context=device)
    stamps = []

    def stamp(param):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stamps.append(time.perf_counter())

    metric = MultiBoxMetric()
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=args.num_epochs, kvstore=args.kv_store,
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mx.init.Xavier(),
            eval_metric=metric,
            batch_end_callback=[stamp, mx.callback.Speedometer(args.batch_size, 5)]
            + list(batch_end_callback),
            epoch_end_callback=([mx.callback.do_checkpoint(args.model_prefix)]
                                if args.model_prefix else None))
    per_step = np.diff([t0] + stamps)
    warm = min(2, len(per_step) - 1)
    step_s = float(np.median(per_step[warm:]))
    record = {
        "network": "ssd-300 vgg16-reduced", "batch_size": args.batch_size,
        "num_classes": args.num_classes, "steps": len(stamps),
        "fused": mod._fused is not None,
        "first_step_s": float(per_step[0]), "step_s": step_s,
        "images_per_sec": args.batch_size / step_s,
        "train": dict(zip(*metric.get())),
        "data": type(train).__name__,
        "device": device_record(device),
    }
    return mod, record


def evaluate(args, mod):
    """mAP@0.5 of ``mod``'s parameters over the training set in order,
    through the inference symbol (``MApMetric``, score 0.1)."""
    device = mx.context.resolve(args.device)
    det = mx.mod.Module(ssd.get_symbol(num_classes=args.num_classes),
                        label_names=None, context=device)
    det.bind(data_shapes=[("data", (args.batch_size,) + IMAGE_SHAPE)],
             for_training=False)
    det.set_params(*mod.get_params(), allow_missing=True)
    metric = mx.metric.MApMetric(ovp_thresh=0.5, score_thresh=0.1)
    for b in get_iter(args, shuffle=False):
        det.forward(b, is_train=False)
        keep = args.batch_size - b.pad     # padded rows repeat images
        metric.update([b.label[0][:keep]], [o[:keep] for o in det.get_outputs()])
    return metric.get()[1]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    mod, record = fit(args)
    if args.evaluate:
        record["mAP"] = evaluate(args, mod)
        logging.info("Train-set-mAP@0.5=%f", record["mAP"])
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
