"""KVStore push+pull bandwidth (the port's counterpart of
``tools/bandwidth/measure.py``, reference ``tools/bandwidth/measure.py``):
time push+pull round trips of a network's gradients through a kvstore.

``local`` sums on the host, ``device`` on the first position's device,
``dist_*`` through the parameter servers (run the tool as each worker
under ``tools/launch.py``, as the port's clusters run). ``--num-devices
N`` pushes N copies of each gradient: on one card every position is
``cuda:0`` (ROADMAP C15), so the store sums N tensors on that card and no
link between cards is crossed.

It prints the JAX tool's line, with two more fields: the bytes moved per
iteration (every position's gradient read by the push and written by the
pull, ``2 * N * bytes``) and GB/s as those bytes over the time. The JAX
line's algo-bw, ``2(N-1)/N * bytes / time``, is kept for comparison; it is
0 at N = 1 and says nothing about links on one card. One JSON record
follows with the same numbers, the device, and on a card its name and
power limit. For ``local`` and ``device`` every pulled value is checked
to equal the sum pushed (the store keeps the sum: no updater is set).

    python -m mxnet_tpu_torch.tools.bandwidth --network resnet \\
        --kv-store device --num-devices 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import _device


def get_shapes(network, num_classes):
    """``[(name, shape)]`` of the network's parameters at batch 32 of
    3x224x224 images (the JAX tool's builders and shapes)."""
    from .. import models

    builders = {
        "resnet": lambda: models.resnet(num_classes=num_classes, num_layers=50,
                                        image_shape="3,224,224"),
        "alexnet": lambda: models.alexnet(num_classes=num_classes),
        "vgg": lambda: models.vgg(num_classes=num_classes, num_layers=16),
        "inception-bn": lambda: models.inception_bn(num_classes=num_classes),
    }
    net = builders[network]()
    arg_shapes, _, _ = net.infer_shape(data=(32, 3, 224, 224))
    names = net.list_arguments()
    return [(n, s) for n, s in zip(names, arg_shapes)
            if n not in ("data", "softmax_label")]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(kv_store, network="resnet", num_classes=1000, num_devices=1,
            iters=10, test_gradient_ratio=1.0, device="cuda:0"):
    """The timed push+pull loop; returns the record (see the module)."""
    import mxnet_tpu_torch as mx
    from .. import ndarray as nd

    dev = _device.resolve(device)
    ctx = mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)
    kv = mx.kv.create(kv_store)
    n = max(1, int(num_devices))
    devs = [ctx] * n

    shapes = get_shapes(network, num_classes)
    shapes.sort(key=lambda t: -int(np.prod(t[1])))
    shapes = shapes[: max(1, int(len(shapes) * test_gradient_ratio))]
    total_bytes = sum(int(np.prod(s)) * 4 for _, s in shapes)

    grads = {}
    with ctx:
        for i, (_, shape) in enumerate(shapes):
            kv.init(i, nd.zeros(shape, ctx=ctx))
            grads[i] = [nd.ones(shape, ctx=d) for d in devs]

    def check(value):
        """Every pulled array equals the sum of what was pushed."""
        if kv_store not in ("local", "device"):
            return None
        bad = [i for i, g in grads.items()
               for a in g if not bool((a.data == value).all())]
        if bad:
            raise AssertionError(
                "kvstore %s: keys %s pulled a value other than the sum %r"
                % (kv_store, bad[:5], value))
        return True

    # warm-up round (the store's first sums allocate), then its check
    for i in range(len(shapes)):
        kv.push(i, grads[i])
        kv.pull(i, grads[i])
    _sync(dev)
    checked = check(float(n))

    _sync(dev)
    tic = time.perf_counter()
    for _ in range(iters):
        for i in range(len(shapes)):
            kv.push(i, grads[i])
            kv.pull(i, grads[i])
    _sync(dev)
    elapsed = (time.perf_counter() - tic) / iters
    if checked:
        check(float(n) ** (iters + 1))

    moved = 2 * n * total_bytes
    rec = {"metric": "kvstore_push_pull", "kvstore": kv_store,
           "network": network, "devices": n, "grads": len(shapes),
           "bytes": total_bytes, "time_per_iter_ms": elapsed * 1e3,
           "bytes_moved_per_iter": moved, "gb_per_sec": moved / elapsed / 1e9,
           "algo_bw_gb_per_sec": 2 * (n - 1) / n * total_bytes / elapsed / 1e9,
           "values_checked": bool(checked), "iters": iters}
    rec.update(_device.fields(dev))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default="resnet",
                    choices=["resnet", "alexnet", "vgg", "inception-bn"])
    ap.add_argument("--kv-store", default="device")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--num-devices", type=int, default=1,
                    help="positions pushing a copy each (all on one device)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--test-gradient-ratio", type=float, default=1.0,
                    help="fraction of largest grads to test")
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    rec = measure(a.kv_store, a.network, a.num_classes, a.num_devices, a.iters,
                  a.test_gradient_ratio, a.device)
    print("kvstore=%s devices=%d grads=%d bytes=%.1fMB time/iter=%.1fms "
          "algo-bw=%.2fGB/s moved=%.1fMB/iter bw=%.2fGB/s"
          % (rec["kvstore"], rec["devices"], rec["grads"], rec["bytes"] / 1e6,
             rec["time_per_iter_ms"], rec["algo_bw_gb_per_sec"],
             rec["bytes_moved_per_iter"] / 1e6, rec["gb_per_sec"]), flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
