"""Where a training step's time goes, for the PyTorch/CUDA port, on one GPU.

    python3 profile_training_torch.py

Binds the zoo Transformer-LM of ``chip_smoke.py`` (vocab 32000, 4 layers,
d 256, 4 heads, ffn 1024, seq_len 128) in a ``Module`` on ``cuda:0`` with
seeded Xavier weights and Adam at the smoke's learning rate, runs three
warm-up steps on one batch of 32 sequences of ``examples/train_lm.py``'s
synthetic stream (``chip_smoke.lm_stream``), then times 8 steps of
``forward_backward`` + ``update`` + ``update_metric`` (what
``Module.fit`` runs per batch) untraced, and the same number traced with
``torch.profiler``. Prints per step: host wall, device busy time (the
union of all kernel intervals), the device's idle share, kernel
launches, and the device time of each kernel name, largest first. Needs
CUDA; exits non-zero without it.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import TRAIN, TRAIN_LR, lm_stream
from profile_serving_torch import _device_intervals, _union_us

STEPS, BATCH, SEED = 8, 32, 0


def main():
    if not torch.cuda.is_available():
        print("profile_training_torch: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    T = TRAIN["seq_len"]
    X, Y = lm_stream(BATCH, SEED)
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=mx.cpu())],
                            [mx.nd.array(Y, ctx=mx.cpu())])
    mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.gpu(0))
    mod.bind(data_shapes=[("data", X.shape)], label_shapes=[("softmax_label", Y.shape)])
    mod.init_params(mx.init.Xavier(rng=torch.Generator().manual_seed(SEED)))
    mod.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": TRAIN_LR})
    metric = mx.metric.Perplexity(ignore_label=None)

    def step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    if not np.isfinite(metric.get()[1]):
        raise RuntimeError("non-finite training loss")
    iv = _device_intervals(prof)
    busy_ms = _union_us(iv) / 1e3 / STEPS
    by_name = {}
    for s, e, name in iv:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(card)
    print("training steps at batch %d x %d tokens, %d layers: untraced wall "
          "%.4f ms/step; traced wall %.4f ms/step, device busy %.4f ms/step "
          "(idle share %.3f), %.1f kernels/step"
          % (BATCH, T, TRAIN["num_layers"], untraced_ms, traced_ms,
             busy_ms, 1 - busy_ms / traced_ms if traced_ms else float("nan"),
             len(iv) / STEPS))
    for name, ms in top:
        print("  %9.4f ms/step  %s" % (ms, name[:100]))
    print(json.dumps({"card": card, "batch": BATCH, "steps": STEPS,
                      "untraced_ms": untraced_ms, "traced_ms": traced_ms,
                      "busy_ms": busy_ms, "kernels_per_step": len(iv) / STEPS,
                      "top": top}))
    return 0 if iv else 1


if __name__ == "__main__":
    sys.exit(main())
