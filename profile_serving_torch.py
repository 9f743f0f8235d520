"""Where a serving step's time goes, for the PyTorch/CUDA port, on one GPU.

    python3 profile_serving_torch.py [--steps 8] [--batch 32] [--seed 0]

Builds the zoo Transformer-LM engine of ``chip_smoke.py`` (vocab 32000, 4
layers, d 256, 4 heads, ffn 1024, max_len 128; pool bs 16, 257 blocks)
with random weights, admits ``--batch`` requests (prompt lengths 1..64,
enough new tokens to keep decoding), steps until every request has been
prefilled, and then traces ``--steps`` decode-only engine steps with
``torch.profiler``. Prints, per decode step: host wall, device busy time
(the union of all kernel intervals), the device's idle share, kernel
launches, and the device time of each kernel name, largest first. A
second, untraced window of the same length gives the step wall without
profiler overhead. Needs CUDA; exits non-zero without it.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _device_intervals(prof):
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == cuda and e.time_range.end \
                > e.time_range.start:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def _union_us(intervals):
    total, end = 0.0, None
    for s, e, _ in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving_torch: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.serving import ServingConfig, ServingEngine
    from mxnet_tpu_torch.serving import model as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = ServingConfig(vocab_size=32000, num_layers=4, model_dim=256,
                        num_heads=4, ffn_dim=1024, max_len=128,
                        block_size=16, num_blocks=257, max_batch=32,
                        prefills_per_step=args.batch, prefix_cache=False,
                        max_queue=0, default_timeout_ms=0)
    eng = ServingEngine(cfg, arg_params=M.random_params(cfg, args.seed),
                        device="cuda")
    eng.warmup()
    rng = np.random.RandomState(args.seed)
    n_new = 2 * args.steps + 4
    for n in rng.randint(1, 65, args.batch):
        eng.submit([int(t) for t in rng.randint(0, cfg.vocab_size, n)],
                   n_new)
    eng.step()                                  # every prefill + 1 decode
    if eng.scheduler.waiting:
        raise RuntimeError("not every request was admitted in one step")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    iv = _device_intervals(prof)
    busy_ms = _union_us(iv) / 1e3 / args.steps
    by_name = {}
    for s, e, name in iv:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(card)
    print("decode steps at batch %d, %d layers: untraced wall %.4f ms/step; "
          "traced wall %.4f ms/step, device busy %.4f ms/step (idle share "
          "%.3f), %.1f kernels/step"
          % (args.batch, cfg.num_layers, untraced_ms, traced_ms, busy_ms,
             1 - busy_ms / traced_ms if traced_ms else float("nan"),
             len(iv) / args.steps))
    for name, ms in top:
        print("  %9.4f ms/step  %s" % (ms, name[:100]))
    print(json.dumps({"card": card, "batch": args.batch,
                      "steps": args.steps, "untraced_ms": untraced_ms,
                      "traced_ms": traced_ms, "busy_ms": busy_ms,
                      "kernels_per_step": len(iv) / args.steps,
                      "top": top}))
    return 0 if iv else 1


if __name__ == "__main__":
    sys.exit(main())
