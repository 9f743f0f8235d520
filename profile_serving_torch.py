"""Where a serving step's time goes, for the PyTorch/CUDA port, on one GPU.

    python3 profile_serving_torch.py [--steps 8] [--batch 32] [--seed 0]
                                     [--spec-k 3] [--draft small]

Builds the zoo Transformer-LM engine of ``chip_smoke.py`` (vocab 32000, 4
layers, d 256, 4 heads, ffn 1024, max_len 128; pool bs 16, 257 blocks)
with random weights, captures every bucket's CUDA graph (``warmup()``),
admits ``--batch`` requests (prompt lengths 1..48, enough new tokens to
keep decoding), steps until every request has been prefilled, and then
traces ``--steps`` engine steps with ``torch.profiler`` — each a replay
of the decode graph at the batch bucket. A second engine does the same
with speculative decoding (``--spec-k`` draft proposals from ``--draft``:
k + 1 replays of the draft's decode graph and one of the verify graph per
step), and then the verify graph alone is replayed ``--steps`` times at
the running streams' next window. Prints, per step (or verify replay):
host wall, device busy time (the union of all kernel intervals), the
device's idle share, kernels, and the device time of each kernel name,
largest first. A second, untraced window of the same length gives the
step wall without profiler overhead. Needs CUDA; exits non-zero without
it or when the profiler sees no kernel.
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


def _window(step, n):
    """Untraced and traced wall per call of ``step`` (ms), device busy per
    call (ms), kernels per call and device ms per kernel name."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    iv = _device_intervals(prof)
    busy_ms = _union_us(iv) / 1e3 / n
    by_name = {}
    for s, e, name in iv:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"untraced_ms": untraced_ms, "traced_ms": traced_ms,
            "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / traced_ms if traced_ms else None,
            "kernels_per_step": len(iv) / n, "top": top}


def _report(label, r):
    print("%s: untraced wall %.4f ms; traced wall %.4f ms, device busy "
          "%.4f ms (idle share %.3f), %.1f kernels"
          % (label, r["untraced_ms"], r["traced_ms"], r["busy_ms"],
             r["idle_share"], r["kernels_per_step"]))
    for name, ms in r["top"]:
        print("  %9.4f ms  %s" % (ms, name[:100]))


def _engine(S, M, args, **over):
    cfg = S.ServingConfig(vocab_size=32000, num_layers=4, model_dim=256,
                          num_heads=4, ffn_dim=1024, max_len=128,
                          block_size=16, num_blocks=257, max_batch=32,
                          prefills_per_step=args.batch, prefix_cache=False,
                          max_queue=0, default_timeout_ms=0, **over)
    eng = S.ServingEngine(cfg, arg_params=M.random_params(cfg, args.seed),
                          device="cuda")
    eng.warmup()
    rng = np.random.RandomState(args.seed)
    n_new = cfg.max_len - 48
    for n in rng.randint(1, 49, args.batch):
        eng.submit([int(t) for t in rng.randint(0, cfg.vocab_size, n)],
                   n_new)
    eng.step()                                  # every prefill + 1 step
    if eng.scheduler.waiting:
        raise RuntimeError("not every request was admitted in one step")
    return eng, cfg


def _verify_call(eng, cfg):
    """The verify graph at the running streams' next window (the call an
    engine step makes after the draft's proposals; the pending token in
    every lane)."""
    reqs = list(eng.scheduler.running)
    B = min(b for b in cfg.decode_buckets() if b >= len(reqs))
    T = cfg.spec_k + 1
    nb = cfg.max_len // cfg.block_size
    toks = np.zeros((B, T), np.int32)
    poss = np.zeros((B, T), np.int32)
    ctx = np.ones((B, T), np.int32)
    tables = np.zeros((B, nb), np.int32)
    for i, r in enumerate(reqs):
        toks[i] = r.pending_token
        poss[i] = min(r.context_len, cfg.max_len - T) + np.arange(T)
        ctx[i] = poss[i] + 1
        tables[i, :min(len(r.blocks), nb)] = r.blocks[:nb]
    g = eng._verify_graphs[B]
    return lambda: g(toks, poss, tables, ctx)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=3)
    ap.add_argument("--draft", default="small")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving_torch: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import serving as S
    from mxnet_tpu_torch.serving import model as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "batch": args.batch, "steps": args.steps}
    eng, cfg = _engine(S, M, args, spec_k=0)
    out["decode"] = _window(eng.step, args.steps)
    _report("decode step at batch %d (a replay of the decode graph)"
            % args.batch, out["decode"])
    del eng
    eng, cfg = _engine(S, M, args, spec_k=args.spec_k, draft=args.draft)
    out["speculative"] = _window(eng.step, args.steps)
    _report("speculative step at batch %d, spec_k %d, draft %s (%d draft "
            "replays + 1 verify replay)" % (args.batch, args.spec_k,
                                            args.draft, args.spec_k + 1),
            out["speculative"])
    out["verify"] = _window(_verify_call(eng, cfg), args.steps)
    _report("verify graph alone at batch %d, T %d" % (args.batch,
                                                      args.spec_k + 1),
            out["verify"])
    out["compiles"] = eng.stats()["compiles"]
    print(json.dumps(out))
    return 0 if all(out[k]["kernels_per_step"] for k in
                    ("decode", "speculative", "verify")) else 1


if __name__ == "__main__":
    sys.exit(main())
