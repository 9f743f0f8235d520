"""Serving benchmark of the port (the twin of the JAX package's
``tools/bench_serving.py``: the same workload, flags and record keys).

Drives the paged-KV continuous-batching engine offline —
no HTTP, no network jitter — over a seeded synthetic workload of
variable-length prompts, and emits ONE JSON record:

* ``decode_tokens_per_sec`` — generated tokens per second of engine wall
  (headline; read back from the ``serving.tokens_per_sec``-adjacent
  counters so the registry and the record can never disagree)
* request latency p50/p99 and TTFT p50/p99 (telemetry histograms)
* ``phases`` — per-phase p50/p99/total from the engine's phase
  attribution (queue_wait / prefill / decode / replay / compile_stall;
  serving/obs.py) with the preemption replay-overhead total — the
  before/after artifact for scheduler work
* ``slo`` — SLO attainment block (``MXNET_SERVING_SLO_TTFT_MS`` /
  ``MXNET_SERVING_SLO_TPOT_MS`` targets, good/total per phase, goodput)
* ``max_concurrent_streams`` — how many average-length streams the KV
  block pool can hold at the configured HBM budget (pool bytes), plus the
  measured peak in-flight count; with ``--prefix-len``/``--share-groups``
  (shared-prefix workload) each group's full prefix blocks are counted
  ONCE — the prefix-sharing capacity headline
* ``prefix_hit_blocks`` / ``kv_bytes_saved`` — prefill work and KV bytes
  the prefix index deduplicated; ``spec_acceptance_rate`` and the
  draft/verify wall split when ``--spec-k`` > 0
* the compile summary, read from ``stats()["compiles"]``: the bucket
  graphs captured in warmup against the replays after it — a capture
  sneaking into the timed window is visible in the record
* ``device`` — where it ran: ``torch.cuda.get_device_name`` and the
  card's name and power limit as ``nvidia-smi`` prints them (``cpu`` for
  ``--device cpu``)

The engine runs on the card unless ``--device cpu`` is given:

    python -m mxnet_tpu_torch.tools.bench_serving \\
        --requests 16 --max-new 8 --num-layers 2 --model-dim 64
"""
import argparse
import json
import subprocess
import sys
import time


def main(argv=None):
    import numpy as np

    ap = argparse.ArgumentParser(description="paged-serving benchmark")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--model-dim", type=int, default=64)
    ap.add_argument("--num-heads", type=int, default=2)
    ap.add_argument("--ffn-dim", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--kv-dtype", default="float32")
    ap.add_argument("--requests", type=int, default=32,
                    help="concurrent variable-length requests")
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens generated per request")
    ap.add_argument("--prompt-min", type=int, default=1)
    ap.add_argument("--prompt-max", type=int, default=24)
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared-prefix workload: each share group's "
                         "prompts start with the same PREFIX_LEN tokens "
                         "(block-aligned prefixes dedupe in the prefix "
                         "index when MXNET_SERVING_PREFIX_CACHE is on)")
    ap.add_argument("--share-groups", type=int, default=1,
                    help="distinct shared prefixes across the workload "
                         "(requests round-robin over the groups)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decoding: draft proposes K tokens "
                         "per step (0 = off; MXNET_SERVING_SPEC_K)")
    ap.add_argument("--draft", default=None,
                    help="draft model: 'self' or a "
                         "transformer_lm.SERVING_DRAFT_PRESETS name "
                         "(MXNET_SERVING_DRAFT)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    import torch

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(
        vocab_size=args.vocab, num_layers=args.num_layers,
        model_dim=args.model_dim, num_heads=args.num_heads,
        ffn_dim=args.ffn_dim, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.max_batch, kv_dtype=np.dtype(args.kv_dtype),
        spec_k=args.spec_k, draft=args.draft)
    engine = ServingEngine(cfg, seed=args.seed, device=args.device)

    rng = np.random.RandomState(args.seed)
    if args.prompt_min < 1:
        ap.error("--prompt-min must be >= 1 (the decoder needs a seed token)")
    pmax = min(args.prompt_max, cfg.max_len - args.max_new)
    if pmax < args.prompt_min:
        ap.error(
            "--max-new %d leaves room for prompts of at most %d tokens "
            "(--max-len %d bounds prompt+generation), below --prompt-min %d"
            % (args.max_new, max(cfg.max_len - args.max_new, 0),
               cfg.max_len, args.prompt_min))
    if args.prefix_len < 0 or args.prefix_len + args.prompt_max \
            > cfg.max_len - args.max_new:
        ap.error("--prefix-len %d + --prompt-max %d + --max-new %d exceeds "
                 "--max-len %d" % (args.prefix_len, args.prompt_max,
                                   args.max_new, cfg.max_len))
    if args.share_groups < 1:
        ap.error("--share-groups must be >= 1")
    # shared-prefix workload: request i carries group (i mod G)'s common
    # prefix followed by a private variable-length tail — with the prefix
    # cache on, every group's full prefix blocks are cached once and
    # mapped by the other members
    shared = [[int(t) for t in rng.randint(0, cfg.vocab_size,
                                           args.prefix_len)]
              for _ in range(args.share_groups)]
    prompts = [shared[i % args.share_groups]
               + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                              rng.randint(args.prompt_min,
                                                          pmax + 1))]
               for i in range(args.requests)]

    # warmup: capture EVERY shape bucket outside the timed window, without
    # submitting requests — the latency/TTFT histograms the record reads
    # must hold only timed-window samples, never the compile wall
    t0 = time.time()
    engine.warmup()
    warmup_s = time.time() - t0

    reqs = [engine.submit(p, args.max_new) for p in prompts]
    peak_inflight = 0
    t0 = time.time()
    while any(not r.finished() for r in reqs):
        engine.step()
        peak_inflight = max(peak_inflight, len(engine.scheduler.running))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.time() - t0

    gen_tokens = sum(len(r.generated) for r in reqs)
    eid = str(engine.engine_id)
    lat = telemetry.histogram("serving.request_latency_seconds", engine=eid)
    ttft = telemetry.histogram("serving.ttft_seconds", engine=eid)
    phases = engine.obs.phase_snapshot()
    pool = engine.pool
    avg_stream_tokens = (sum(len(p) for p in prompts) / len(prompts)
                         + args.max_new)
    # capacity at this HBM budget: blocks bound the streams the pool can
    # hold at once. With prefix sharing, each share group pays its full
    # prefix blocks ONCE — every member stream holds only its private
    # tail (plus the group's shared blocks, refcounted not duplicated)
    stream_blocks = pool.blocks_for(int(np.ceil(avg_stream_tokens)))
    shared_blocks_per_group = (args.prefix_len // pool.block_size
                               if cfg.prefix_cache else 0)
    private_blocks = max(stream_blocks - shared_blocks_per_group, 1)
    group_cost = args.share_groups * shared_blocks_per_group
    max_streams = int(max(pool.num_usable - group_cost, 0) // private_blocks)
    prefix = pool.prefix_stats()
    stats = engine.stats()
    spec = stats["spec"]
    rec = {
        "metric": "serving_decode_tokens_per_sec",
        "value": round(gen_tokens / wall, 2),
        "unit": "tokens/sec",
        "requests": args.requests,
        "generated_tokens": gen_tokens,
        "wall_s": round(wall, 3),
        "warmup_s": round(warmup_s, 3),
        "latency_p50_s": round(lat.percentile(50), 4),
        "latency_p99_s": round(lat.percentile(99), 4),
        "ttft_p50_s": round(ttft.percentile(50), 4),
        "ttft_p99_s": round(ttft.percentile(99), 4),
        "preemptions": engine.scheduler.preempt_count,
        # per-request phase attribution: where the latency above actually
        # went (the five phases sum to each request's end-to-end wall)
        "phases": phases,
        "replay_overhead_total_s": phases["replay"]["total_s"],
        "compile_stall_total_s": phases["compile_stall"]["total_s"],
        "slo": engine.obs.slo_snapshot(),
        "kv_pool_bytes": pool.nbytes(),
        "kv_blocks": pool.num_usable,
        "block_size": pool.block_size,
        "max_concurrent_streams": max_streams,
        "peak_inflight": peak_inflight,
        # prefix-sharing gains (tentpole artifact: hit blocks are prefill
        # work + KV bytes NOT spent; kv_bytes_saved is the live dedup)
        "prefix_hit_blocks": prefix["hit_blocks"],
        # cumulative: every hit block is one block of KV the pool never
        # had to duplicate (the gauge flavour in prefix[] is the LIVE
        # dedup, zero once the workload drains)
        "kv_bytes_saved": prefix["hit_blocks"] * pool.block_nbytes(),
        "prefix": prefix,
        # speculative decoding: acceptance rate + the decode phase's
        # draft/verify wall split
        "spec_acceptance_rate": round(spec["acceptance_rate"], 4),
        "spec_draft_s": spec["draft_seconds"],
        "spec_verify_s": spec["verify_seconds"],
        "spec": spec,
        # resilience tallies: all zero on a
        # clean offline run — a nonzero shed/timed_out/cancelled here
        # means the workload outran the engine (or a fault spec was live)
        "resilience": stats["resilience"],
        # the bucket graphs: captures (warmup) against replays (the timed
        # window); a bucket captures once, so recompile_count stays 0
        "compile": {
            "programs": len(stats["compiles"]),
            "compile_count": sum(c["count"]
                                 for c in stats["compiles"].values()),
            "compile_seconds": round(sum(g.capture_s for g in
                                         engine.bucket_graphs()), 6),
            "run_seconds": round(sum(g.run_s for g in
                                     engine.bucket_graphs()), 6),
            "recompile_count": 0,
        },
        # CUDA graphs do not outlive the process: no persistent cache
        "compile_cache": {"enabled": False, "dir": None, "aot": False,
                          "hits": 0, "misses": 0, "errors": 0},
        "device": _device_record(engine.device),
    }
    _phase_table(reqs, file=sys.stderr)
    print(json.dumps(rec))
    return rec


def _device_record(device):
    """Where the record was measured: the card's name and its
    ``nvidia-smi`` name and power limit, or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip()}


def _phase_table(reqs, file):
    """Per-request phase breakdown (stderr; stdout stays the JSON record)."""
    from mxnet_tpu_torch.serving.obs import PHASES

    cols = "  ".join("%8s" % p[:8] for p in PHASES)
    print("request          %s  %8s  pre  tok" % (cols, "e2e"), file=file)
    for r in sorted(reqs, key=lambda r: r.rid):
        ph = r.trace.phases if r.trace is not None else {}
        cells = "  ".join("%8.3f" % ph.get(p, 0.0) for p in PHASES)
        e2e = (r.finish_t - r.arrival_t) if r.finish_t else float("nan")
        print("%-16s %s  %8.3f  %3d  %3d"
              % (r.request_id, cells, e2e, r.preemptions, len(r.generated)),
              file=file)


if __name__ == "__main__":
    main()
