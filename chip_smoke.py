"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch`` (never the JAX package) on ``cuda:0``:

1. device — requires CUDA; prints the card's name and power limit, the
   torch and CUDA versions;
2. build — compiles every hand-written kernel from
   ``mxnet_tpu_torch/csrc`` with ``nvcc`` (one process per source, all
   started together) and prints the ptxas report;
3. kernels vs plain — each kernel's wrapper on card tensors against its
   plain PyTorch version on the same inputs, at the main paths' shapes,
   with stated tolerances: the flash forward at every serving bucket
   (16-row q-tiles), the training shape and wide grids at D 32, 64 and
   128 (64-row q-tiles), f32 and bf16, at D 136 and 256 in f32, bf16 and
   f16, f16 at the training shape and b*h 70000 with a short sequence;
   the paged kernel also against poisoned unreferenced slots and for
   batch invariance (bitwise), at D 8, 136, 256, 512 and 4096, pool blocks of
   32 and 512 and f16 pages besides the serving shape; the multi-query
   paged kernel at T 1, 2, 4, 8, 16, 17 and 32 (pool blocks of 16), bf16
   pages in blocks of 64, a table of 8200 slots, D 256 in blocks of 512
   and edge cases, each lane bitwise equal to the single-query kernel at
   its context, batch-invariant, and NaN past an out-of-range block id;
   the two flash-backward kernels through the autograd Function (D 136
   and 256 in f32, bf16 and f16, f16 at the training shape), and bitwise
   equal across two launches;
4. serving — the zoo Transformer-LM at full width (vocab 32000, 4 layers,
   d 256, 4 heads, ffn 1024, max_len 128; pool bs 16, 257 blocks, batch
   32) with seeded random weights: ``warmup()``, then 32 seeded requests
   through ``submit``/``step`` until all finish, with the kernels' launch
   counters set to 0 just before and read just after; then a
   teacher-forced check of prefill + decode logits on the card against
   the same port functions on CPU tensors;
5. training — the same model trained through ``Module.fit`` on the card
   (Adam, lr 1e-3, seeded Xavier, ``Perplexity``) for 5 epochs of 4
   batches of 32 sequences of ``examples/train_lm.py``'s synthetic
   stream, launch counters set to 0 just before ``fit`` and read just
   after: every loss finite, perplexity falling every epoch and ending
   below half the vocabulary (uniform guessing), and exactly one launch
   of each attention kernel per layer and step;
6. one training step, card vs CPU — ``forward_backward`` of one batch of
   4 sequences from the same parameters on ``gpu(0)`` and on ``cpu()``
   (plain versions): outputs (relative to the largest probability) and
   every parameter's gradient compared;
7. speculative serving from a checkpoint — phase 5's trained module
   written with ``Module.save_checkpoint`` into a temporary directory and
   read back with ``mx.model.load_checkpoint`` (bit for bit), then served
   at phase 4's width and prompt mix four times: target-only
   (``spec_k`` 0), ``spec_k`` 3 with the ``small`` draft and with the
   ``self`` draft, and ``spec_k`` 16 with the ``self`` draft (17 verify
   lanes). The four token streams must be equal (else the first
   diverging request and position and the target's top-2 logit margin
   there are printed, and the run fails); launch counts exact per run
   (the multi-query kernel once per target layer and speculative step,
   the single-query one once per draft layer and draft step, the flash
   forward once per target and draft layer and prefill); acceptance rate,
   tokens/s, TTFT and the draft/verify wall split printed;
8. times — each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls), timed
   with CUDA events while the stream is held by a sleep so host launch
   overhead is hidden, beside the card's bound for the same work (the
   flash forward's and backward's operations at their split-TF32
   tensor-core rates, the others' at the float32 rate); the paged kernel
   also at contexts 1024 and 4096 for B 32 and B 1 (printed lines); the
   device kernels that the flash-forward and multi-query yardsticks
   launch are printed (one ``torch.profiler`` pass each).

Every phase that fails raises, so the exit code is not 0. The last two
lines are the ``kernels`` JSON object and the ``ok`` JSON object; the card
line comes just before them.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 outside the tensor cores, and the flash kernels' rates on the
# 495 TFLOP/s TF32 tensor cores over the mean number of TF32 products they
# issue per operation in float32: the forward's Q.K^T six (an exact
# split), P.V three (3xTF32), 4.5 on average; the backward's dK/dV kernel
# S six, dP, dV and dK three each, (6+3+3+3)/4 = 3.75; its dQ kernel S
# six, dP and dQ three each, (6+3+3)/3 = 4
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_K1_FLOPS = 495e12 / 4.5
PEAK_K2A_FLOPS = 495e12 / 3.75
PEAK_K2B_FLOPS = 495e12 / 4

F32_TOL = 1e-4    # float32: only the summation order differs
BF16_TOL = 2e-2   # bf16 inputs, float32 compute on both sides
# f16 inputs are exact in float32 and the flash forward returns float32, so
# only the summation order differs, as for float32 inputs; f16 gradients
# are rounded to f16 (11 bits) on both sides, so one may land a step
# apart: held relative to the largest, as bf16's are
F16_REL_TOL = 2e-3
# bf16 gradients: both sides compute in float32 and round to bf16 (8 bits),
# so a value may land one bf16 step apart; held relative to the largest
BF16_REL_TOL = 1e-2
LOGIT_TOL = 1e-3  # whole model, float32, card vs CPU summation order
# one training step, card vs CPU: max |p_card - p_cpu| / max |p_cpu| over
# the SoftmaxOutput probabilities (32000 classes: a typical value is
# ~3e-5, so an absolute limit would hold nothing)
OUT_REL_TOL = 1e-5
# one training step, card vs CPU: max |g_card - g_cpu| / max |g_cpu| per
# parameter; float32 with another summation order through 4 layers and a
# 32000-way softmax
GRAD_TOL = 1e-3

TRAIN = dict(vocab_size=32000, num_layers=4, model_dim=256, num_heads=4,
             ffn_dim=1024, seq_len=128)
# Adam's learning rate for the training phase: at 3e-3 (the example's
# default) the perplexity of this 4-batch recipe rises in some epochs
TRAIN_LR = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
_CYCLES_PER_MS = None


def _cycles_per_ms():
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        cycles = 50_000_000
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS = cycles / a.elapsed_time(b)
    return _CYCLES_PER_MS


def device_ms(fn, n=100):
    """Device time of one ``fn()`` call: the mean over ``n`` back-to-back
    calls between two CUDA events, with the stream held by a sleep kernel
    while the host enqueues them (so the launches run back to back and
    the host's launch overhead is not in the number). Warm L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_cycles_per_ms() * (2.0 * n * host_ms + 5.0)))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_kernels(fn):
    """Names of the device kernels one ``fn()`` call launches (one
    ``torch.profiler`` pass): what a library yardstick really runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:   # the profiler is a log line, not a check
        return ["(profiler failed: %s)" % e]
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    return names or ["(the profiler saw no device kernel)"]


# ---------------------------------------------------------------- kernels
def flash_inputs(rng, b, h, sq, sk, d, dtype):
    def t(s):
        return torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
            np.float32)).to("cuda", dtype)
    return t(sq), t(sk), t(sk)


def check_flash(A):
    """K1 against its plain version: the serving buckets (S 16..128, B 1:
    16-row q-tiles), the training shape and wide grids at D 32, 64 and 128
    (64-row q-tiles), ragged and sq != sk cases, f32 and bf16."""
    rng = np.random.default_rng(0)
    worst = {}
    cases = [(1, 4, s, s, 64, True, torch.float32) for s in (16, 32, 64, 128)]
    cases += [(32, 4, 128, 128, 64, True, torch.float32),     # training
              (32, 4, 128, 128, 64, True, torch.bfloat16),
              (32, 4, 100, 100, 32, False, torch.float32),
              (16, 8, 128, 128, 128, True, torch.float32),
              (2, 4, 96, 96, 32, True, torch.float32),
              (2, 2, 70, 70, 128, False, torch.float32),
              (2, 4, 80, 80, 64, False, torch.bfloat16),
              (2, 4, 48, 80, 64, False, torch.float32),
              (2, 4, 48, 80, 64, True, torch.float32),
              (1, 2, 100, 37, 128, True, torch.bfloat16),
              (32, 4, 128, 128, 64, True, torch.float16),     # training
              (35000, 2, 16, 16, 32, True, torch.float32)]    # b*h 70000
    # head dimensions past 128 (k-steps of 32), in every dtype
    cases += [(2, 2, 70, 70, d, causal, dt) for d in (136, 256)
              for causal, dt in ((True, torch.float32), (False, torch.float32),
                                 (True, torch.bfloat16),
                                 (True, torch.float16))]
    cases += [(16, 8, 128, 128, 256, True, torch.float32)]   # 64-row tiles
    for b, h, sq, sk, d, causal, dt in cases:
        q, k, v = flash_inputs(rng, b, h, sq, sk, d, dt)
        out, lse = A.flash_attention_forward(q, k, v, causal)
        ref_out, ref_lse = A._flash_forward_plain(q, k, v, causal,
                                                  1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        log("  flash_fwd b=%d h=%d sq=%d sk=%d d=%d causal=%d %s: "
            "max_abs_err %.3e (tol %.0e)" % (b, h, sq, sk, d, causal,
                                             str(dt)[6:], err, tol))
        check(torch.isfinite(out).all().item(), "flash out not finite")
        check(err <= tol, "flash_fwd disagrees with its plain version")
        worst[dt] = max(worst.get(dt, 0.0), err)
    return worst


def paged_inputs(rng, B, dtype, lens, N=257, bs=16, H=4, D=64, nb=8):
    """Paged inputs: q of lens' shape + (H, D) f32 — (B,H,D) for one query
    per sequence, (B,T,H,D) for T lanes — pages (N,bs,H,D) in ``dtype``,
    distinct live blocks per sequence, lens int32 as given."""
    q = torch.from_numpy(rng.standard_normal(np.shape(lens) + (H, D)).astype(
        np.float32)).cuda()
    kp = torch.from_numpy(rng.standard_normal((N, bs, H, D)).astype(
        np.float32)).to("cuda", dtype)
    vp = torch.from_numpy(rng.standard_normal((N, bs, H, D)).astype(
        np.float32)).to("cuda", dtype)
    # distinct live blocks per sequence (no block appears twice)
    blocks = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    bt = torch.from_numpy(blocks.astype(np.int32)).cuda()
    cl = torch.from_numpy(np.asarray(lens, np.int32)).cuda()
    return q, kp, vp, bt, cl


def poison_unreferenced(kp, vp, bt, cl):
    """+1e30 in K and -1e30 in V at every (block, slot) no live position
    of any table reads (float16 pages: +-6e4, near its largest)."""
    bs = kp.shape[1]
    tables, lens = bt.cpu().numpy(), cl.cpu().numpy()
    live = np.zeros(kp.shape[:2], bool)
    for b in range(tables.shape[0]):
        pos = np.arange(min(int(lens[b]), tables.shape[1] * bs))
        live[tables[b, pos // bs], pos % bs] = True
    live = torch.from_numpy(live).to(kp.device)
    big = 6e4 if kp.dtype == torch.float16 else 1e30
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[~live] = big
    vp2[~live] = -big
    return kp2, vp2


def check_paged(A):
    rng = np.random.default_rng(1)
    worst = {}
    for B in (1, 8, 32):
        lens = ([17, 0, 1, 16, 128]
                + [int(x) for x in rng.integers(0, 129, B)])[:B]
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, cl = paged_inputs(rng, B, dt, lens)
            out = A.paged_attention(q, kp, vp, bt, cl)
            ref = A.paged_attention_reference(q, kp, vp, bt, cl)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            log("  paged_decode B=%d pages %s lens %s...: max_abs_err %.3e "
                "(tol %.0e)" % (B, str(dt)[6:], lens[:6], err, tol))
            check(err <= tol, "paged_decode disagrees with its plain version")
            zero_rows = cl == 0
            check(bool((out[zero_rows] == 0).all()),
                  "context_len 0 must give exactly 0")
            kp2, vp2 = poison_unreferenced(kp, vp, bt, cl)
            out2 = A.paged_attention(q, kp2, vp2, bt, cl)
            check(torch.equal(out, out2),
                  "unreferenced slots leaked into the output")
            worst[dt] = max(worst.get(dt, 0.0), err)
            if B == 32:
                for b in range(B):
                    one = A.paged_attention(q[b:b + 1], kp, vp, bt[b:b + 1],
                                            cl[b:b + 1])
                    check(torch.equal(one[0], out[b]),
                          "row %d differs between B=32 and B=1 launches" % b)
                log("  paged_decode B=32 %s: every row bitwise equal to its "
                    "B=1 launch; poisoned slots changed nothing"
                    % str(dt)[6:])
    # the envelope past the serving shape: (B, D, bs, nb, page dtype);
    # contexts up to the table's end, 0 and one block's worth among them
    for B, D, bs, nb, dt in ((8, 8, 16, 8, torch.float32),
                             (8, 136, 16, 8, torch.float32),
                             (8, 256, 16, 8, torch.float32),
                             (4, 512, 16, 8, torch.float32),
                             (3, 4096, 16, 2, torch.float32),  # widest
                             (8, 64, 32, 6, torch.float32),
                             (6, 64, 512, 3, torch.float32),
                             (8, 64, 16, 8, torch.float16),
                             (6, 256, 512, 2, torch.bfloat16)):
        lens = [0, bs, nb * bs] + [int(x) for x in
                                   rng.integers(1, nb * bs + 1, B - 3)]
        q, kp, vp, bt, cl = paged_inputs(rng, B, dt, lens, N=B * nb + 1,
                                         bs=bs, D=D, nb=nb)
        out = A.paged_attention(q, kp, vp, bt, cl)
        ref = A.paged_attention_reference(q, kp, vp, bt, cl)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # the pages' values are exact in float32 on both sides
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        log("  paged_decode B=%d D=%d bs=%d nb=%d pages %s: max_abs_err %.3e "
            "(tol %.0e)" % (B, D, bs, nb, str(dt)[6:], err, tol))
        check(err <= tol, "paged_decode disagrees with its plain version")
        check(bool((out[cl == 0] == 0).all()), "context_len 0 must give 0")
        kp2, vp2 = poison_unreferenced(kp, vp, bt, cl)
        check(torch.equal(out, A.paged_attention(q, kp2, vp2, bt, cl)),
              "unreferenced slots leaked into the output")
        for b in range(B):
            one = A.paged_attention(q[b:b + 1], kp, vp, bt[b:b + 1],
                                    cl[b:b + 1])
            check(torch.equal(one[0], out[b]),
                  "row %d differs between B=%d and B=1 launches" % (b, B))
        worst[dt] = max(worst.get(dt, 0.0), err)
    log("  paged_decode envelope: every row bitwise equal to its B=1 launch; "
        "poisoned slots changed nothing")
    return worst


def verify_lens(rng, B, T, lo=0, hi=124):
    """Per-lane contexts of a verify window: base + 1, ..., base + T."""
    base = rng.integers(lo, hi + 1, B)
    return base[:, None] + 1 + np.arange(T)[None, :]


def check_paged_multi(A):
    """K4 against its plain version at the verify shape (B 32, T 4, 257
    blocks of 16, H 4, D 64) and on edge cases; two bitwise checks: lane t
    equals K3 (``paged_attention``) at ``lens[:, t]``, and row b of the
    B 32 launch equals its B 1 launch. Unreferenced slots poisoned with
    +-1e30 change nothing; an out-of-range block id gives NaN in exactly
    the lanes whose context reaches it."""
    rng = np.random.default_rng(6)
    worst = {}
    edge = np.array([[0, 0, 0, 0],          # a dead row
                     [0, 5, 17, 3],         # zero and non-monotone lanes
                     [128, 1, 64, 0],
                     [16, 16, 16, 16]])     # a whole block, all lanes
    # (B, T, page dtype, D, pool block size, lens); bs 64 crosses K4's
    # 32-token staging chunk
    cases = [(32, 4, torch.float32, 64, 16, "verify"),
             (32, 4, torch.bfloat16, 64, 16, "verify"),
             (32, 4, torch.float32, 128, 16, "verify"),
             (32, 1, torch.float32, 64, 16, "verify"),
             (32, 2, torch.float32, 64, 16, "verify"),
             (32, 8, torch.float32, 64, 16, "verify"),
             (32, 16, torch.float32, 64, 16, "verify"),
             (32, 4, torch.bfloat16, 64, 64, "verify"),
             # past one group of 16 lanes, past 128 dims and 256-position
             # windows, a table past the 2048 slots kept in shared memory
             (8, 17, torch.float32, 64, 16, "verify"),
             (8, 32, torch.float32, 64, 16, "verify"),
             (4, 4, torch.float32, 256, 512, "long"),
             (4, 4, torch.float16, 64, 16, "verify"),
             (2, 3, torch.float32, 4096, 16, "verify"),   # lane groups of 1
             (2, 3, torch.float32, 64, 1, "table"),
             (16, 4, torch.float32, 64, 16, "edge")]   # last: see below
    for B, T, dt, D, bs, kind in cases:
        nb = 128 // bs
        if kind == "verify":
            lens = verify_lens(rng, B, T, hi=128 - T)
        elif kind == "long":   # contexts of 1..3 pool blocks of 512
            nb = 3
            lens = verify_lens(rng, B, T, hi=nb * bs - T)
        elif kind == "table":  # 8200 slots of one position each
            nb = 8200
            lens = verify_lens(rng, B, T, lo=8000, hi=nb - T)
        else:
            lens = np.concatenate([edge, rng.integers(0, 129, (B - 4, T))])
        N = 257 if B * nb < 257 and bs <= 64 and D <= 256 else B * nb + 1
        q, kp, vp, bt, cl = paged_inputs(rng, B, dt, lens, N=N, D=D, bs=bs,
                                         nb=nb)
        out = A.paged_attention_multi(q, kp, vp, bt, cl)
        ref = A.paged_attention_multi_reference(q, kp, vp, bt, cl)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        log("  paged_decode_multi B=%d T=%d D=%d bs=%d nb=%d pages %s %s "
            "lens: max_abs_err %.3e (tol %.0e)"
            % (B, T, D, bs, nb, str(dt)[6:], kind, err, tol))
        check(err <= tol, "paged_decode_multi disagrees with its plain version")
        check(bool((out[cl == 0] == 0).all()), "a context-0 lane must give 0")
        for t in range(T):
            one = A.paged_attention(q[:, t].contiguous(), kp, vp, bt,
                                    cl[:, t].contiguous())
            check(torch.equal(one, out[:, t]),
                  "lane %d differs from paged_decode at its context" % t)
        for b in range(B):
            row = A.paged_attention_multi(q[b:b + 1], kp, vp, bt[b:b + 1],
                                          cl[b:b + 1])
            check(torch.equal(row[0], out[b]),
                  "row %d differs between B=%d and B=1 launches" % (b, B))
        kp2, vp2 = poison_unreferenced(kp, vp, bt, cl.max(dim=1).values)
        check(torch.equal(out, A.paged_attention_multi(q, kp2, vp2, bt, cl)),
              "unreferenced slots leaked into the output")
        worst[dt] = max(worst.get(dt, 0.0), err)
    log("  paged_decode_multi: every lane bitwise equal to paged_decode at its "
        "context, every row to its B=1 launch; poisoned slots changed nothing")
    # an out-of-range id in table slot 2 (positions 32..47) of the edge case
    bt_bad = bt.clone()
    bt_bad[:, 2] = kp.shape[0] + 7
    out = A.paged_attention_multi(q, kp, vp, bt_bad, cl)
    reach = cl > 32
    check(bool(torch.isnan(out[reach]).all()),
          "a lane reaching an out-of-range block must be NaN")
    check(torch.equal(out[~reach], A.paged_attention_multi(q, kp, vp, bt, cl)[~reach]),
          "lanes short of an out-of-range block changed")
    log("  paged_decode_multi: an out-of-range block id gave NaN in the %d "
        "lanes reaching it and changed none of the other %d"
        % (int(reach.sum()), int((~reach).sum())))
    return worst


def check_flash_bwd(A):
    """The two backward kernels through the autograd Function (one K1, one
    K2a and one K2b launch) against ``_flash_backward_plain`` on the same
    card tensors and the same forward residuals; then bitwise equal on a
    second launch."""
    rng = np.random.default_rng(4)
    worst = {}
    cases = [(32, 4, 128, 128, 64, True, torch.float32),   # training shape
             (2, 4, 48, 80, 64, False, torch.float32),
             (2, 4, 48, 80, 64, True, torch.float32),
             (1, 2, 100, 37, 128, True, torch.float32),
             (2, 2, 70, 70, 128, False, torch.float32),
             (2, 4, 80, 80, 64, True, torch.bfloat16),
             (32, 4, 128, 128, 64, True, torch.float16)]  # training shape
    cases += [(2, 2, 70, 70, d, causal, dt) for d in (136, 256)
              for causal, dt in ((True, torch.float32), (False, torch.float32),
                                 (True, torch.bfloat16),
                                 (True, torch.float16))]
    for b, h, sq, sk, d, causal, dt in cases:
        q, k, v = flash_inputs(rng, b, h, sq, sk, d, dt)
        g = flash_inputs(rng, b, h, sq, sq, d, dt)[0]
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad(A.flash_attention(*leaves, causal), leaves, g)
        again = torch.autograd.grad(A.flash_attention(*leaves, causal), leaves, g)
        out, lse = A.flash_attention_forward(q, k, v, causal)
        ref = A._flash_backward_plain(q, k, v, out.to(dt), lse, g, causal,
                                      1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        errs = [(a.float() - r.float()).abs().max().item()
                for a, r in zip(got, ref)]
        err = max(errs)
        if dt == torch.float32:
            tol = F32_TOL
        else:
            err = err / max(r.float().abs().max().item() for r in ref)
            tol = BF16_REL_TOL if dt == torch.bfloat16 else F16_REL_TOL
        log("  flash_bwd b=%d h=%d sq=%d sk=%d d=%d causal=%d %s: max_abs_err "
            "dq %.3e dk %.3e dv %.3e -> %s %.3e (tol %.0e)"
            % (b, h, sq, sk, d, causal, str(dt)[6:], *errs,
               "abs" if dt == torch.float32 else "rel", err, tol))
        check(all(a.dtype == dt for a in got), "gradient dtype")
        check(all(torch.isfinite(a).all().item() for a in got),
              "flash backward not finite")
        check(err <= tol, "flash backward kernels disagree with the plain version")
        check(all(torch.equal(a, a2) for a, a2 in zip(got, again)),
              "two launches gave different gradient bits")
        worst[dt] = max(worst.get(dt, 0.0), err)
    log("  flash_bwd: every case bitwise equal across two launches")
    return worst


# ---------------------------------------------------------------- serving
SERVE = dict(vocab_size=32000, num_layers=4, model_dim=256, num_heads=4,
             ffn_dim=1024, max_len=128, block_size=16, num_blocks=257,
             max_batch=32, prefills_per_step=4, prefix_cache=True,
             max_queue=0, default_timeout_ms=0)


def prompt_mix(vocab):
    """The 32 seeded prompts of the serving phases: 1..112 tokens, one of
    112 (the 128 prefill bucket runs) and one of 1."""
    rng = np.random.RandomState(0)
    lengths = [int(x) for x in rng.randint(1, 113, 32)]
    lengths[0] = 112
    lengths[1] = 1
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lengths]


def run_serving(S, M, build, tel):
    cfg = S.ServingConfig(**SERVE)
    params = M.random_params(cfg, seed=0)
    eng = S.ServingEngine(cfg, arg_params=params, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    log("  warmup (every prefill and decode bucket): %.3f s"
        % (time.perf_counter() - t0))
    prompts = prompt_mix(cfg.vocab_size)
    lengths = [len(p) for p in prompts]
    pre0 = tel.histogram("serving.prefill_seconds").count
    pre_s0 = tel.histogram("serving.prefill_seconds").sum
    dec0 = tel.histogram("serving.decode_batch").count

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, 16) for p in prompts]
    steps = 0
    while any(not r.finished() for r in reqs):
        eng.step()
        steps += 1
        check(steps < 10000, "serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}

    prefills = tel.histogram("serving.prefill_seconds").count - pre0
    prefill_s = tel.histogram("serving.prefill_seconds").sum - pre_s0
    decodes = tel.histogram("serving.decode_batch").count - dec0
    check(all(r.state == S.FINISHED for r in reqs), "a request did not finish")
    check(all(len(r.generated) == 16 for r in reqs), "wrong token count")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    L = cfg.num_layers
    check(launches["flash_fwd"] >= L * prefills > 0,
          "flash_fwd launched %d times for %d prefills"
          % (launches["flash_fwd"], prefills))
    check(launches["paged_decode"] >= L * decodes > 0,
          "paged_decode launched %d times for %d decode steps"
          % (launches["paged_decode"], decodes))
    st = eng.stats()
    ntok = sum(len(r.generated) for r in reqs)
    log("  32 requests, prompts %d..%d tokens, 16 new each: %d engine "
        "steps, %d prefills (incl. replays), %d decode steps, %d preemptions"
        % (min(lengths), max(lengths), steps, prefills, decodes,
           st["preemptions"]))
    log("  launches on the main path: %s" % launches)
    log("  host wall: %.4f s in %d prefill calls (%.5f s each), %.4f s in "
        "the rest of the steps (%.5f s per decode step)"
        % (prefill_s, prefills, prefill_s / prefills, wall - prefill_s,
           (wall - prefill_s) / decodes))
    log("  generated %d tokens in %.3f s: %.1f tokens/s; TTFT p50 %.4f s, "
        "p99 %.4f s (port telemetry)" % (ntok, wall, ntok / wall,
                                         st["ttft_p50_s"], st["ttft_p99_s"]))
    return cfg, params, launches, {"prefills": prefills, "decodes": decodes,
                                   "steps": steps}


def teacher_forced(S, M, cfg, params_np):
    """Prefill + 4 decode steps for three prompts, the same tokens fed on
    the card (kernels) and on CPU tensors (plain path); logits compared."""
    rng = np.random.RandomState(7)
    lens = [5, 40, 100]
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    forced = rng.randint(0, cfg.vocab_size, (4, 3)).astype(np.int32)
    nb = cfg.max_len // cfg.block_size
    tables = np.zeros((4, nb), np.int32)     # row 3: a padded trash lane
    for i in range(3):
        tables[i] = 1 + i * nb + np.arange(nb)
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size, cfg.num_heads,
             cfg.model_dim // cfg.num_heads)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = M.as_device_params(params_np, cfg, device=dev)
        kp = torch.zeros(shape, device=dev)
        vp = torch.zeros(shape, device=dev)
        outs = []
        for i, pr in enumerate(prompts):
            S_ = min(b for b in cfg.prefill_buckets() if b >= len(pr))
            toks = np.zeros((1, S_), np.int32)
            toks[0, :len(pr)] = pr
            _t, lg, _k, _v = M.prefill(
                p, torch.from_numpy(toks).to(dev), len(pr),
                torch.from_numpy(tables[i, :S_ // cfg.block_size]).to(dev),
                kp, vp, cfg)
            outs.append(lg.cpu())
        for t in range(4):
            toks = np.zeros(4, np.int32)
            pos = np.zeros(4, np.int32)
            ctx = np.ones(4, np.int32)
            toks[:3] = forced[t]
            pos[:3] = [n + t for n in lens]
            ctx[:3] = pos[:3] + 1
            _t, lg, _k, _v = M.decode(
                p, *(torch.from_numpy(a).to(dev) for a in
                     (toks, pos, tables, ctx)), kp, vp, cfg)
            outs.append(lg[:3].cpu())
        logits[dev] = outs
    err = 0.0
    for a, b in zip(logits["cuda"], logits["cpu"]):
        check(bool(torch.isfinite(a).all()), "non-finite logits on the card")
        check(a.shape == b.shape and a.shape[-1] == cfg.vocab_size,
              "logit shape")
        err = max(err, (a - b).abs().max().item())
    log("  teacher-forced prefill (lengths %s) + 4 decode steps: max abs "
        "logit diff card vs CPU %.3e (tol %.0e)" % (lens, err, LOGIT_TOL))
    check(err <= LOGIT_TOL, "card logits disagree with the CPU plain path")


# ---------------------------------------------------------------- training
def lm_stream(n, seed=0):
    """``examples/train_lm.py``'s synthetic stream: token t+1 = token t + 1
    (mod V), each sequence from a random start (numpy seed)."""
    V, T = TRAIN["vocab_size"], TRAIN["seq_len"]
    rng = np.random.RandomState(seed)
    X = (rng.randint(0, V, (n, 1)) + np.arange(T)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


def run_training(mx, build):
    """``Module.fit`` of the zoo Transformer-LM at full width on the card."""
    X, Y = lm_stream(128)
    batch, epochs = 32, 5
    it = mx.io.NDArrayIter(X, Y, batch_size=batch, shuffle=False)
    mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=None)
    stamps, ppl = [], []

    def batch_end(_param):
        torch.cuda.synchronize()   # the step's host wall includes the card's work
        stamps.append(time.perf_counter())

    def epoch_end(_epoch, _sym, _arg, _aux):
        ppl.append(metric.get()[1])

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)),
            eval_metric=metric, batch_end_callback=batch_end,
            epoch_end_callback=epoch_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    steps = len(stamps)
    per_step = np.diff([t0] + stamps)
    step_s = float(np.median(per_step[1:]))
    tokens = batch * TRAIN["seq_len"]
    log("  %d epochs x %d batches of %d x %d tokens: %d steps in %.3f s; first "
        "step %.4f s; host wall per step (median after the first, synchronized) "
        "%.5f s = %.1f tokens/s" % (epochs, steps // epochs, batch,
                                    TRAIN["seq_len"], steps, wall, per_step[0],
                                    step_s, tokens / step_s))
    log("  training perplexity per epoch: %s" % ["%.3f" % p for p in ppl])
    log("  launches on the training path: %s" % launches)
    L = TRAIN["num_layers"]
    check(steps == epochs * (len(X) // batch), "fit ran %d steps" % steps)
    check(all(math.isfinite(p) for p in ppl), "non-finite training loss")
    check(all(b < a for a, b in zip(ppl, ppl[1:])),
          "training perplexity did not fall every epoch")
    check(ppl[-1] < TRAIN["vocab_size"] / 2,
          "training perplexity ended near uniform guessing")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches[name] == L * steps, "%s launched %d times in %d steps"
              % (name, launches[name], steps))
    check(launches["paged_decode"] == 0, "paged_decode ran on the training path")
    params = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return launches, {"steps": steps, "step_s": step_s, "ppl": ppl}, params, mod


def train_step_card_vs_cpu(mx, params):
    """One ``forward_backward`` of 4 sequences from the same parameters on
    the card (kernels) and on the CPU (plain versions)."""
    X, Y = lm_stream(4, seed=1)
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=mx.cpu())],
                            [mx.nd.array(Y, ctx=mx.cpu())])
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("softmax_label", Y.shape)])
        mod.init_params(arg_params=params)
        mod.forward_backward(batch)
        exe = mod._exec_group.execs[0]
        res[ctx.type] = (mod.get_outputs()[0].asnumpy(),
                         {n: exe.grad_dict[n].asnumpy() for n in params})
    (out_c, g_c), (out_h, g_h) = res["cuda"], res["cpu"]
    check(np.isfinite(out_c).all() and out_c.shape == out_h.shape,
          "card outputs not finite or misshapen")
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    rel = {n: float(np.abs(g_c[n] - g_h[n]).max() / max(np.abs(g_h[n]).max(), 1e-30))
           for n in params}
    worst = max(rel, key=rel.get)
    log("  one step at batch 4 x %d: max abs output diff card vs CPU / max "
        "abs output %.3e (tol %.0e); worst gradient %s: max abs diff / max abs grad %.3e "
        "(tol %.0e over %d parameters)" % (TRAIN["seq_len"], out_err,
                                           OUT_REL_TOL, worst, rel[worst],
                                           GRAD_TOL, len(rel)))
    check(out_err <= OUT_REL_TOL, "card outputs disagree with the CPU")
    check(all(np.isfinite(g_c[n]).all() for n in params), "non-finite gradient")
    check(rel[worst] <= GRAD_TOL, "card gradients disagree with the CPU")


# ---------------------------------------------------- speculative serving
def checkpoint_round_trip(mx, mod):
    """The trained module written with ``Module.save_checkpoint`` into a
    temporary directory and read back with ``mx.model.load_checkpoint``:
    the same parameters, bit for bit."""
    import tempfile

    want = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = tmp + "/lm"
        mod.save_checkpoint(prefix, 5)
        sym, args, auxs = mx.model.load_checkpoint(prefix, 5)
    check(sym.tojson() == mod.symbol.tojson(), "checkpoint symbol differs")
    check(sorted(args) == sorted(want) and not auxs,
          "checkpoint parameter names differ")
    check(all(np.array_equal(args[n].asnumpy(), want[n]) for n in want),
          "checkpoint parameters differ from the trained module's")
    log("  Module.save_checkpoint -> mx.model.load_checkpoint: %d parameters "
        "(%d floats) read back bit for bit" % (len(args),
                                              sum(v.size for v in want.values())))
    return args


def serve_once(S, build, tel, params, prompts, **over):
    """One engine at ``SERVE`` (+ ``over``) on the card: ``warmup()``, then
    the prompts through ``submit``/``step`` until all finish, the launch
    counters set to 0 just before and read just after."""
    cfg = S.ServingConfig(**dict(SERVE, **over))
    eng = S.ServingEngine(cfg, arg_params=params, device="cuda")
    eng.warmup()
    pre0 = tel.histogram("serving.prefill_seconds").count
    dec0 = tel.histogram("serving.decode_batch").count
    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, 16) for p in prompts]
    steps = 0
    while any(not r.finished() for r in reqs):
        eng.step()
        steps += 1
        check(steps < 10000, "serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    check(all(r.state == S.FINISHED for r in reqs), "a request did not finish")
    check(all(len(r.generated) == 16 for r in reqs), "wrong token count")
    return eng, [list(r.generated) for r in reqs], launches, {
        "wall": wall, "steps": steps,
        "prefills": tel.histogram("serving.prefill_seconds").count - pre0,
        "decodes": tel.histogram("serving.decode_batch").count - dec0}


def first_divergence(S, M, params, prompts, want, got):
    """Where two token streams first part: the request, the position, and
    the target's top-2 logit margin there (teacher-forced prefill of the
    prompt and the agreed tokens), so a near-tie can be told from a bug."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        j = next(j for j in range(len(a)) if a[j] != b[j])
        cfg = S.ServingConfig(**SERVE)
        p = M.as_device_params(params, cfg, device="cuda")
        ctx = prompts[i] + a[:j]
        S_ = min(x for x in cfg.prefill_buckets() if x >= len(ctx))
        toks = torch.zeros((1, S_), dtype=torch.int32, device="cuda")
        toks[0, :len(ctx)] = torch.tensor(ctx, dtype=torch.int32)
        shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size,
                 cfg.num_heads, cfg.model_dim // cfg.num_heads)
        kp = torch.zeros(shape, device="cuda")
        vp = torch.zeros(shape, device="cuda")
        table = torch.arange(1, S_ // cfg.block_size + 1, dtype=torch.int32,
                             device="cuda")
        _t, lg, _k, _v = M.prefill(p, toks, len(ctx), table, kp, vp, cfg)
        top = torch.topk(lg[0], 2)
        return ("request %d (batch lane %d), position %d (new token %d): "
                "target-only %d, speculative %d; target's top-2 %s, logit "
                "margin %.3e" % (i, i, len(ctx), j, a[j], b[j],
                                 top.indices.tolist(),
                                 (top.values[0] - top.values[1]).item()))
    return None


def run_spec_serving(mx, S, M, build, tel, mod):
    """Speculative serving at full width from the phase-5 checkpoint:
    target-only (``spec_k`` 0, K3), ``spec_k`` 3 with the ``small`` draft
    and with the ``self`` draft, ``spec_k`` 16 with the ``self`` draft (17
    verify lanes); the four token streams must be equal."""
    params = checkpoint_round_trip(mx, mod)
    prompts = prompt_mix(SERVE["vocab_size"])
    L = SERVE["num_layers"]
    runs = {}
    for name, over in (("target-only", dict(spec_k=0)),
                       ("spec_k=3 small", dict(spec_k=3, draft="small")),
                       ("spec_k=3 self", dict(spec_k=3, draft="self")),
                       # 17 verify lanes: two lane groups of the kernel
                       ("spec_k=16 self", dict(spec_k=16, draft="self"))):
        eng, toks, launches, c = serve_once(S, build, tel, params, prompts,
                                            **over)
        st = eng.stats()
        spec = st["spec"]
        ntok = sum(len(t) for t in toks)
        log("  %s: %d steps, %d prefills, %d decode steps, %d preemptions; "
            "%d tokens in %.3f s = %.1f tokens/s; TTFT p50 %.4f s, p99 %.4f s"
            % (name, c["steps"], c["prefills"], c["decodes"],
               st["preemptions"], ntok, c["wall"], ntok / c["wall"],
               st["ttft_p50_s"], st["ttft_p99_s"]))
        log("    launches: %s" % launches)
        if spec["enabled"]:
            Ld = eng.draft_config.num_layers
            k = spec["k"]
            log("    acceptance %d / %d = %.4f; draft %.4f s, verify %.4f s "
                "(%.1f %% of the spec wall in the draft)"
                % (spec["accepted_tokens"], spec["proposed_tokens"],
                   spec["acceptance_rate"], spec["draft_seconds"],
                   spec["verify_seconds"],
                   100 * spec["draft_seconds"]
                   / (spec["draft_seconds"] + spec["verify_seconds"])))
            check(launches["paged_decode_multi"] == L * c["decodes"] > 0,
                  "paged_decode_multi launched %d times for %d speculative "
                  "steps" % (launches["paged_decode_multi"], c["decodes"]))
            check(launches["paged_decode"] == Ld * (k + 1) * c["decodes"],
                  "paged_decode launched %d times for %d draft layers x %d "
                  "x %d steps" % (launches["paged_decode"], Ld, k + 1,
                                  c["decodes"]))
            check(launches["flash_fwd"] == (L + Ld) * c["prefills"] > 0,
                  "flash_fwd launched %d times for %d prefills of %d + %d "
                  "layers" % (launches["flash_fwd"], c["prefills"], L, Ld))
        else:
            check(launches["paged_decode_multi"] == 0,
                  "paged_decode_multi ran without speculative decoding")
            check(launches["paged_decode"] == L * c["decodes"] > 0,
                  "paged_decode launched %d times for %d decode steps"
                  % (launches["paged_decode"], c["decodes"]))
            check(launches["flash_fwd"] == L * c["prefills"] > 0,
                  "flash_fwd launched %d times for %d prefills"
                  % (launches["flash_fwd"], c["prefills"]))
        runs[name] = (toks, launches, c, spec)
    want = runs["target-only"][0]
    for name in ("spec_k=3 small", "spec_k=3 self", "spec_k=16 self"):
        where = first_divergence(S, M, params, prompts, want, runs[name][0])
        if where is not None:
            log("  %s parts from target-only decoding at %s" % (name, where))
        check(where is None, "%s tokens differ from target-only decoding"
              % name)
    log("  the four runs' token streams are equal (32 x 16 tokens)")
    check(runs["spec_k=3 self"][3]["acceptance_rate"] >= 0.75,
          "the self draft's acceptance is low: the verify pass disagrees "
          "with decoding")
    return runs


# ---------------------------------------------------------------- times
def time_flash(A, b, h, s, d):
    F = torch.nn.functional
    rng = np.random.default_rng(2)
    q, k, v = flash_inputs(rng, b, h, s, s, d, torch.float32)
    scale = 1.0 / math.sqrt(d)
    out, lse = A.flash_attention_forward(q, k, v, True)
    ref, ref_lse = A._flash_forward_plain(q, k, v, True, scale)
    err = max((out - ref).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    ms = device_ms(lambda: A.flash_attention_forward(q, k, v, True))
    plain = device_ms(lambda: A._flash_forward_plain(q, k, v, True, scale))
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    log("  library yardstick for flash_fwd at (%d,%d,%d,%d) f32 causal runs: "
        "%s" % (b, h, s, d, device_kernels(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))))
    # causal: row i needs i+1 scores and i+1 weighted rows of V
    pairs = b * h * s * (s + 1) // 2
    flops = 4 * pairs * d
    nbytes = 4 * (4 * b * h * s * d + b * h * s)   # q,k,v in; out, lse out
    # the kernel's products run on the tensor cores as split TF32 products
    return dict(err=err, ms=ms, plain=plain, lib=lib, flops=flops,
                nbytes=nbytes, peak=PEAK_K1_FLOPS,
                peak_name="110 TFLOP/s (TF32 x 4.5)",
                shape="q/k/v (%d,%d,%d,%d) f32 causal" % (b, h, s, d))


def time_flash_bwd(A, build, b=32, h=4, s=128, d=64):
    """K2a and K2b launched alone at the training shape; the plain twin and
    the library yardstick compute dq, dk and dv together, so both rows
    carry the same plain and library times. Library: autograd through
    ``scaled_dot_product_attention`` (forward + backward) less its forward
    alone, both with gradients enabled."""
    F = torch.nn.functional
    rng = np.random.default_rng(5)
    q, k, v = flash_inputs(rng, b, h, s, s, d, torch.float32)
    g = flash_inputs(rng, b, h, s, s, d, torch.float32)[0]
    scale = 1.0 / math.sqrt(d)
    out, lse = A.flash_attention_forward(q, k, v, True)
    delta = (out * g).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
    dims = (b, h, s, s, d, scale, 1, 0, stream)

    def dkv():
        build.FLASH_BWD_DKV.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims)

    def dq_():
        build.FLASH_BWD_DQ.launch(*ptrs, dq.data_ptr(), *dims)

    ref = A._flash_backward_plain(q, k, v, out, lse, g, True, scale)
    dkv()
    dq_()
    torch.cuda.synchronize()
    err_dkv = max((dk - ref[1]).abs().max().item(), (dv - ref[2]).abs().max().item())
    err_dq = (dq - ref[0]).abs().max().item()
    ms_dkv = device_ms(dkv)
    ms_dq = device_ms(dq_)
    plain = device_ms(lambda: A._flash_backward_plain(q, k, v, out, lse, g,
                                                      True, scale))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    lib_grads = torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, g)
    lib_err = max((a - r).abs().max().item() for a, r in zip(lib_grads, ref))
    check(lib_err <= 1e-3, "library yardstick disagrees (%.3e)" % lib_err)
    lib_fb = device_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, g))
    lib_f = device_ms(lambda: F.scaled_dot_product_attention(*leaves, is_causal=True))
    lib = lib_fb - lib_f
    log("  library yardstick for the backward: SDPA fwd+bwd %.6f ms - fwd "
        "%.6f ms = %.6f ms (max abs err vs plain %.3e)" % (lib_fb, lib_f, lib, lib_err))
    pairs = b * h * s * (s + 1) // 2
    bhsd, bhs = b * h * s * d, b * h * s
    shape = "q/k/v/dout (%d,%d,%d,%d) f32 causal" % (b, h, s, d)
    # K2a: s, dp, dV, dK — 8 FLOP per pair and dim; reads q,k,v,dout,lse,
    # delta, writes dk, dv.  K2b: s, dp, dQ — 6; writes dq. Both on the
    # tensor cores as split TF32 products
    return (dict(err=err_dkv, ms=ms_dkv, plain=plain, lib=lib, flops=8 * pairs * d,
                 nbytes=4 * (6 * bhsd + 2 * bhs), shape=shape,
                 peak=PEAK_K2A_FLOPS, peak_name="132 TFLOP/s (TF32 x 3.75)"),
            dict(err=err_dq, ms=ms_dq, plain=plain, lib=lib, flops=6 * pairs * d,
                 nbytes=4 * (5 * bhsd + 2 * bhs), shape=shape,
                 peak=PEAK_K2B_FLOPS, peak_name="124 TFLOP/s (TF32 x 4)"))


def time_paged(A, B=32, ctx=None, H=4, D=64, bs=16):
    """K3 at the serving shape (B 32, nb 8, seeded contexts 1..128), or
    with every sequence at context ``ctx`` (nb = ctx / bs, a pool of
    distinct blocks). Library: SDPA on K/V gathered to contiguous
    (B, H, nb*bs, D) with the context mask."""
    F = torch.nn.functional
    rng = np.random.default_rng(3)
    if ctx is None:
        nb = 8
        lens = [int(x) for x in rng.integers(1, 129, B)]
    else:
        nb = ctx // bs
        lens = [ctx] * B
    q, kp, vp, bt, cl = paged_inputs(rng, B, torch.float32, lens,
                                     N=max(257, B * nb + 1), bs=bs, H=H, D=D,
                                     nb=nb)
    out = A.paged_attention(q, kp, vp, bt, cl)
    ref = A.paged_attention_reference(q, kp, vp, bt, cl)
    err = (out - ref).abs().max().item()
    ms = device_ms(lambda: A.paged_attention(q, kp, vp, bt, cl))
    plain = device_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, cl))
    # the library yardstick runs on K/V gathered to contiguous (B,H,T,D)
    tab = bt.long()
    kc = kp[tab].reshape(B, nb * bs, H, D).transpose(1, 2).contiguous()
    vc = vp[tab].reshape(B, nb * bs, H, D).transpose(1, 2).contiguous()
    mask = (torch.arange(nb * bs, device="cuda")[None, :]
            < cl[:, None])[:, None, None, :]
    qc = q[:, :, None, :]
    lib_out = F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask)
    check((lib_out[:, :, 0] - out).abs().max().item() <= F32_TOL,
          "library yardstick disagrees")
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask))
    total = sum(lens)
    flops = 4 * total * H * D
    nbytes = (2 * total * H * D * 4 + 2 * B * H * D * 4 + B * nb * 4 + B * 4)
    return dict(err=err, ms=ms, plain=plain, lib=lib, flops=flops,
                nbytes=nbytes,
                shape="B=%d, N=%d, bs=%d, H=%d, D=%d, nb=%d, f32, mean "
                      "context %.1f" % (B, kp.shape[0], bs, H, D, nb,
                                        total / B))


def time_paged_multi(A, B=32, T=4, H=4, D=64, bs=16, nb=8):
    """K4 at the verify shape. Library: SDPA on K/V gathered to contiguous
    (B, H, nb*bs, D) with the per-lane mask (B, 1, T, nb*bs). Bound: K/V
    of each sequence's longest lane read once per window, q and out, the
    tables and lengths; operations 4 per live (lane, position, dim)."""
    F = torch.nn.functional
    rng = np.random.default_rng(7)
    lens = verify_lens(rng, B, T, hi=128 - T)
    q, kp, vp, bt, cl = paged_inputs(rng, B, torch.float32, lens, H=H, D=D)
    out = A.paged_attention_multi(q, kp, vp, bt, cl)
    ref = A.paged_attention_multi_reference(q, kp, vp, bt, cl)
    err = (out - ref).abs().max().item()
    ms = device_ms(lambda: A.paged_attention_multi(q, kp, vp, bt, cl))
    plain = device_ms(lambda: A.paged_attention_multi_reference(q, kp, vp,
                                                                bt, cl))
    tab = bt.long()
    kc = kp[tab].reshape(B, nb * bs, H, D).transpose(1, 2).contiguous()
    vc = vp[tab].reshape(B, nb * bs, H, D).transpose(1, 2).contiguous()
    mask = (torch.arange(nb * bs, device="cuda")[None, None, :]
            < cl[:, :, None])[:, None]
    qc = q.transpose(1, 2)
    lib_out = F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask)
    check((lib_out.transpose(1, 2) - out).abs().max().item() <= F32_TOL,
          "library yardstick disagrees")
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask))
    log("  library yardstick for paged_decode_multi (SDPA on gathered K/V, "
        "per-lane mask) runs: %s" % device_kernels(
            lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask)))
    window = int(lens.max(axis=1).sum())
    nbytes = (2 * window * H * D * 4 + 2 * B * T * H * D * 4 + B * nb * 4
              + B * T * 4)
    return dict(err=err, ms=ms, plain=plain, lib=lib,
                flops=4 * int(lens.sum()) * H * D, nbytes=nbytes,
                shape="B=32, T=4, N=257, bs=16, H=4, D=64, nb=8, f32, mean "
                      "window context %.1f" % (window / B))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs the port on the card only", file=sys.stderr)
        return 2
    # the package is imported only once a card is known to be there
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving as S
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.ops import _build as build
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving import model as M

    log("== 1. device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("  %s | torch %s | CUDA %s | %s" % (card, torch.__version__,
                                            torch.version.cuda, sys.version))

    log("== 2. build")
    t0 = time.perf_counter()
    build.build()
    log("  built %s in %.2f s" % (sorted(build.KERNELS),
                                  time.perf_counter() - t0))
    for k in build.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("  [%s] %s" % (k.name, line.strip()))

    log("== 3. kernels vs plain on the card")
    flash_err = check_flash(A)
    paged_err = check_paged(A)
    multi_err = check_paged_multi(A)
    bwd_err = check_flash_bwd(A)
    log("  worst errors: flash %s, paged %s, paged_multi %s, flash_bwd %s"
        % ({str(k)[6:]: v for k, v in flash_err.items()},
           {str(k)[6:]: v for k, v in paged_err.items()},
           {str(k)[6:]: v for k, v in multi_err.items()},
           {str(k)[6:]: v for k, v in bwd_err.items()}))

    log("== 4. serving at full width")
    cfg, params, launches, counts = run_serving(S, M, build, tel)
    teacher_forced(S, M, cfg, params)

    log("== 5. training at full width through Module.fit")
    t_launches, t_counts, t_params, t_mod = run_training(mx, build)

    log("== 6. one training step, card vs CPU")
    train_step_card_vs_cpu(mx, t_params)

    log("== 7. speculative serving at full width from the phase-5 checkpoint")
    spec_runs = run_spec_serving(mx, S, M, build, tel, t_mod)

    log("== 8. times (%s)" % card)
    fwd_train = time_flash(A, 32, 4, 128, 64)
    log("  flash_fwd at the training shape %s: kernel_ms %.6f plain_ms %.6f "
        "library_ms %.6f bound_us %.4f max_abs_err %.3e; %d launches per "
        "step (%d layers)"
        % (fwd_train["shape"], fwd_train["ms"], fwd_train["plain"],
           fwd_train["lib"], 1e3 * max(fwd_train["nbytes"] / PEAK_BYTES_PER_S,
                                       fwd_train["flops"] / fwd_train["peak"]) * 1e3,
           fwd_train["err"], t_launches["flash_fwd"] // t_counts["steps"],
           TRAIN["num_layers"]))
    check(fwd_train["err"] <= F32_TOL, "flash_fwd disagrees at the training shape")
    bwd_dkv, bwd_dq = time_flash_bwd(A, build)
    rows = []
    total = {n: launches[n] + t_launches[n]
             + sum(r[1][n] for r in spec_runs.values()) for n in launches}
    spec_steps = sum(r[2]["decodes"] for r in spec_runs.values()
                     if r[3]["enabled"])
    per_prefill = "%.2f per prefill, %.2f per engine step" % (
        launches["flash_fwd"] / counts["prefills"],
        launches["flash_fwd"] / counts["steps"])
    for name, src, replaces, res, per in (
            ("flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd.cu",
             "mxnet_tpu/ops/attention.py:142", time_flash(A, 1, 4, 128, 64),
             "serving %d (%s), training %d (%d per step)"
             % (launches["flash_fwd"], per_prefill, t_launches["flash_fwd"],
                t_launches["flash_fwd"] // t_counts["steps"])),
            ("flash_bwd_dkv", "mxnet_tpu_torch/csrc/flash_bwd_dkv.cu",
             "mxnet_tpu/ops/attention.py:303", bwd_dkv,
             "training %d (%d per step)" % (t_launches["flash_bwd_dkv"],
                                            t_launches["flash_bwd_dkv"] // t_counts["steps"])),
            ("flash_bwd_dq", "mxnet_tpu_torch/csrc/flash_bwd_dq.cu",
             "mxnet_tpu/ops/attention.py:331", bwd_dq,
             "training %d (%d per step)" % (t_launches["flash_bwd_dq"],
                                            t_launches["flash_bwd_dq"] // t_counts["steps"])),
            ("paged_decode", "mxnet_tpu_torch/csrc/paged_decode.cu",
             "mxnet_tpu/ops/attention.py:691", time_paged(A),
             "serving %d (%.2f per decode step), speculative phase %d"
             % (launches["paged_decode"],
                launches["paged_decode"] / counts["decodes"],
                sum(r[1]["paged_decode"] for r in spec_runs.values()))),
            ("paged_decode_multi", "mxnet_tpu_torch/csrc/paged_decode_multi.cu",
             "mxnet_tpu/ops/attention.py:842", time_paged_multi(A),
             "speculative phase %d (%.2f per speculative step)"
             % (total["paged_decode_multi"],
                total["paged_decode_multi"] / spec_steps))):
        t_bytes = res["nbytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = res["flops"] / res.get("peak", PEAK_F32_FLOPS) * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": res["lib"]})
        log("  %s at %s: kernel_ms %.6f plain_ms %.6f library_ms %.6f "
            "bound_us %.4f (%s: %d bytes at 3.35 TB/s, %d FLOP at %s; "
            "%.4f us at 67 TFLOP/s f32) max_abs_err %.3e; launches on the "
            "main paths: %s"
            % (name, res["shape"], res["ms"], res["plain"], res["lib"],
               bound * 1e3, rows[-1]["bound_by"], res["nbytes"],
               res["flops"], res.get("peak_name", "67 TFLOP/s f32"),
               res["flops"] / PEAK_F32_FLOPS * 1e6, res["err"], per))
        check(res["err"] <= F32_TOL, "%s disagrees at the timed shape" % name)
    for B, ctx in ((32, 1024), (32, 4096), (1, 1024), (1, 4096)):
        res = time_paged(A, B=B, ctx=ctx)
        bound = max(res["nbytes"] / PEAK_BYTES_PER_S,
                    res["flops"] / PEAK_F32_FLOPS) * 1e3
        log("  paged_decode long context at %s: kernel_ms %.6f plain_ms %.6f "
            "library_ms %.6f bound_ms %.6f (bytes: %d at 3.35 TB/s) "
            "max_abs_err %.3e" % (res["shape"], res["ms"], res["plain"],
                                  res["lib"], bound, res["nbytes"],
                                  res["err"]))
        check(res["err"] <= F32_TOL, "paged_decode disagrees at long context")
    step_ms = t_counts["step_s"] * 1e3
    attn_ms = (t_launches["flash_fwd"] * fwd_train["ms"]
               + t_launches["flash_bwd_dkv"] * bwd_dkv["ms"]
               + t_launches["flash_bwd_dq"] * bwd_dq["ms"]) / t_counts["steps"]
    log("  training step: host wall %.3f ms; attention kernels' device time "
        "%.3f ms per step (%.1f %%)" % (step_ms, attn_ms, 100 * attn_ms / step_ms))

    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
