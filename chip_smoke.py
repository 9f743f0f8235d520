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
   equal across two launches; the wide route (``flash_wide.cu``: forward,
   dK/dV and dQ) at D 264, 384, 512 and 1032 (past the 512 columns a
   block holds) in f32, bf16 and f16, causal, and at D 512 in f32 with 40
   queries and 100 keys (the dK/dV rows of the keys no query sees exactly
   0);
4. serving — the zoo Transformer-LM at full width (vocab 32000, 4 layers,
   d 256, 4 heads, ffn 1024, max_len 128; pool bs 16, 257 blocks, batch
   32) with seeded random weights: ``warmup()`` (one CUDA graph captured
   per prefill length bucket and per decode batch bucket, counted in
   ``stats()["compiles"]``), then 32 seeded requests through
   ``submit``/``step`` until all finish, every step a replay of its
   bucket's graph, with the kernels' launch counters set to 0 just before
   and read just after (a replay adds its graph's captured launches) and
   no capture in that window; then a teacher-forced check of prefill +
   decode logits on the card against the same port functions on CPU
   tensors;
5. training — the same model trained through ``Module.fit`` on the card
   (Adam, lr 1e-3, seeded Xavier, ``Perplexity``) for 5 epochs of 4
   batches of 32 sequences of ``examples/train_lm.py``'s synthetic
   stream, on the fused step (kvstore 'local' on a card fuses): the first
   step eager, the step then captured once as a CUDA graph and replayed;
   launch counters set to 0 just before ``fit`` and read just after:
   every loss finite, perplexity falling every epoch and ending below
   half the vocabulary (uniform guessing), and exactly one launch of each
   attention kernel per layer and step (a replay adds the captured step's
   launches). Then the same ``fit`` on the classic path
   (``MXNET_MODULE_NO_FUSED=1``), with the same checks; both host walls
   per step printed, and the two runs' final parameters held against each
   other;
6. one training step, card vs CPU — ``forward_backward`` of one batch of
   4 sequences from the same parameters on ``gpu(0)`` and on ``cpu()``
   (plain versions): outputs (relative to the largest probability) and
   every parameter's gradient compared, at the trained parameters or,
   where the CPU's own gradient there jumps under a +-1e-7 parameter move
   (a ReLU input within float32 rounding of its kink, which the card may
   round to the other side), at the first seeded point within 1e-5 of them
   where it does not: the CPU alone picks the point, before the card runs;
7. speculative serving from a checkpoint — phase 5's trained module
   written with ``Module.save_checkpoint`` into a temporary directory and
   read back with ``mx.model.load_checkpoint`` (bit for bit), then served
   at phase 4's width and prompt mix four times: target-only
   (``spec_k`` 0), ``spec_k`` 3 with the ``small`` draft and with the
   ``self`` draft, and ``spec_k`` 16 with the ``self`` draft (17 verify
   lanes), each on its bucket graphs (draft prefill and decode, verify:
   one capture per bucket in ``warmup()``, none while serving). The four
   token streams must be equal (else the first
   diverging request and position and the target's top-2 logit margin
   there are printed, and the run fails); launch counts exact per run
   (the multi-query kernel once per target layer and speculative step,
   the single-query one once per draft layer and draft step, the flash
   forward once per target and draft layer and prefill); acceptance rate,
   tokens/s, TTFT and the draft/verify wall split printed;
8. training at head_dim 512 — the zoo LM at model_dim 1024 with 2 heads
   (2 layers, batch 8) fit for 4 fused steps: exactly one launch of each
   wide flash kernel per layer and step, none of the D <= 256 kernels;
   then phase 6's check at head_dim 512 from the fit's parameters (or the
   first smooth point near them, as there): one ``forward_backward`` of 4
   sequences on ``gpu(0)`` and on ``cpu()``;
9. ResNet-50 through ``Module.fit`` at ``bench.py``'s configuration (1000
   classes, 3x224x224 NCHW, batch 32, ``compute_dtype`` bfloat16, SGD lr
   0.05 momentum 0.9 rescale 1/32, Xavier gaussian/in/2, Accuracy,
   kvstore 'device', one device-resident seeded batch): on the fused path
   (one CUDA graph captured for the shape) and on the classic path; host
   wall per step (median after warm-up, synchronized) and images/s of
   each, device busy time and kernels per step (one ``torch.profiler``
   window of 3 steps each, taken in phase 12), peak memory; the batch's
   loss finite and lower after the run than at step 1;
10. ResNet-50 card against CPU — one fused step in float32 at batch 4 from
   the same parameters on the card and on the CPU: outputs and BatchNorm
   moving statistics relative to the largest CPU value, the updates
   against the CPU step's own move under a 1e-7 parameter perturbation;
   and on the card one graph replay against one eager step from the same
   state;
11. times — each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls), timed
   with CUDA events while the stream is held by a sleep so host launch
   overhead is hidden, beside the card's bound for the same work (the
   flash forward's and backward's operations at their split-TF32
   tensor-core rates, the others' at the float32 rate); the paged kernel
   also at contexts 1024 and 4096 for B 32 and B 1 (printed lines); the
   device kernels that the flash-forward and multi-query yardsticks
   launch are printed (one ``torch.profiler`` pass each); the wide flash
   kernels at phase 8's shape and at (2,8,2048,512) (printed lines), their
   bound at the float32 rate;
12. device profiles — three steps of each training path of phases 5 and 9
   under ``torch.profiler``: device busy time and share of the host wall,
   device operations per step, time by kernel class and the largest
   kernels;
13. the bucketed LSTM LM — ``examples/lstm_bucketing.py``'s defaults
   (vocab 10000, embed and hidden 200, 2 layers of ``LSTMCell`` unrolled
   in a ``SequentialRNNCell``, buckets 10/20/30/40/60, batch 32, SGD lr 0.01
   momentum 0.9, Xavier, ``Perplexity(ignore_label=0)``, kvstore 'local')
   through ``BucketingModule.fit`` for 4 epochs of 2000 seeded sentences
   of 5-60 tokens (each token the previous + 1, Zipfian first tokens)
   from ``BucketSentenceIter``: on the fused step (one CUDA graph per
   bucket, every graph over one shared set of master parameters and
   optimizer slots), then on the classic path. Perplexity falling every
   epoch and ending below V/2, losses finite, exactly one capture per
   bucket, the masters in as many distinct storages as there are
   parameters, no port kernel launched, fused and classic parameters
   within 1e-4; host wall per step per bucket, tokens/s, captures and
   replays, peak memory, device busy time and operations per step of the
   smallest and the largest bucket (one ``torch.profiler`` window each);
14. the fused RNN op — ``models.lstm_lm(fused=True)`` at the same widths
   for one epoch of 800 sentences on the fused step (a graph per bucket
   stepped twice or more); then one ``forward_backward`` at the top bucket,
   batch 4, card vs CPU for the fused and the unrolled LM: probabilities
   within 1e-5 and gradients within 1e-3 of the largest, as phase 6;
15. resume — phase 5's LM under Adam: 4 epochs uninterrupted; cut after
   2 (``callback.module_checkpoint`` with the optimizer states) and
   resumed by a fresh ``Module`` with ``fit(auto_resume=...)``; cut in
   epoch 2 after 2 batches (a checkpoint and a ``.resume`` sidecar by
   ``model.save_resume_state``, then the job raises) and resumed; the
   iterator does not shuffle. Fused and classic: the resumed parameters
   within 1e-6 of the largest parameter of the uninterrupted run (the
   difference printed; bitwise expected), one launch of K1, K2a and K2b
   per layer and step in each of the five runs (counted into the kernel
   line), one captured graph per fused run, host wall per step, tokens/s,
   peak memory and a device profile of the resumed step;
16. serving graphs and the decode symbol — (a) phase 4's prompts served
   through the bucket graphs and through the same engine loop run
   eagerly (every bucket's step called directly on the card), target-only
   and with ``spec_k`` 3 and the ``small`` draft: equal token streams,
   every call's logits within 1e-5 of the largest (bitwise equality
   printed), the speculative stream equal to target-only; (b)
   ``get_decode_symbol`` bound at (32, 1) with phase 5's trained
   parameters and stepped 128 positions through ``decode_step``: the
   probabilities within 2e-4 relative / 2e-5 absolute of the training
   symbol's full forward at every position, the card within 1e-5 of the
   largest of the CPU's, ``decode_step`` at position 128 raising and a raw
   forward there returning NaN with both caches bitwise unchanged; (c)
   ``_contrib_PagedAttention`` from ``mx.sym`` at K3's serving shape
   (float32 tables and lengths, as a bound graph holds them) against
   ``paged_attention_reference`` within the phase-3 tolerance, one
   ``paged_decode`` launch per forward; (d) what the graphs recover: host
   wall per decode step at batch 32, per speculative step (``spec_k`` 3,
   drafts ``small`` and ``self``) and per prefill call at every length
   bucket, graphs against eager, with device busy time, idle share and
   device operations per step (one ``torch.profiler`` window each),
   beside the card's name and power limit;
17. the image-classification zoo through ``tools/train_imagenet`` — (a)
   AlexNet at ``examples/train_imagenet.py``'s defaults (1000 classes,
   3x224x224, batch 128, SGD lr 0.1, momentum 0.9, wd 1e-4,
   ``MultiFactorScheduler`` with its first boundary at update 10,
   Xavier gaussian/in/2, ``acc`` and top-5, seeded synthetic images whose
   class sets a per-class mean, 6 distinct batches per epoch): 30 fused
   steps (one CUDA graph, replayed) and 12 classic, each with host wall
   per step, images/s and peak memory, top-5 rising and the loss falling
   from the first epoch to the last (top-1 logged), one ``torch.profiler``
   window of each path's step (busy share, device operations, the
   largest by name) and LRN's and
   Dropout's forward + backward device time; (b) checks: two consecutive
   replays draw different masks, a second run from the same seed replays
   them bitwise, a replay's masks equal an eager step's from the same
   generator state bitwise, the lr written before every fused step is the
   schedule's at its update count and the classic Updater's at that count
   (the steps differ only on the boundary step, the documented skew), and
   one AlexNet step at batch 8 card vs CPU with the card's masks
   installed on both sides (gradients within 1e-3 of the largest at a
   point the CPU finds smooth, phase 6's rule; where the card's rounding
   still crosses a kink there, logged, the next smooth point); (c) vgg-16, inception-bn, googlenet, inception-v3 and
   inception-resnet-v2 (3x299x299), resnext-50, lenet and mlp (1x28x28,
   10 classes) at batch 32: two fused steps each with a finite loss, one
   forward at batch 2 card vs CPU within 1e-4 of the largest; (d) the
   LSTM LM with dropout 0.2 between its layers, the RNN op's and
   ``DropoutCell``'s, three steps of one bucket: the two replays draw
   different masks. No port kernel runs in phase 17.
18. DCGAN through two Modules and the operator sweep — (a) the zoo's
   ``make_generator``/``make_discriminator`` at MXNet's example widths
   (ngf = ndf = 64, 3 channels, batch 64, z 100, 64x64 images, Adam lr
   2e-4 beta1 0.5, ``Normal(0.02)``, seeded images in [-1, 1]) through
   ``tools/dcgan.train``: 45 steps of the example's five-call loop
   (G forward; D on fake and on real, gradients summed by hand; D update;
   D on fake with label 1; G backward from D's input gradient; G update),
   every loss finite, host wall per step, images/s, peak memory, the
   losses by third, one ``torch.profiler`` window (busy share, device
   operations); no port kernel on its path; (b) one GAN step at batch 8
   card vs CPU from the trained parameters: D's and G's parameter
   gradients and G's input gradient within 1e-3 of the largest at a
   point the CPU finds smooth (17(b)'s rule for kinks the card crosses);
   (c) every registered op name and the sweep's variants
   (``mxnet_tpu_torch.test_utils``) forward and backward on the card
   against the CPU: arrays on cuda:0, smooth ops within 1e-5 of the
   largest, comparison, rounding, indexing and ordering ops exactly, the
   samplers by shape and finiteness; (d) ``tools/dcgan.py`` at the
   example's defaults (ngf 32, one channel) for 10 steps, its JSON line.
19. SSD-300, Custom and SequentialModule — (a) the zoo's SSD-300
   (VGG16-reduced, 8732 anchors) through ``tools/train_ssd.fit`` at the
   reference's training configuration (VOC's 20 classes, batch 32,
   300x300, labels (32, 8, 5), SGD lr 0.004 momentum 0.9 wd 5e-4,
   Xavier, the example's seeded synthetic set): 20 fused steps (one CUDA
   graph: the matching, the mining and the 400-row NMS inside it) and 5
   classic, every metric finite, host wall per step, images/s, peak
   memory, one ``torch.profiler`` window of each path's step (busy share,
   device operations); the fused and classic parameters after the first
   step within 1e-4 when both chose the same targets (else the next seed,
   logged); no port kernel on its path; (b) one step at batch 2 card vs
   CPU from the trained parameters with the CPU's ReLU masks and
   max-pooling choices installed on the card (``test_utils.
   installed_decisions``; the count of ReLU inputs the card's rounding put
   across zero natively logged): targets exact (else the next seeded
   point, logged), outputs within 1e-4 of the largest, detections equal
   up to rows of equal score trading places, gradients within 1e-3; (c)
   the sweep's cases of the slice's 22 op names (held in 18(c)): their
   count and worst error; MultiBoxTarget and MultiBoxDetection at batch 32
   over SSD's anchors card vs CPU: targets, masks and the kept set exact,
   encodings, boxes and scores within 1e-5, and their device time; (d)
   ``tools/train_ssd.py --evaluate`` at the example's defaults as a
   subprocess, its JSON line, mAP finite; (e) a fit of a symbol holding a
   ``Custom`` op (classic path: host Python is never replayed from a
   graph) and of a ``SequentialModule`` of two Modules, each card vs CPU
   within 1e-4.
20. autograd and the data pipeline — (a) ``contrib.autograd`` over
   ``_contrib_FlashAttention`` at the training shape (32, 4, 128, 64)
   float32 causal and over one Transformer-LM attention block
   (``_contrib_MultiHeadAttention``, d 256, 4 heads, residual, ReLU) at
   batch 32, seq 128: one launch each of K1, K2a and K2b per backward (the
   launch counters set to 0 just before each run and read just after),
   outputs within 1e-4 and gradients within 1e-3 of the largest (phase 3's
   and phase 6's tolerances) of the same graph with the plain versions on
   the card; ``test_utils.check_consistency`` over [cpu, gpu(0)] on five
   ops, forward and backward (1e-3, the reference's float32 tolerance);
   (b) the native host stage built (its JPEG decoder named on its own
   line), its decode against PIL's (pixel difference), 320 synthetic
   JPEGs of ImageNet-like size (short side 256-500) packed by the port's
   ``tools/im2rec.py`` and read by ``ImageRecordIter`` (random 224 crop,
   mirror, mean/std on the uint8 wire) into a null consumer: images/s on
   the native and Python backends with the thread count; (c) ResNet-50 at
   bench.py's configuration through ``tools/train_imagenet.py
   --data-dir`` on those records (native backend, DeviceFeedIter, the
   uint8 batch as the fused CUDA graph's static input): images/s, host
   wall per step and the device's busy share (``torch.profiler``) against
   phase 9's synthetic-data step, at 8 decode threads and at 4; (d)
   ``_image_wire_normalize`` card vs CPU (bitwise), and three fused
   float32 ResNet-50 steps at batch 4 fed
   the uint8 wire against the same steps fed host-normalized float32
   batches, both with cuDNN's deterministic algorithms (outputs and BN
   statistics within 1e-4, phase 10's, updates within 1e-4 of the
   largest; bitwise expected); (e) ``tools/train_ssd.py --data-dir``
   over ``ImageDetRecordIter`` records for a few steps.

Every phase that fails raises, so the exit code is not 0. The last two
lines are the ``kernels`` JSON object and the ``ok`` JSON object; the card
line comes just before them.
"""
import contextlib
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
# the LM's fused and classic fits (20 Adam steps at lr 1e-3): the same
# arithmetic in the same order, but the embedding's backward adds its rows
# with atomics in an order that changes from run to run, and Adam's
# division by sqrt(v) carries a rounding difference into the weights;
# 1e-4 absolute is a tenth of one step's largest move (lr)
FUSED_CLASSIC_TOL = 1e-4
# ResNet-50, one float32 fused step at batch 4, card vs CPU (cuDNN's
# algorithms sum in other orders than the CPU's, through 50 layers).
# Outputs and BN moving statistics: relative to the largest CPU value of
# each tensor (the moving variance is the one-pass E[x^2] - mean^2 of the
# JAX package, which in float32 loses digits where |mean| >> std).
RESNET_OUT_TOL = 1e-4
RESNET_AUX_TOL = 1e-4
# The updates: this step's gradients sit on ReLU kinks that a rounding
# difference flips (a ResNet-50 at initialization, BatchNorm over 4
# samples), so no fixed bound tells the card from the CPU. The yardstick
# is measured in the same run: how far the CPU's own step moves when the
# parameters move by a seeded 1e-7 relative perturbation (float32's
# resolution). The card's step may differ from the CPU's by at most
# UPDATE_SENSITIVITY_FACTOR times that, both as the largest difference
# over the largest update of the whole step.
UPDATE_SENSITIVITY_FACTOR = 3.0
PERTURBATION = 1e-7
# The LM's card-vs-CPU step (phases 6 and 8) holds gradients to GRAD_TOL
# only where the reference is smooth. Where a ReLU input of the batch lies
# within float32 rounding of its kink, the card's rounding may take the
# other side of it and move one hidden unit's gradient by 1e-3 to 1e-2 of
# the parameter's largest: that tests the kink, not the kernels. A point is
# taken as smooth when moving every parameter by +-PERTURBATION (relative,
# seeded) moves no parameter's CPU gradient by more than KINK_TOL of its
# largest (a smooth point moves ~1e-6, a kink as much as the card's gap);
# else the step runs at the first of KINK_TRIES seeded points within
# KINK_STEP (relative) of the given one that is. The CPU alone decides,
# before the card runs.
KINK_TOL = 1e-4
KINK_STEP = 1e-5
KINK_TRIES = 8

# bench.py's ResNet-50 configuration
RESNET = dict(num_classes=1000, num_layers=50, image_shape="3,224,224",
              layout="NCHW")
RESNET_SHAPE = tuple(int(x) for x in RESNET["image_shape"].split(","))
RESNET_BATCH = 32
RESNET_STEPS = 40
CLASSIC_STEPS = 12
# the zoo LM at head_dim 512, for the wide flash kernels (phase 8)
WIDE = dict(vocab_size=32000, num_layers=2, model_dim=1024, num_heads=2,
            ffn_dim=2048, seq_len=128)
WIDE_BATCH = 8
# the wide kernels' second timed shape (phase 11): (b, h, s, d), causal
WIDE_LONG = (2, 8, 2048, 512)

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


def host_us_per_op(n=5000):
    """Host microseconds to enqueue one small op on the card (the median
    of five runs of ``n`` in-place adds): the per-op overhead that a
    host-bound step pays; logged in phase 1 and again in phase 18, to
    see whether the process itself slowed over the run."""
    x = torch.zeros(16, device="cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


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


def check_flash_wide(A, build):
    """The wide route (D > 256: forward, dK/dV and dQ of flash_wide.cu)
    through the autograd Function against the plain versions on the same
    card tensors, causal, in f32, bf16 and f16, at D 264, 384 and 512 (a
    block holds all of D) and 1032 (three slices of 344 columns), and at
    D 512 in f32 with 40 queries and 100 keys, whose keys from 40 on no
    query sees: their dK and dV rows must be exactly 0 (the wrapper
    allocates them with ``torch.empty``); bitwise equal on a second
    launch."""
    rng = np.random.default_rng(8)
    worst = {}
    before = {n: build.KERNELS[n].launches for n in WIDE_KERNELS}
    cases = [(70, 70, d, dt) for d in (264, 384, 512, 1032)
             for dt in (torch.float32, torch.bfloat16, torch.float16)]
    cases.append((40, 100, 512, torch.float32))
    for sq, sk, d, dt in cases:
        q, k, v = flash_inputs(rng, 2, 2, sq, sk, d, dt)
        g = flash_inputs(rng, 2, 2, sq, sq, d, dt)[0]
        out, lse = A.flash_attention_forward(q, k, v, True)
        ref_out, ref_lse = A._flash_forward_plain(q, k, v, True,
                                                  1.0 / math.sqrt(d))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad(A.flash_attention(*leaves, True), leaves, g)
        again = torch.autograd.grad(A.flash_attention(*leaves, True), leaves, g)
        ref = A._flash_backward_plain(q, k, v, out.to(dt), lse, g, True,
                                      1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        ferr = max((out - ref_out).abs().max().item(),
                   (lse - ref_lse).abs().max().item())
        berrs = [(a.float() - r.float()).abs().max().item()
                 for a, r in zip(got, ref)]
        berr = max(berrs)
        if dt == torch.float32:
            ftol, btol = F32_TOL, F32_TOL
        else:
            ftol, btol = ((BF16_TOL, BF16_REL_TOL) if dt == torch.bfloat16
                          else (F32_TOL, F16_REL_TOL))
            berr = berr / max(r.float().abs().max().item() for r in ref)
        log("  flash_wide sq=%d sk=%d d=%d %s causal: fwd max_abs_err "
            "%.3e (tol %.0e); bwd dq %.3e dk %.3e dv %.3e -> %s %.3e (tol "
            "%.0e)" % (sq, sk, d, str(dt)[6:], ferr, ftol, *berrs,
                       "abs" if dt == torch.float32 else "rel", berr,
                       btol))
        if sk > sq:
            check(all((a[:, :, sq:] == 0).all().item() for a in got[1:]),
                  "flash_wide_bwd_dkv: keys no query sees have nonzero "
                  "dK/dV rows")
        check(torch.isfinite(out).all().item(), "wide flash out not finite")
        check(ferr <= ftol, "flash_wide_fwd disagrees with its plain version")
        check(berr <= btol, "flash_wide backward kernels disagree with the "
              "plain version")
        check(all(torch.equal(a, a2) for a, a2 in zip(got, again)),
              "two wide launches gave different gradient bits")
        worst[dt] = max(worst.get(dt, 0.0), ferr, berr)
    ran = {n: build.KERNELS[n].launches - before[n] for n in WIDE_KERNELS}
    # per case: three forwards (one direct, two through autograd) and two
    # backwards
    check(ran == {"flash_wide_fwd": 3 * len(cases),
                  "flash_wide_bwd_dkv": 2 * len(cases),
                  "flash_wide_bwd_dq": 2 * len(cases)},
          "the wide kernels did not take D > 256: %s" % ran)
    log("  flash_wide: every case bitwise equal across two launches; "
        "launches %s" % ran)
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


def bucket_counts(cfg):
    """The bucket graphs an engine of ``cfg`` captures, per program."""
    n_pre, n_dec = len(cfg.prefill_buckets()), len(cfg.decode_buckets())
    want = {"serving.prefill": n_pre, "serving.decode": n_dec}
    if cfg.spec_k:
        want.update({"serving.draft": n_pre + n_dec, "serving.verify": n_dec})
    return want


def check_captures(eng, when):
    """``stats()["compiles"]`` counts one capture per bucket per program."""
    got = {p: c["count"] for p, c in eng.stats()["compiles"].items()}
    check(got == bucket_counts(eng.config),
          "captures per program %s %s, want one per bucket %s"
          % (got, when, bucket_counts(eng.config)))
    return got


def run_serving(S, M, build, tel):
    cfg = S.ServingConfig(**SERVE)
    params = M.random_params(cfg, seed=0)
    eng = S.ServingEngine(cfg, arg_params=params, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    log("  warmup (every prefill and decode bucket's CUDA graph): %.3f s"
        % (time.perf_counter() - t0))
    captured = check_captures(eng, "after warmup()")
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
    check(check_captures(eng, "after the timed window") == captured,
          "a bucket was captured in the timed window")
    st = eng.stats()
    log("  captures per program %s (one per bucket, none in the timed "
        "window); replays %s" % (captured, {p: c["runs"] for p, c in
                                            st["compiles"].items()}))
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
def lm_stream(n, seed=0, cfg=TRAIN):
    """``examples/train_lm.py``'s synthetic stream: token t+1 = token t + 1
    (mod V), each sequence from a random start (numpy seed)."""
    V, T = cfg["vocab_size"], cfg["seq_len"]
    rng = np.random.RandomState(seed)
    X = (rng.randint(0, V, (n, 1)) + np.arange(T)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


class no_fused:
    """``MXNET_MODULE_NO_FUSED=1`` for the body: the classic path."""

    def __enter__(self):
        import os

        os.environ["MXNET_MODULE_NO_FUSED"] = "1"

    def __exit__(self, *exc):
        import os

        del os.environ["MXNET_MODULE_NO_FUSED"]
        return False


def run_training(mx, build, fused=True):
    """``Module.fit`` of the zoo Transformer-LM at full width on the card,
    on the fused step (a CUDA graph) or the classic path."""
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
    with (contextlib.nullcontext() if fused else no_fused()):
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
    path = "fused" if fused else "classic"
    log("  [%s] %d epochs x %d batches of %d x %d tokens: %d steps in %.3f s; "
        "first step %.4f s; host wall per step (median after the first, "
        "synchronized) %.5f s = %.1f tokens/s"
        % (path, epochs, steps // epochs, batch, TRAIN["seq_len"], steps,
           wall, per_step[0], step_s, tokens / step_s))
    if fused:
        tr = mod._fused.trainer if mod._fused is not None else None
        check(tr is not None and tr.captures == 1
              and tr.replays == epochs * (len(X) // batch) - 1,
              "the LM's fit did not run one captured graph: %s"
              % ((None if tr is None else (tr.captures, tr.replays)),))
        log("  [fused] one CUDA graph captured, %d replays; kernel launches "
            "per replay %s" % (tr.replays, tr._per_replay))
    else:
        check(mod._fused is None, "MXNET_MODULE_NO_FUSED=1 still fused")
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
    it.reset()
    batch_ = next(iter(it))

    def step():
        mod.forward(batch_, is_train=True)
        mod.backward()
        mod.update()

    PROFILES.append(("LM " + path, step, step_s))
    return launches, {"steps": steps, "step_s": step_s, "ppl": ppl}, params, mod


def fused_against_classic(fused, classic, what="after 20 steps"):
    """The final parameters of a model's fused and classic fits."""
    diff = {n: float(np.abs(fused[n] - classic[n]).max()) for n in fused}
    worst = max(diff, key=diff.get)
    log("  fused against classic %s: worst parameter %s max abs "
        "diff %.3e (tol %.0e over %d parameters)"
        % (what, worst, diff[worst], FUSED_CLASSIC_TOL, len(diff)))
    check(diff[worst] <= FUSED_CLASSIC_TOL,
          "the fused and classic fits disagree")


def rel(g, ref):
    """Per name: max |g - ref| over max |ref|."""
    return {n: float(np.abs(g[n] - ref[n]).max()
                     / max(np.abs(ref[n]).max(), 1e-30)) for n in ref}


def moved(point, scale, seed):
    """Every parameter moved by a seeded relative ``scale``."""
    r = np.random.RandomState(seed)
    return {n: (v * (1 + scale * r.standard_normal(v.shape))).astype(
        np.float32) for n, v in point.items()}


def smooth_point(mx, step, params, first=0):
    """The point a card-vs-CPU step is held at: ``params`` or the first of
    KINK_TRIES seeded points within KINK_STEP of them (from try ``first``
    on) where the CPU's own gradient is smooth (KINK_TOL), chosen on the
    CPU before the card is held to it. ``step(ctx, point) -> (outputs,
    {name: gradient})``. Returns (point, its try, the largest move, its
    parameter, the CPU's outputs and gradients there)."""
    for k in range(first, KINK_TRIES + 1):
        point = params if k == 0 else moved(params, KINK_STEP, 100 + k)
        out_h, g_h = step(mx.cpu(), point)
        move = {}
        for sign in (1, -1):
            for n, x in rel(step(mx.cpu(), moved(point, sign * PERTURBATION,
                                                 6))[1], g_h).items():
                move[n] = max(move.get(n, 0.0), x)
        kink = max(move, key=move.get)
        if move[kink] <= KINK_TOL:
            break
        # the card's gap at a point it is not held to, for the log
        gap = rel(step(mx.gpu(0), point)[1], g_h)
        log("  %s: the CPU gradient of %s moves by %.3e of its largest under "
            "a +-%.0e parameter move (a ReLU kink; KINK_TOL %.0e), the card's "
            "by %.3e: not held to GRAD_TOL there"
            % ("the given parameters" if k == 0 else "seeded point %d" % k,
               kink, move[kink], PERTURBATION, KINK_TOL, gap[kink]))
    check(move[kink] <= KINK_TOL, "no smooth point within %d tries"
          % KINK_TRIES)
    return point, k, move[kink], kink, out_h, g_h


def train_step_card_vs_cpu(mx, params, cfg=TRAIN):
    """One ``forward_backward`` of 4 sequences from the same parameters on
    the card (kernels) and on the CPU (plain versions), for the LM of
    ``cfg``: at ``params`` or, where the CPU's gradient there is not smooth
    (a ReLU kink, see KINK_TOL), at the first smooth seeded point near
    them."""
    X, Y = lm_stream(4, seed=1, cfg=cfg)
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=mx.cpu())],
                            [mx.nd.array(Y, ctx=mx.cpu())])

    def step(ctx, point):
        mod = mx.mod.Module(mx.models.transformer_lm(**cfg), context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("softmax_label", Y.shape)])
        mod.init_params(arg_params=point)
        mod.forward_backward(batch)
        exe = mod._exec_group.execs[0]
        return (mod.get_outputs()[0].asnumpy(),
                {n: exe.grad_dict[n].asnumpy() for n in params})

    point, k, move, kink, out_h, g_h = smooth_point(mx, step, params)
    out_c, g_c = step(mx.gpu(0), point)
    check(np.isfinite(out_c).all() and out_c.shape == out_h.shape,
          "card outputs not finite or misshapen")
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    grel = rel(g_c, g_h)
    worst = max(grel, key=grel.get)
    log("  one step at batch 4 x %d, head_dim %d, %s (CPU gradient's largest "
        "move under a +-%.0e parameter move %.3e, %s): max abs output diff "
        "card vs CPU / max abs output %.3e (tol %.0e); worst gradient %s: max "
        "abs diff / max abs grad %.3e (tol %.0e over %d parameters)"
        % (cfg["seq_len"], cfg["model_dim"] // cfg["num_heads"],
           "at the given parameters" if k == 0 else
           "at seeded point %d within %.0e of the given parameters"
           % (k, KINK_STEP), PERTURBATION, move, kink, out_err,
           OUT_REL_TOL, worst, grel[worst], GRAD_TOL, len(grel)))
    check(out_err <= OUT_REL_TOL, "card outputs disagree with the CPU")
    check(all(np.isfinite(g_c[n]).all() for n in params), "non-finite gradient")
    check(grel[worst] <= GRAD_TOL, "card gradients disagree with the CPU")


# ------------------------------------------------ training past D 256
WIDE_KERNELS = ("flash_wide_fwd", "flash_wide_bwd_dkv", "flash_wide_bwd_dq")


def run_wide_training(mx, build):
    """The zoo LM at head_dim 512 through ``Module.fit`` (fused): the wide
    flash kernels once per layer and step, inside the captured graph."""
    V, T = WIDE["vocab_size"], WIDE["seq_len"]
    rng = np.random.RandomState(3)
    X = (rng.randint(0, V, (4 * WIDE_BATCH, 1)) + np.arange(T)) % V
    Y = (X + 1) % V
    it = mx.io.NDArrayIter(X.astype(np.float32), Y.astype(np.float32),
                           batch_size=WIDE_BATCH)
    mod = mx.mod.Module(mx.models.transformer_lm(**WIDE), context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=None)
    for k in build.KERNELS.values():
        k.launches = 0
    mod.fit(it, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(1)),
            eval_metric=metric)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    steps = 4
    L = WIDE["num_layers"]
    ppl = metric.get()[1]
    log("  head_dim %d, %d layers, batch %d x %d: %d fused steps, perplexity "
        "%.3f; launches %s" % (WIDE["model_dim"] // WIDE["num_heads"], L,
                               WIDE_BATCH, T, steps, ppl,
                               {n: v for n, v in launches.items() if v}))
    check(math.isfinite(ppl), "non-finite loss at head_dim 512")
    check(mod._fused is not None and mod._fused.trainer.captures == 1,
          "the head_dim 512 fit did not run a captured graph")
    for name in WIDE_KERNELS:
        check(launches[name] == L * steps, "%s launched %d times in %d steps"
              % (name, launches[name], steps))
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches[name] == 0, "%s ran at head_dim 512" % name)
    return launches, {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


# ---------------------------------------------------------------- ResNet-50
class ResidentIter:
    """``bench.py``'s synthetic iterator: one device-resident seeded batch,
    reused every step."""

    def __init__(self, mx, batch, data_shape, classes, epoch_batches,
                 ctx):
        rng = np.random.RandomState(0)
        self.data = mx.nd.array(rng.rand(batch, *data_shape).astype(
            np.float32), ctx=ctx)
        self.label = mx.nd.array(rng.randint(0, classes, (batch,)).astype(
            np.float32), ctx=ctx)
        self.provide_data = [mx.io.DataDesc("data", (batch,) + data_shape)]
        self.provide_label = [mx.io.DataDesc("softmax_label", (batch,))]
        self.batch_size = batch
        self._n = epoch_batches
        self._i = 0
        self.batch = mx.io.DataBatch(data=[self.data], label=[self.label],
                                     pad=0)

    def __iter__(self):
        return self

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        self._i += 1
        return self.batch


def batch_loss(mod, label):
    """Mean cross-entropy of the step's SoftmaxOutput probabilities."""
    p = mod.get_outputs()[0].data.float()
    picked = p.gather(1, label.data.long()[:, None]).clamp_min(1e-30)
    return -picked.log().mean().item()


# device operations by the substring of their name, first match wins
KERNEL_CLASSES = (("conv/GEMM", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                                 "implicit", "wgrad", "dgrad")),
                  ("port kernels", ("flash_", "wide_", "paged_")),
                  ("reductions", ("reduce",)),
                  ("copies", ("memcpy", "memset", "copy")),
                  ("elementwise", ("elementwise",)))


def device_profile(step, n=3):
    """(busy ms per step, device operations per step, the six largest by
    name as (ms per step, name), ms per step by KERNEL_CLASSES) over ``n``
    calls of ``step``: what one ``torch.profiler`` window sees on the
    device; None when it sees nothing there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    except Exception as e:   # the profiler is a measurement, not a check
        log("  (profiler failed: %s)" % e)
        return None
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(((us / 1e3 / n, name[:60]) for name, us in by_name.items()),
                 reverse=True)[:6]
    classes = {}
    for name, us in by_name.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in low for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / n
    return busy_us / 1e3 / n, len(dev) / n, top, classes


# the training steps profiled at the end of the run (one torch.profiler
# window each; a profiler pass over them earlier left later passes, the
# library yardsticks' kernel listings, empty): (label, step, host wall s)
PROFILES = []


def log_profile(path, prof, step_s):
    if prof is None:
        log("  [%s] device busy per step: not measured (the profiler saw no "
            "device operation)" % path)
        return
    log("  [%s] device busy %.3f ms per step (%.1f %% of the host wall), "
        "%.1f device operations per step (torch.profiler, 3 steps); by class: "
        "%s; largest: %s"
        % (path, prof[0], 100 * prof[0] / (step_s * 1e3), prof[1],
           ", ".join("%s %.3f ms" % kv for kv in sorted(
               prof[3].items(), key=lambda kv: -kv[1])),
           "; ".join("%s %.3f ms" % (name, ms) for ms, name in prof[2])))


def run_resnet(mx, build, fused=True):
    """ResNet-50 through ``Module.fit`` at ``bench.py``'s configuration."""
    steps = RESNET_STEPS if fused else CLASSIC_STEPS
    ctx = mx.gpu(0)
    it = ResidentIter(mx, RESNET_BATCH, RESNET_SHAPE,
                      RESNET["num_classes"], steps, ctx)
    mod = mx.mod.Module(mx.models.resnet(**RESNET), context=ctx,
                        compute_dtype="bfloat16")
    stamps, losses = [], {}

    def batch_end(param):
        if param.nbatch in (0, steps - 1):
            losses[param.nbatch] = batch_loss(mod, it.label)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # what earlier phases keep
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if fused else no_fused()):
        mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "rescale_grad": 1.0 / RESNET_BATCH},
                initializer=mx.init.Xavier(
                    rnd_type="gaussian", factor_type="in", magnitude=2,
                    rng=torch.Generator().manual_seed(0)),
                eval_metric=mx.metric.Accuracy(), batch_end_callback=batch_end)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
    per_step = np.diff([t0] + stamps)
    warm = 2 if fused else 1
    step_s = float(np.median(per_step[warm:]))
    path = "fused" if fused else "classic"
    check(len(stamps) == steps, "fit ran %d steps" % len(stamps))
    if fused:
        tr = mod._fused.trainer if mod._fused is not None else None
        check(tr is not None and tr.captures == 1 and tr.replays == steps - 1,
              "ResNet-50's fit did not run one captured graph")
    else:
        check(mod._fused is None, "MXNET_MODULE_NO_FUSED=1 still fused")
    check(not launches, "a port kernel ran on ResNet's path: %s" % launches)

    def step():
        mod.forward(it.batch, is_train=True)
        mod.backward()
        mod.update()

    PROFILES.append(("ResNet-50 " + path, step, step_s))
    log("  [%s] %d steps of batch %d: first step %.4f s; host wall per step "
        "(median after %d warm-up, synchronized) %.5f s = %.1f images/s; peak "
        "memory %.3f GB" % (path, steps, RESNET_BATCH, per_step[0], warm,
                            step_s, RESNET_BATCH / step_s, peak / 1e9))
    log("  [%s] batch loss at step 1 %.4f, at step %d %.4f"
        % (path, losses[0], steps, losses[steps - 1]))
    check(all(math.isfinite(v) for v in losses.values()), "non-finite loss")
    check(losses[steps - 1] < losses[0], "the loss did not fall")
    if fused:
        log("  [fused] optimizer state on the card: %.3f GB"
            % (mod._fused.state_bytes() / 1e9))
    return {"step_s": step_s, "peak": peak, "losses": losses}


def resnet_card_vs_cpu(mx):
    """One fused float32 step of ResNet-50 at batch 4 from the same
    parameters on the card and on the CPU; then, on the card, two graph
    replays after the eager first step against three eager steps."""
    batch = 4
    sym = mx.models.resnet(**RESNET)
    rng = np.random.RandomState(5)
    X = rng.rand(batch, *RESNET_SHAPE).astype(np.float32)
    Y = rng.randint(0, RESNET["num_classes"], (batch,)).astype(np.float32)
    shapes = dict(data_shapes=[("data", X.shape)],
                  label_shapes=[("softmax_label", Y.shape)])
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind(**shapes)
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2,
                                    rng=torch.Generator().manual_seed(2)))
    args0, auxs0 = ({n: a.asnumpy() for n, a in d.items()}
                    for d in init.get_params())

    def fused_module(ctx, args=args0):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(**shapes)
        mod.init_params(arg_params=args, aux_params=auxs0)
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05,
                                             "momentum": 0.9,
                                             "rescale_grad": 1.0 / batch})
        check(mod._fused is not None, "kvstore='device' did not fuse")
        return mod

    def steps(mod, ctx, n):
        b = mx.io.DataBatch([mx.nd.array(X, ctx=ctx)], [mx.nd.array(Y, ctx=ctx)])
        for _ in range(n):
            mod.forward(b, is_train=True)
            mod.update()
        out = mod.get_outputs()[0].asnumpy()
        args, auxs = ({n_: a.asnumpy() for n_, a in d.items()}
                      for d in mod.get_params())
        return out, args, auxs

    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        res[ctx.type] = steps(fused_module(ctx), ctx, 1)
    (out_c, a_c, x_c), (out_h, a_h, x_h) = res["cuda"], res["cpu"]
    noise = np.random.RandomState(6)
    args_p = {n: (v * (1 + PERTURBATION * noise.standard_normal(v.shape)))
              .astype(np.float32) for n, v in args0.items()}
    _, a_p, _ = steps(fused_module(mx.cpu(), args_p), mx.cpu(), 1)
    check(np.isfinite(out_c).all()
          and out_c.shape == out_h.shape == (batch, RESNET["num_classes"]),
          "card outputs not finite or misshapen")
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    upd, glob = compare_step(args0, a_c, args0, a_h)
    _, sens = compare_step(args_p, a_p, args0, a_h)
    aux = {n: float(np.abs(x_c[n] - x_h[n]).max() / np.abs(x_h[n]).max())
           for n in auxs0}
    wu, wa = max(upd, key=upd.get), max(aux, key=aux.get)
    log("  one float32 step at batch %d: outputs max abs diff / max %.3e (tol "
        "%.0e); worst BN moving statistic %s %.3e (tol %.0e over %d); "
        "updates: max abs diff / largest update of the step %.3e against the "
        "CPU step's own move under a %.0e parameter perturbation %.3e (tol "
        "%.0fx); worst per parameter %s %.3e of its largest update"
        % (batch, out_err, RESNET_OUT_TOL, wa, aux[wa], RESNET_AUX_TOL,
           len(aux), glob, PERTURBATION, sens, UPDATE_SENSITIVITY_FACTOR, wu,
           upd[wu]))
    check(out_err <= RESNET_OUT_TOL, "ResNet outputs: card disagrees with CPU")
    check(aux[wa] <= RESNET_AUX_TOL, "ResNet BN statistics: card disagrees")
    check(glob <= UPDATE_SENSITIVITY_FACTOR * sens,
          "ResNet updates: card disagrees with CPU")
    # a replay and an eager step from one state: the graph's module after
    # its eager first step and its captured second, its state saved, one
    # replay, the state put back, one eager step of the same trainer
    graph = fused_module(mx.gpu(0))
    steps(graph, mx.gpu(0), 2)
    fused, tr = graph._fused, graph._fused.trainer
    st = fused.state
    tensors = (list(st.params.values()) + list(st.auxs.values())
               + [t for slots in st.states.values() for t in slots])
    saved = [t.clone() for t in tensors]
    start = {n: t.cpu().numpy().copy() for n, t in st.params.items()}
    steps(graph, mx.gpu(0), 1)
    check(tr.captures == 1 and tr.replays == 2, "the steps did not replay")
    a_g = {n: t.cpu().numpy().copy() for n, t in st.params.items()}
    x_g = {n: t.cpu().numpy().copy() for n, t in st.auxs.items()}
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    tr._run(st.params, st.auxs, st.states, tr.input_buffers())
    a_e = {n: t.cpu().numpy().copy() for n, t in st.params.items()}
    x_e = {n: t.cpu().numpy().copy() for n, t in st.auxs.items()}
    upd, glob = compare_step(start, a_g, start, a_e)
    rep_aux = max(float(np.abs(x_g[n] - x_e[n]).max() / np.abs(x_e[n]).max())
                  for n in auxs0)
    log("  one graph replay against one eager step from the same state: "
        "updates' max abs diff / largest update %.3e (tol %.0fx the "
        "perturbation's %.3e; worst per parameter %.3e), worst BN statistic "
        "%.3e (tol %.0e)" % (glob, UPDATE_SENSITIVITY_FACTOR, sens,
                             max(upd.values()), rep_aux, RESNET_AUX_TOL))
    check(rep_aux <= RESNET_AUX_TOL and glob <= UPDATE_SENSITIVITY_FACTOR * sens,
          "a graph replay disagrees with an eager fused step")


def compare_step(start, got, ref_start, ref):
    """A step's updates (``got - start``) against a reference step's
    (``ref - ref_start``): per parameter the largest diff over the
    reference's largest update of that parameter, and the largest diff
    over the largest update of the whole step."""
    du = {n: np.abs((got[n] - start[n]) - (ref[n] - ref_start[n])).max()
          for n in ref}
    size = {n: np.abs(ref[n] - ref_start[n]).max() for n in ref}
    upd = {n: float(du[n] / max(size[n], 1e-30)) for n in ref}
    return upd, float(max(du.values()) / max(size.values()))


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
    captured = check_captures(eng, "after warmup()")
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
    check(check_captures(eng, "after the timed window") == captured,
          "a bucket was captured in the timed window")
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
        log("    launches: %s; captures per program %s (one per bucket, none "
            "in the timed window)" % (launches, {
                p: c["count"] for p, c in st["compiles"].items()}))
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
def time_flash(A, b, h, s, d, wide=False):
    """K1 (or, ``wide``, its D > 256 route on the CUDA cores) causal."""
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
    # the kernel's products run on the tensor cores as split TF32 products;
    # the wide route's in float32 on the CUDA cores
    peak, peak_name = ((PEAK_F32_FLOPS, "67 TFLOP/s f32") if wide else
                       (PEAK_K1_FLOPS, "110 TFLOP/s (TF32 x 4.5)"))
    return dict(err=err, ms=ms, plain=plain, lib=lib, flops=flops,
                nbytes=nbytes, peak=peak, peak_name=peak_name,
                shape="q/k/v (%d,%d,%d,%d) f32 causal" % (b, h, s, d))


def time_flash_bwd(A, build, b=32, h=4, s=128, d=64, wide=False):
    """K2a and K2b (or, ``wide``, their D > 256 route) launched alone at the
    training shape; the plain twin and the library yardstick compute dq,
    dk and dv together, so both rows carry the same plain and library
    times. Library: autograd through ``scaled_dot_product_attention``
    (forward + backward) less its forward alone, both with gradients
    enabled."""
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

    dkv_k, dq_k = ((build.FLASH_WIDE_BWD_DKV, build.FLASH_WIDE_BWD_DQ) if wide
                   else (build.FLASH_BWD_DKV, build.FLASH_BWD_DQ))

    def dkv():
        dkv_k.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims)

    def dq_():
        dq_k.launch(*ptrs, dq.data_ptr(), *dims)

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
    # tensor cores as split TF32 products; the wide route's in float32 on
    # the CUDA cores
    if wide:
        peaks = [(PEAK_F32_FLOPS, "67 TFLOP/s f32")] * 2
    else:
        peaks = [(PEAK_K2A_FLOPS, "132 TFLOP/s (TF32 x 3.75)"),
                 (PEAK_K2B_FLOPS, "124 TFLOP/s (TF32 x 4)")]
    return (dict(err=err_dkv, ms=ms_dkv, plain=plain, lib=lib, flops=8 * pairs * d,
                 nbytes=4 * (6 * bhsd + 2 * bhs), shape=shape,
                 peak=peaks[0][0], peak_name=peaks[0][1]),
            dict(err=err_dq, ms=ms_dq, plain=plain, lib=lib, flops=6 * pairs * d,
                 nbytes=4 * (5 * bhsd + 2 * bhs), shape=shape,
                 peak=peaks[1][0], peak_name=peaks[1][1]))


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


# ------------------------------------------- the bucketed LSTM LM (13, 14)
# examples/lstm_bucketing.py's defaults: its PTB-style stdlib_corpus vocab,
# num_embed/num_hidden 200, 2 layers, its buckets and batch, SGD lr 0.01
# momentum 0.9, Xavier, Perplexity(ignore_label=0)
LSTM = dict(num_embed=200, num_hidden=200, num_layers=2, vocab_size=10000)
LSTM_BUCKETS = [10, 20, 30, 40, 60]
LSTM_BATCH = 32
LSTM_SENTENCES = 2000
LSTM_EPOCHS = 4
LSTM_SGD = {"learning_rate": 0.01, "momentum": 0.9}
# phase 14's short fused-RNN fit: every bucket stepped at least twice
LSTM_RNN_SENTENCES = 800


# Zipf exponent of the sentences' first tokens: with starts uniform over
# the 10000 ids every (token, next) pair is seen ~6 times an epoch, and at
# lr 0.01 the LM stays near perplexity V for more epochs than this run
# affords; word frequencies are Zipfian, and with Zipfian starts the
# recipe learns within its first epochs
LSTM_ZIPF = 1.2


def lstm_sentences(n, seed=0):
    """``n`` sentences of 5-60 tokens with ``examples/train_lm.py``'s
    structure: each token the previous + 1, over the ids 2..V-1 (0 stays
    the pad, 1 the unknown word), the first token Zipf-distributed."""
    V = LSTM["vocab_size"]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.zipf(LSTM_ZIPF) - 1
        out.append(list(2 + (start + np.arange(rng.randint(5, 61))) % (V - 2)))
    return out


def bucket_stats(keys, per_step, warm):
    """{bucket: (steps, median host wall after its first ``warm`` steps)}
    and the tokens/s (padded positions) over the steps after warm-up."""
    out, toks, secs = {}, 0, 0.0
    for key in sorted(set(keys)):
        times = [t for k, t in zip(keys, per_step) if k == key]
        steady = times[warm:]
        out[key] = (len(times), float(np.median(steady)) if steady else
                    float("nan"))
        toks += LSTM_BATCH * key * len(steady)
        secs += sum(steady)
    return out, toks / secs if secs else float("nan")


def run_lstm(mx, build, fused=True, rnn_op=False):
    """``BucketingModule.fit`` of the LSTM LM on the card: the unrolled
    LSTMCells for LSTM_EPOCHS epochs of LSTM_SENTENCES sentences (phase 13),
    or the fused RNN op for one epoch of LSTM_RNN_SENTENCES (phase 14); on
    the fused step (a CUDA graph per bucket over one shared state) or the
    classic path."""
    n, seed, epochs = ((LSTM_RNN_SENTENCES, 1, 1) if rnn_op
                       else (LSTM_SENTENCES, 0, LSTM_EPOCHS))
    np.random.seed(seed)   # BucketSentenceIter shuffles with numpy's RNG
    it = mx.rnn.BucketSentenceIter(lstm_sentences(n, seed), LSTM_BATCH,
                                   buckets=LSTM_BUCKETS, invalid_label=0)
    mod = mx.mod.BucketingModule(mx.models.lstm_lm(fused=rnn_op, **LSTM),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=0)
    stamps, keys, ppl = [], [], []

    def batch_end(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        keys.append(param.locals["data_batch"].bucket_key)

    def epoch_end(_epoch, _sym, _arg, _aux):
        ppl.append(metric.get()[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if fused else no_fused()):
        mod.fit(it, num_epoch=epochs, kvstore="local", optimizer="sgd",
                optimizer_params=LSTM_SGD,
                initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)),
                eval_metric=metric, batch_end_callback=batch_end,
                epoch_end_callback=epoch_end)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
    per_step = np.diff([t0] + stamps)
    path = ("fused" if fused else "classic") + (" RNN op" if rnn_op else "")
    stats, tok_s = bucket_stats(keys, per_step, 2 if fused else 1)
    check(len(stamps) == epochs * len(it.idx), "fit ran %d steps" % len(stamps))
    mods = mod._buckets
    check(sorted(mods) == LSTM_BUCKETS, "buckets bound: %s" % sorted(mods))
    log("  [%s] %d epochs, %d steps of batch %d in %.3f s; peak memory %.3f "
        "GB; tokens/s (padded positions, after warm-up) %.1f"
        % (path, epochs, len(stamps), LSTM_BATCH, stamps[-1] - t0, peak / 1e9,
           tok_s))
    for key, (nsteps, med) in stats.items():
        tr = mods[key]._fused.trainer if mods[key]._fused is not None else None
        log("  [%s] bucket %d: %d steps, host wall per step (median after "
            "warm-up, synchronized) %.5f s = %.1f tokens/s%s"
            % (path, key, nsteps, med, LSTM_BATCH * key / med,
               "; captures %d, replays %d" % (tr.captures, tr.replays)
               if tr is not None else ""))
        if fused:
            check(tr is not None and tr.captures == (1 if nsteps > 1 else 0)
                  and tr.replays == nsteps - 1,
                  "bucket %d did not run one captured graph" % key)
        else:
            check(tr is None, "MXNET_MODULE_NO_FUSED=1 still fused")
    if fused:
        states = {id(m._fused.state) for m in mods.values()}
        st = mods[it.default_bucket_key]._fused.state
        names = mods[it.default_bucket_key]._param_names
        storages = {t.untyped_storage().data_ptr() for t in st.params.values()}
        log("  [%s] %d bucket(s) over %d shared state(s): %d master tensors in "
            "%d distinct storages (%d parameters); optimizer state %.3f GB"
            % (path, len(mods), len(states), len(st.params), len(storages),
               len(names), sum(s.numel() * 4 for v in st.states.values()
                               for s in v) / 1e9))
        check(len(states) == 1 and len(storages) == len(names)
              == len(st.params), "the buckets do not share one set of masters")
    log("  [%s] training perplexity per epoch: %s" % (path, ["%.3f" % p for p in ppl]))
    check(not launches, "a port kernel ran on the LSTM's path: %s" % launches)
    check(all(math.isfinite(p) for p in ppl), "non-finite training loss")
    if not rnn_op:
        check(all(b < a for a, b in zip(ppl, ppl[1:])),
              "training perplexity did not fall every epoch")
        check(ppl[-1] < LSTM["vocab_size"] / 2,
              "training perplexity ended near uniform guessing")
    it.reset()
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    for key in (min(LSTM_BUCKETS), max(LSTM_BUCKETS)):
        if not math.isfinite(stats[key][1]):
            continue   # no step after warm-up to profile against
        def step(b=batches[key]):
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()

        log_profile("LSTM %s bucket %d" % (path, key), device_profile(step),
                    stats[key][1])
    params = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return params, stats, ppl


def lstm_step_card_vs_cpu(mx, params, rnn_op):
    """One ``forward_backward`` of the LSTM LM (the fused RNN op, or the
    unrolled cells) at the top bucket, batch 4, from the same parameters on
    the card and on the CPU: probabilities relative to the largest,
    gradients relative to each parameter's largest. An LSTM has no ReLU
    kink: the point needs no smoothness check."""
    T, V = max(LSTM_BUCKETS), LSTM["vocab_size"]
    rng = np.random.RandomState(5)
    X = (2 + (rng.randint(0, V - 2, (4, 1)) + np.arange(T)) % (V - 2)).astype(
        np.float32)
    Y = np.concatenate([X[:, 1:], np.zeros((4, 1), np.float32)], axis=1)
    sym = mx.models.lstm_lm(fused=rnn_op, **LSTM)(T)[0]

    def step(ctx):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("softmax_label", Y.shape)])
        mod.init_params(arg_params=params)
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(X, ctx=mx.cpu())],
                                             [mx.nd.array(Y, ctx=mx.cpu())]))
        exe = mod._exec_group.execs[0]
        return (mod.get_outputs()[0].asnumpy(),
                {n: exe.grad_dict[n].asnumpy() for n in params})

    out_h, g_h = step(mx.cpu())
    out_c, g_c = step(mx.gpu(0))
    check(np.isfinite(out_c).all() and out_c.shape == out_h.shape,
          "card outputs not finite or misshapen")
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    grel = {n: float(np.abs(g_c[n] - g_h[n]).max()
                     / max(np.abs(g_h[n]).max(), 1e-30)) for n in params}
    worst = max(grel, key=grel.get)
    log("  [%s] one step at batch 4 x %d: max abs probability diff card vs "
        "CPU / max abs probability %.3e (tol %.0e); worst gradient %s: max abs "
        "diff / max abs grad %.3e (tol %.0e over %d parameters)"
        % ("RNN op" if rnn_op else "LSTMCells", T, out_err, OUT_REL_TOL,
           worst, grel[worst], GRAD_TOL, len(grel)))
    check(out_err <= OUT_REL_TOL, "card outputs disagree with the CPU")
    check(all(np.isfinite(g_c[n]).all() for n in params), "non-finite gradient")
    check(grel[worst] <= GRAD_TOL, "card gradients disagree with the CPU")


# ------------------------------------------------ resume of the LM (15)
RESUME_TOL = 1e-6   # relative to the largest parameter; bitwise expected
RESUME_EPOCHS = 4


class _Cut(Exception):
    """The job dies (phase 15's mid-epoch cut)."""


def run_resume(mx, build, fused=True):
    """Phase 5's LM under Adam through ``fit``: uninterrupted for
    RESUME_EPOCHS epochs; cut after 2 (``module_checkpoint`` with the
    optimizer states) and resumed by a fresh Module with
    ``fit(auto_resume=...)``; cut in epoch 2 after 2 batches (a checkpoint
    and a ``.resume`` sidecar by ``model.save_resume_state``) and resumed.
    The iterator does not shuffle, so its order does not depend on the
    process's history. Returns the K1/K2a/K2b launches of all five runs."""
    import tempfile

    X, Y = lm_stream(128)
    batch = 32
    per_epoch = len(X) // batch
    L = TRAIN["num_layers"]
    path = "fused" if fused else "classic"
    total = {}

    def fit(mod, epochs, **kw):
        it = mx.io.NDArrayIter(X, Y, batch_size=batch, shuffle=False)
        stamps = []

        def stamp(_param):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        cbs = [stamp] + list(kw.pop("batch_end_callback", []))
        for k in build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with (contextlib.nullcontext() if fused else no_fused()):
                mod.fit(it, num_epoch=epochs, optimizer="adam",
                        optimizer_params={"learning_rate": TRAIN_LR},
                        initializer=mx.init.Xavier(
                            rng=torch.Generator().manual_seed(0)),
                        eval_metric=mx.metric.Perplexity(ignore_label=None),
                        batch_end_callback=cbs, **kw)
        finally:
            torch.cuda.synchronize()
            launches = {n: k.launches for n, k in build.KERNELS.items()
                        if k.launches}
            steps = len(stamps)
            for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
                check(launches.get(name, 0) == L * steps,
                      "%s launched %d times in %d steps" % (
                          name, launches.get(name, 0), steps))
                total[name] = total.get(name, 0) + launches[name]
            tr = mod._fused.trainer if mod._fused is not None else None
            if fused:
                check(tr is not None and tr.captures == 1
                      and tr.replays == steps - 1,
                      "the %d-step run did not run one captured graph" % steps)
            else:
                check(tr is None, "MXNET_MODULE_NO_FUSED=1 still fused")
        return mod, np.diff([t0] + stamps)

    def module():
        return mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.gpu(0))

    def params(mod):
        return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full, per_step = fit(module(), RESUME_EPOCHS)
    peak = torch.cuda.max_memory_allocated() - base
    ref = params(full)
    scale = max(np.abs(v).max() for v in ref.values())
    step_s = float(np.median(per_step[2 if fused else 1:]))
    log("  [%s] uninterrupted: %d steps; host wall per step (median after "
        "warm-up, synchronized) %.5f s = %.1f tokens/s; peak memory %.3f GB"
        % (path, len(per_step), step_s, batch * TRAIN["seq_len"] / step_s,
           peak / 1e9))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = tmp + "/lm"
        cut = module()
        fit(cut, 2, epoch_end_callback=mx.callback.module_checkpoint(
            cut, prefix, save_optimizer_states=True))
        seen = []
        resumed, _ = fit(module(), RESUME_EPOCHS, auto_resume=prefix,
                         batch_end_callback=[lambda p: seen.append(
                             (p.epoch, p.nbatch))])
        check(seen[0] == (2, 0) and len(seen) == 2 * per_epoch,
              "the epoch-boundary resume did not start at epoch 2: %s" % seen[:2])
        prefix = tmp + "/mid"
        holder = {"mod": module()}

        def cut_mid(param):
            if (param.epoch, param.nbatch) == (2, 1):
                mod = holder["mod"]
                mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
                mx.model.save_resume_state(
                    prefix, 2, param.nbatch + 1, numpy_rng=np.random.get_state(),
                    optimizer_counts=mx.model.optimizer_counts(mod))
                raise _Cut()

        try:
            fit(holder["mod"], RESUME_EPOCHS, batch_end_callback=[cut_mid])
        except _Cut:
            pass
        else:
            check(False, "the mid-epoch cut did not happen")
        seen = []
        mid, _ = fit(module(), RESUME_EPOCHS, auto_resume=prefix,
                     batch_end_callback=[lambda p: seen.append((p.epoch, p.nbatch))])
        check(seen[0] == (2, 2) and len(seen) == 2 * per_epoch - 2,
              "the mid-epoch resume did not start at epoch 2 batch 2: %s"
              % seen[:2])
    for label, mod in (("at the epoch boundary", resumed), ("mid-epoch", mid)):
        got = params(mod)
        diff = max(float(np.abs(got[n] - ref[n]).max()) for n in ref)
        log("  [%s] resumed %s: max abs parameter diff against the "
            "uninterrupted run %.3e (%.3e of the largest |parameter| %.4f; tol "
            "%.0e), bitwise %s; Adam update count %d"
            % (path, label, diff, diff / scale, scale, RESUME_TOL,
               all(np.array_equal(got[n], ref[n]) for n in ref),
               mod._optimizer.num_update))
        check(mod._optimizer.num_update == full._optimizer.num_update,
              "the resumed update count differs")
        check(diff / scale <= RESUME_TOL,
              "the resumed run left the uninterrupted one")
    it = mx.io.NDArrayIter(X, Y, batch_size=batch, shuffle=False)
    b0 = next(iter(it))

    def step():
        mid.forward(b0, is_train=True)
        mid.backward()
        mid.update()

    log_profile("LM resumed " + path, device_profile(step), step_s)
    log("  [%s] launches over the five runs: %s" % (path, total))
    return total



# ------------------------------------------------ serving graphs (phase 16)
GRAPH_LOGIT_TOL = 1e-5    # graphs vs eager, relative to the largest logit
DECODE_RTOL, DECODE_ATOL = 2e-4, 2e-5   # tests/test_models.py's tolerance
DECODE_CARD_TOL = 1e-5    # decode symbol card vs CPU, of the largest prob
DECODE_BATCH = 32
TIMED_STEPS = 8


def make_eager(eng):
    """Run every bucket of ``eng`` eagerly on the card: each bucket graph
    takes the path it takes on the CPU (the step called on its static
    inputs at every call, nothing captured) — the reference the graphs are
    held against."""
    for g in eng.bucket_graphs():
        g._cuda = False


class _Recorder:
    """A bucket graph whose every call's logits are kept on the host."""

    def __init__(self, graph, calls):
        self._graph = graph
        self._calls = calls

    def __getattr__(self, name):
        return getattr(self._graph, name)

    def __call__(self, *arrays):
        outs = self._graph(*arrays)
        self._calls.append((self._graph.program, outs[1].cpu()))
        return outs


def record_calls(eng):
    calls = []
    for name in ("_prefill_graphs", "_decode_graphs", "_draft_prefill_graphs",
                 "_draft_decode_graphs", "_verify_graphs"):
        graphs = getattr(eng, name, None)
        for key in list(graphs or ()):
            graphs[key] = _Recorder(graphs[key], calls)
    return calls


def rel_diff(a, b):
    """max |a - b| over the largest |b|, where b is finite; a and b must
    hold NaN at the same places (the overflow contract's poisoned lanes)."""
    nan = torch.isnan(b)
    check(torch.equal(torch.isnan(a), nan), "NaN at different places")
    a, b = a[~nan], b[~nan]
    if not b.numel():
        return 0.0
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def graphs_against_eager(S, M, build, params, prompts):
    """16(a): the prompts through the bucket graphs and through the same
    engine loop run eagerly, target-only and with ``spec_k`` 3 and the
    ``small`` draft: equal token streams, every call's logits within
    GRAPH_LOGIT_TOL of the largest; the speculative stream equals
    target-only. Returns the graph runs' launches (counters set to 0 just
    before each graph run)."""
    total = {n: 0 for n in build.KERNELS}
    streams = {}
    for label, over in (("target-only", dict(spec_k=0)),
                        ("spec_k=3 small", dict(spec_k=3, draft="small"))):
        runs = {}
        for mode in ("graphs", "eager"):
            cfg = S.ServingConfig(**dict(SERVE, **over))
            eng = S.ServingEngine(cfg, arg_params=params, device="cuda")
            if mode == "eager":
                make_eager(eng)
            eng.warmup()
            calls = record_calls(eng)
            for k in build.KERNELS.values():
                k.launches = 0
            torch.cuda.synchronize()
            toks = eng.generate(prompts, 16)
            torch.cuda.synchronize()
            if mode == "graphs":
                for n, k in build.KERNELS.items():
                    total[n] += k.launches
                check(check_captures(eng, "after the graph run")
                      == bucket_counts(cfg), "captures changed")
            runs[mode] = (toks, calls)
        (gt, gc), (et, ec) = runs["graphs"], runs["eager"]
        check(gt == et, "%s: graph and eager token streams differ" % label)
        check(len(gc) == len(ec) and all(a[0] == b[0] for a, b in zip(gc, ec)),
              "%s: graph and eager runs made different calls" % label)
        worst = max(rel_diff(a[1], b[1]) for a, b in zip(gc, ec))
        bitwise = all(torch.allclose(a[1], b[1], rtol=0, atol=0,
                                     equal_nan=True) for a, b in zip(gc, ec))
        log("  %s: %d calls (%s), token streams equal; worst logit diff "
            "%.3e of the largest (tol %.0e); bitwise equal: %s"
            % (label, len(gc), {p: sum(1 for c in gc if c[0] == p)
                               for p in sorted({c[0] for c in gc})},
               worst, GRAPH_LOGIT_TOL, bitwise))
        check(worst <= GRAPH_LOGIT_TOL, "%s: graph logits disagree with "
              "eager" % label)
        streams[label] = gt
    check(streams["spec_k=3 small"] == streams["target-only"],
          "spec_k=3 (graphs) tokens differ from target-only")
    log("  spec_k=3 small through the graphs = target-only (32 x 16 tokens)")
    return total


def decode_symbol_check(mx, params, cfg=TRAIN):
    """16(b): ``get_decode_symbol`` bound at (32, 1) with phase 5's trained
    parameters, stepped 128 positions through ``decode_step`` on the card
    and on the CPU, against the training symbol's full forward; then the
    overflow contract at position 128."""
    import importlib

    # the module (mx.models.transformer_lm is the symbol builder)
    tlm = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")

    T, V = cfg["seq_len"], cfg["vocab_size"]
    rng = np.random.RandomState(16)
    toks = rng.randint(0, V, (DECODE_BATCH, T)).astype(np.float32)
    train = tlm.get_symbol(**cfg)
    ex = train.simple_bind(ctx=mx.gpu(0), grad_req="null",
                           data=(DECODE_BATCH, T),
                           softmax_label=(DECODE_BATCH, T))
    for n, a in ex.arg_dict.items():
        if n in params:
            a[:] = params[n]
    ex.arg_dict["data"][:] = toks
    ex.forward(is_train=False)
    full = ex.outputs[0].asnumpy().reshape(DECODE_BATCH, T, V)
    del ex
    dec = tlm.get_decode_symbol(**cfg)
    exes = {}
    for dev, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        e = dec.simple_bind(ctx=ctx, grad_req="null", data=(DECODE_BATCH, 1))
        for n, a in e.arg_dict.items():
            if n in params:
                a[:] = params[n]
        exes[dev] = e
    worst_full = worst_cpu = 0.0
    t0 = time.perf_counter()
    for t in range(T):
        probs = {dev: tlm.decode_step(e, toks[:, t], t, T)
                 for dev, e in exes.items()}
        check(np.isfinite(probs["card"]).all(), "non-finite decode output")
        np.testing.assert_allclose(probs["card"], full[:, t], rtol=DECODE_RTOL,
                                   atol=DECODE_ATOL)
        worst_full = max(worst_full, float(np.abs(probs["card"]
                                                  - full[:, t]).max()))
        worst_cpu = max(worst_cpu, float(
            np.abs(probs["card"] - probs["cpu"]).max()
            / np.abs(probs["cpu"]).max()))
    log("  decode symbol at (%d, 1), %d positions through decode_step (%.2f s "
        "card + CPU): card against the training symbol's full forward max "
        "abs %.3e (rtol %.0e, atol %.0e); card against CPU %.3e of the "
        "largest (tol %.0e)" % (DECODE_BATCH, T, time.perf_counter() - t0,
                                worst_full, DECODE_RTOL, DECODE_ATOL,
                                worst_cpu, DECODE_CARD_TOL))
    check(worst_cpu <= DECODE_CARD_TOL, "decode symbol: card disagrees with "
          "the CPU")
    e = exes["card"]
    try:
        tlm.decode_step(e, toks[:, 0], T, T)
        check(False, "decode_step at position %d did not raise" % T)
    except ValueError as err:
        log("  decode_step at position %d raises: %s" % (T, err))
    before = {n: a.asnumpy().copy() for n, a in e.aux_dict.items()}
    e.arg_dict["position"][:] = np.array([T], np.float32)
    e.forward(is_train=True)
    out = e.outputs[0].asnumpy()
    same = all(np.array_equal(before[n], a.asnumpy())
               for n, a in e.aux_dict.items())
    log("  raw forward at position %d: output all NaN %s; %d caches bitwise "
        "unchanged %s" % (T, bool(np.isnan(out).all()), len(before), same))
    check(np.isnan(out).all() and same, "the overflow contract broke")


def paged_op_check(mx, A, build):
    """16(c): ``_contrib_PagedAttention`` from ``mx.sym`` at K3's serving
    shape (B 32, 257 blocks of 16, H 4, D 64), float32 tables and lengths
    as a bound graph takes them: equal to the plain reference within
    F32_TOL, one ``paged_decode`` launch per forward."""
    rng = np.random.RandomState(3)
    lens = rng.randint(1, 128, 32)
    q, kp, vp, bt, cl = paged_inputs(rng, 32, torch.float32, lens)
    names = ("query", "key_pages", "value_pages", "block_table",
             "context_len")
    net = mx.sym.contrib.PagedAttention(*[mx.sym.Variable(n) for n in names])
    args = {n: mx.nd.NDArray(t.float() if n in ("block_table", "context_len")
                             else t)
            for n, t in zip(names, (q, kp, vp, bt, cl))}
    ex = net.bind(mx.gpu(0), args, grad_req="null")
    want = A.paged_attention_reference(q, kp, vp, bt, cl)
    build.PAGED_DECODE.launches = 0
    errs = []
    for _ in range(3):
        ex.forward(is_train=False)
        errs.append(float((ex.outputs[0].data - want).abs().max()))
    torch.cuda.synchronize()
    launches = build.PAGED_DECODE.launches
    log("  _contrib_PagedAttention through mx.sym at %s: max abs err %.3e "
        "(tol %.0e) against paged_attention_reference; %d paged_decode "
        "launches in 3 forwards" % (tuple(q.shape), max(errs), F32_TOL,
                                   launches))
    check(max(errs) <= F32_TOL, "_contrib_PagedAttention disagrees")
    check(launches == 3, "_contrib_PagedAttention launched paged_decode %d "
          "times in 3 forwards" % launches)


def _steady_engine(S, params, over, n_new=72):
    cfg = S.ServingConfig(**dict(SERVE, prefills_per_step=DECODE_BATCH,
                                 prefix_cache=False, **over))
    eng = S.ServingEngine(cfg, arg_params=params, device="cuda")
    return eng, cfg, n_new


def time_steps(S, params, over, eager):
    """Host wall per engine step at batch 32 once every request decodes
    (median of TIMED_STEPS synchronized steps), then one profiler window of
    3 steps: (wall ms, busy ms, device ops per step)."""
    eng, cfg, n_new = _steady_engine(S, params, over)
    if eager:
        make_eager(eng)
    eng.warmup()
    rng = np.random.RandomState(5)
    for n in rng.randint(1, 49, DECODE_BATCH):
        eng.submit([int(t) for t in rng.randint(0, cfg.vocab_size, n)], n_new)
    eng.step()                                 # every prefill + one step
    check(not eng.scheduler.waiting, "not every request was admitted")
    walls = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(len(eng.scheduler.running) == DECODE_BATCH,
          "a stream finished inside the timed window")
    prof = device_profile(eng.step)
    wall_ms = float(np.median(walls)) * 1e3
    return wall_ms, prof


def time_prefills(S, params, eager):
    """Host wall of one prefill call per length bucket (the graph call and
    the token read, as the engine makes them; median of 20), and the
    device busy time of one."""
    eng, cfg, _ = _steady_engine(S, params, {})
    if eager:
        make_eager(eng)
    eng.warmup()
    out = {}
    for S_, g in eng._prefill_graphs.items():
        args = (np.zeros((1, S_), np.int32), np.array([S_], np.int32),
                np.zeros(S_ // cfg.block_size, np.int32))

        def call():
            int(g(*args)[0].cpu()[0])
        walls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        out[S_] = (float(np.median(walls)) * 1e3, device_profile(call))
    return out


def graph_recovery(S, params, card):
    """16(d): graphs against eager — decode step and speculative steps at
    batch 32, prefill per length bucket — with device busy and idle share.
    Returns the numbers for the log's summary."""
    rows = []
    for label, over in (("decode step", dict(spec_k=0)),
                        ("speculative step, spec_k=3 small",
                         dict(spec_k=3, draft="small")),
                        ("speculative step, spec_k=3 self",
                         dict(spec_k=3, draft="self"))):
        for mode in ("graphs", "eager"):
            wall, prof = time_steps(S, params, over, mode == "eager")
            if prof is None:
                log("  [%s] %s at batch %d, %s: host wall %.4f ms per step; "
                    "device busy not measured (the profiler saw no device "
                    "operation)" % (card, label, DECODE_BATCH, mode, wall))
                continue
            log("  [%s] %s at batch %d, %s: host wall %.4f ms per step; "
                "device busy %.4f ms (idle share %.3f), %.1f device "
                "operations per step; by class %s"
                % (card, label, DECODE_BATCH, mode, wall, prof[0],
                   max(0.0, 1 - prof[0] / wall), prof[1],
                   ", ".join("%s %.3f" % kv for kv in sorted(
                       prof[3].items(), key=lambda kv: -kv[1]))))
            rows.append((label, mode, wall, prof[0]))
    for mode in ("graphs", "eager"):
        for S_, (wall, prof) in time_prefills(S, params,
                                              mode == "eager").items():
            busy = "not measured" if prof is None else "%.4f ms (idle share " \
                "%.3f), %.1f device operations" % (
                    prof[0], max(0.0, 1 - prof[0] / wall), prof[1])
            log("  [%s] prefill at length bucket %d, %s: host wall %.4f ms "
                "per call; device busy %s" % (card, S_, mode, wall, busy))



# ------------------------------- the image-classification zoo (phase 17)
# AlexNet at examples/train_imagenet.py's defaults, through the port's
# tools/train_imagenet.py: ALEXNET_POOL distinct seeded batches walked once
# per epoch (5 epochs fused: 30 steps; 2 classic: 12), the
# MultiFactorScheduler's first boundary at update ALEXNET_BOUNDARY
ALEXNET_BATCH = 128
ALEXNET_SHAPE = (3, 224, 224)
ALEXNET_CLASSES = 1000
ALEXNET_POOL = 6
ALEXNET_EPOCHS = {True: 5, False: 2}
ALEXNET_BOUNDARY = 10
# the card-vs-CPU step at batch ALEXNET_CPU_BATCH. AlexNet's ReLU inputs
# near zero are so many that at about a third to a half of the points the
# CPU passes as smooth (phase 6's +-1e-7 test) the card's rounding, about
# sqrt(fan-in) times larger than that test's move, still crosses one and
# moves a conv weight's gradient by 1e-3 to 3e-2 of its largest (runs on
# one H100); a +-1e-5 test finds a kink at every point. So the card is
# held at successive smooth points until one agrees: a fault of the port
# disagrees at all of them, a crossed kink at some; each crossing is logged
ALEXNET_CPU_BATCH = 8
ZOO_BATCH = 32
ZOO_CPU_BATCH = 2
# one forward, card vs CPU: max |p_card - p_cpu| / max |p_cpu|
ZOO_OUT_TOL = 1e-4
# (tool --network, image shape, classes, more flags) of 17(c), at lr
# ZOO_LR: at the example's 0.1 vgg-16 and googlenet diverge within two
# steps on the tool's data (on one H100)
ZOO_LR = 0.01
ZOO = (("vgg", "3,224,224", 1000, ["--num-layers", "16"]),
       ("inception-bn", "3,224,224", 1000, []),
       ("googlenet", "3,224,224", 1000, []),
       ("inception-v3", "3,299,299", 1000, []),
       ("inception-resnet-v2", "3,299,299", 1000, []),
       ("resnext", "3,224,224", 1000, ["--num-layers", "50"]),
       ("lenet", "1,28,28", 10, []),
       ("mlp", "1,28,28", 10, []))
# 17(d): the LSTM LM with dropout between its layers, one bucket
RNN_DROPOUT = 0.2
RNN_BUCKET = 20


class MaskTap:
    """Every mask ``ops.sample.dropout_mask`` returns while the body runs,
    in call order. A mask drawn while a CUDA graph was captured is that
    graph's own tensor: after each replay it holds the replay's mask."""

    def __init__(self):
        from mxnet_tpu_torch.ops import sample

        self._sample = sample
        self.calls = []

    def __enter__(self):
        orig = self._orig = self._sample.dropout_mask

        def tap(*args, **kwargs):
            mask = orig(*args, **kwargs)
            self.calls.append(mask)
            return mask

        self._sample.dropout_mask = tap
        return self

    def __exit__(self, *exc):
        self._sample.dropout_mask = self._orig
        return False


class installed_masks:
    """``ops.sample.dropout_mask`` returns the given masks (on the asked
    device) in turn, cyclically, instead of drawing."""

    def __init__(self, masks):
        from mxnet_tpu_torch.ops import sample

        self._sample = sample
        self._masks = masks
        self._i = 0

    def __enter__(self):
        self._orig = self._sample.dropout_mask

        def give(rng, shape, keep, dtype, device):
            m = self._masks[self._i % len(self._masks)]
            self._i += 1
            check(tuple(m.shape) == tuple(shape), "installed mask %s for %s"
                  % (tuple(m.shape), tuple(shape)))
            return m.to(device, dtype)

        self._sample.dropout_mask = give
        return self

    def __exit__(self, *exc):
        self._sample.dropout_mask = self._orig
        return False


def zoo_args(network, batch, shape, classes, batches, epochs, extra=()):
    """tools/train_imagenet.py's arguments for ``batches`` distinct batches
    walked ``epochs`` times, kvstore 'device', on the card."""
    from mxnet_tpu_torch.tools import train_imagenet

    return train_imagenet.parse_args(
        ["--network", network, "--batch-size", str(batch), "--image-shape",
         shape, "--num-classes", str(classes), "--num-examples",
         str(batch * batches), "--num-epochs", str(epochs), "--kv-store",
         "device", "--disp-batches", "1000"] + list(extra))


def alexnet_args(fused, epochs=None):
    # int(1.75 * 6) = 10: the boundary as a fraction of a 6-batch epoch
    return zoo_args("alexnet", ALEXNET_BATCH,
                    ",".join(map(str, ALEXNET_SHAPE)), ALEXNET_CLASSES,
                    ALEXNET_POOL,
                    ALEXNET_EPOCHS[fused] if epochs is None else epochs,
                    ["--lr-step-epochs",
                     "%.6f" % ((ALEXNET_BOUNDARY + 0.5) / ALEXNET_POOL)])


def batch_stats(mod, batch):
    """(top-1 hits, top-5 hits, summed cross-entropy) of the step's
    probabilities, on the card (read at the end of the run)."""
    p = mod.get_outputs()[0].data.float()
    lab = batch.label[0].data.long()
    top = p.topk(5, dim=1).indices
    nll = -p.gather(1, lab[:, None]).clamp_min(1e-30).log().sum()
    return torch.stack([(top[:, 0] == lab).sum().float(),
                        (top == lab[:, None]).any(dim=1).sum().float(), nll])


def run_alexnet(mx, build, fused=True, epochs=None, keep_masks=(1, 2, 3)):
    """AlexNet through tools/train_imagenet.fit on the card, fused (one
    CUDA graph, replayed) or classic. Records each step's top-1/top-5
    hits, the lr the fused step wrote (host value and device scalar) or
    the lrs the classic Updater used, and the dropout masks of the
    replays in ``keep_masks``."""
    from mxnet_tpu_torch.tools import train_imagenet

    args = alexnet_args(fused, epochs)
    steps = ALEXNET_POOL * args.num_epochs
    rec = {"hits": [], "lr": [], "dev_lr": [], "classic_lr": [], "masks": {}}
    used = []
    sgd = mx.optimizer.SGD
    get_lr = sgd._get_lr

    def recording_get_lr(self, index):
        lr = get_lr(self, index)
        used.append((self.num_update, lr))
        return lr

    def batch_end(param):
        mod, batch = param.locals["self"], param.locals["data_batch"]
        k = len(rec["hits"])
        rec["hits"].append(batch_stats(mod, batch))
        if mod._fused is not None:
            tr = mod._fused.trainer
            rec["lr"].append(tr.step_lr)
            rec["dev_lr"].append(tr._lr.clone())
            if k == 0:
                rec["per_step"] = len(tap.calls)
            n = rec["per_step"]
            if k == 1:
                # the captured step's own mask tensors, rewritten by each
                # replay
                rec["graph_masks"] = tap.calls[n:2 * n]
            if k in keep_masks:
                rec["masks"][k] = [m.clone() for m in tap.calls[n:2 * n]]
        else:
            rec["classic_lr"].append(list(used))
        used.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in build.KERNELS.values():
        k.launches = 0
    sgd._get_lr = recording_get_lr
    try:
        with MaskTap() as tap, (contextlib.nullcontext() if fused
                                else no_fused()):
            mod, record = train_imagenet.fit(args, batch_end_callback=[batch_end],
                                             eval_data=False)
    finally:
        sgd._get_lr = get_lr
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
    check(record["steps"] == steps, "fit ran %d steps" % record["steps"])
    check(not launches, "a port kernel ran on AlexNet's path: %s" % launches)
    hits = torch.stack(rec["hits"]).cpu().numpy() / ALEXNET_BATCH
    path = "fused" if fused else "classic"
    if fused:
        tr = mod._fused.trainer if mod._fused is not None else None
        check(tr is not None and tr.captures == 1 and tr.replays == steps - 1,
              "AlexNet's fit did not run one captured graph")
        rec["dev_lr"] = [float(t) for t in torch.stack(rec["dev_lr"]).cpu()]
    else:
        check(mod._fused is None, "MXNET_MODULE_NO_FUSED=1 still fused")
    log("  [%s] %d steps of batch %d: first step %.4f s; host wall per step "
        "(median after 2, synchronized) %.5f s = %.1f images/s; peak memory "
        "%.3f GB; %s"
        % (path, steps, ALEXNET_BATCH, record["first_step_s"],
           record["step_s"], record["images_per_sec"], peak / 1e9,
           record["device"]["nvidia_smi"]))
    return mod, record, rec, hits, peak


def alexnet_lr_checks(mx, fused_rec, classic_rec):
    """17(b): the lr written before every fused step (host value and the
    device scalar) is the schedule's at that step's update count; the
    classic Updater's lrs at the same count are the same, and a classic
    step differs from the fused one only on the boundary step (its first
    parameter at count k, the rest at k + 1: the documented skew)."""
    ref = mx.lr_scheduler.MultiFactorScheduler(step=[ALEXNET_BOUNDARY],
                                               factor=0.1)
    ref.base_lr = 0.1
    want = [np.float32(ref(k)) for k in range(len(fused_rec["lr"]) + 1)]
    for k, (lr, dev) in enumerate(zip(fused_rec["lr"], fused_rec["dev_lr"])):
        check(np.float32(lr) == want[k] and np.float32(dev) == want[k],
              "fused step %d wrote lr %r (device %r), the schedule says %r"
              % (k, lr, dev, want[k]))
    skew = []
    for k, used in enumerate(classic_rec["classic_lr"]):
        for count, lr in used:
            check(np.float32(lr) == want[count],
                  "classic step %d used lr %r at count %d, the fused step "
                  "wrote %r there" % (k, lr, count, want[count]))
        if {np.float32(lr) for _, lr in used} != {want[k]}:
            skew.append(k)
    log("  lr written before each of %d fused steps = the schedule's at the "
        "step's update count (host and device scalar): %s; the classic "
        "Updater's lrs at the same counts equal them; classic steps whose "
        "parameters got another lr than the fused step's: %s (the boundary "
        "step %d, documented)"
        % (len(fused_rec["lr"]), sorted({float(v) for v in want}), skew,
           ALEXNET_BOUNDARY))
    check(skew == [ALEXNET_BOUNDARY], "classic/fused lr skew at steps %s, "
          "expected only the boundary step %d" % (skew, ALEXNET_BOUNDARY))


def alexnet_mask_checks(mx, build, mod, rec):
    """17(b): two consecutive replays drew different masks; a second run
    from the same seed replays the same masks bitwise; a replay's masks
    equal an eager step's from the same generator state, bitwise."""
    m1, m2 = rec["masks"][1], rec["masks"][2]
    check(len(m1) == 2, "AlexNet drew %d masks a step, not 2" % len(m1))
    differ = [not torch.equal(a, b) for a, b in zip(m1, m2)]
    kept = [float((m > 0).float().mean()) for m in m1]
    log("  replays 1 and 2 drew different masks: %s (kept shares %s, p 0.5)"
        % (differ, ["%.4f" % s for s in kept]))
    check(all(differ), "two replays drew the same dropout mask")
    check(all(abs(s - 0.5) < 0.01 for s in kept), "kept share off 0.5")
    _, _, again, _, _ = run_alexnet(mx, build, True, epochs=1)
    same = [all(torch.equal(a, b) for a, b in zip(rec["masks"][k],
                                                 again["masks"][k]))
            for k in (1, 2, 3)]
    log("  a second fused run from mx.random.seed(0): replays 1-3 drew the "
        "same masks bitwise: %s" % same)
    check(all(same), "the same seed and steps did not reproduce the masks")
    fused, tr = mod._fused, mod._fused.trainer
    st = fused.state
    gen = mx.random.generator(tr.device)
    tensors = (list(st.params.values()) + list(st.auxs.values())
               + [t for slots in st.states.values() for t in slots])
    batch = mx.io.DataBatch(
        [mx.nd.NDArray(torch.randn((ALEXNET_BATCH,) + ALEXNET_SHAPE,
                                   device=tr.device))],
        [mx.nd.NDArray(torch.zeros(ALEXNET_BATCH, device=tr.device))], pad=0)
    n = len(rec["graph_masks"])
    with MaskTap() as tap:
        replays = tr.replays
        mod.forward(batch, is_train=True)    # stages the batch
        saved = [t.clone() for t in tensors]
        state = gen.get_state()
        mod.update()                         # one replay
        check(tr.replays == replays + 1 and not tap.calls,
              "the step did not replay its graph")
        graph_masks = [m.clone() for m in rec["graph_masks"]]
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        gen.set_state(state)
        tr._run(st.params, st.auxs, st.states, tr.input_buffers())
        eager_masks = tap.calls[:n]
    equal = [torch.equal(a, b) for a, b in zip(graph_masks, eager_masks)]
    log("  a replay's masks against an eager step's from the same generator "
        "state: bitwise equal %s" % equal)
    check(len(eager_masks) == n and all(equal),
          "a replay's masks differ from the eager step's")


def alexnet_step_card_vs_cpu(mx, params):
    """17(b): one ``forward_backward`` of AlexNet at batch
    ALEXNET_CPU_BATCH on the card and on the CPU, both with the masks the
    card drew installed; gradients within GRAD_TOL of each parameter's
    largest CPU value, at a point where the CPU's gradient is smooth
    (phase 6's rule, KINK_TOL), picked on the CPU before the card runs;
    where the card still lands across a kink there (ALEXNET_CPU_BATCH's
    comment), at the next such point, up to KINK_TRIES."""
    sym = mx.models.alexnet(num_classes=ALEXNET_CLASSES)
    rng = np.random.RandomState(7)
    X = rng.randn(ALEXNET_CPU_BATCH, *ALEXNET_SHAPE).astype(np.float32)
    Y = rng.randint(0, ALEXNET_CLASSES, (ALEXNET_CPU_BATCH,)).astype(
        np.float32)

    def step(ctx, point):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("softmax_label", Y.shape)])
        mod.init_params(arg_params=point)
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(X, ctx=ctx)],
                                             [mx.nd.array(Y, ctx=ctx)]))
        exe = mod._exec_group.execs[0]
        return (mod.get_outputs()[0].asnumpy(),
                {n: exe.grad_dict[n].asnumpy() for n in params})

    with MaskTap() as tap:
        step(mx.gpu(0), params)
    masks = [m.clone() for m in tap.calls]
    check(len(masks) == 2, "AlexNet drew %d masks, not 2" % len(masks))

    crossed = []
    with installed_masks(masks):
        k = 0
        while True:
            point, k, move, kink, out_h, g_h = smooth_point(mx, step, params,
                                                            first=k)
            out_c, g_c = step(mx.gpu(0), point)
            grel = rel(g_c, g_h)
            worst = max(grel, key=grel.get)
            if grel[worst] <= GRAD_TOL or k == KINK_TRIES:
                break
            diff = np.abs(g_c[worst] - g_h[worst])
            over = int((diff > GRAD_TOL * np.abs(g_h[worst]).max()).sum())
            crossed.append(k)
            log("  %s, smooth on the CPU: the card's gradient of %s is %.3e of "
                "its largest away (%d of %d elements past GRAD_TOL): the card "
                "crossed a kink there; the next seeded point"
                % ("the trained parameters" if k == 0 else "seeded point %d" % k,
                   worst, grel[worst], over, diff.size))
            k += 1
    check(np.isfinite(out_c).all() and out_c.shape == out_h.shape,
          "card outputs not finite or misshapen")
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    grel = rel(g_c, g_h)
    worst = max(grel, key=grel.get)
    log("  one AlexNet step at batch %d with the card's masks on both sides, "
        "%s (CPU gradient's largest move under a +-%.0e parameter move %.3e, "
        "%s; points where the card crossed a kink: %s): outputs max abs diff "
        "/ max %.3e (tol %.0e); worst gradient %s: max abs diff / max abs "
        "grad %.3e (tol %.0e over %d parameters)"
        % (ALEXNET_CPU_BATCH, "at the trained parameters" if k == 0 else
           "at seeded point %d within %.0e of the trained parameters"
           % (k, KINK_STEP), PERTURBATION, move, kink, crossed, out_err,
           OUT_REL_TOL, worst, grel[worst], GRAD_TOL, len(grel)))
    check(out_err <= OUT_REL_TOL, "AlexNet outputs: card disagrees with CPU")
    check(all(np.isfinite(g_c[n]).all() for n in params), "non-finite gradient")
    check(grel[worst] <= GRAD_TOL, "AlexNet gradients: card disagrees with CPU")


def time_lrn_dropout():
    """Device ms of AlexNet's two LRNs and its two dropouts, forward and
    backward, at batch ALEXNET_BATCH: CUDA events, as phase 11 times."""
    from mxnet_tpu_torch import random as mxr
    from mxnet_tpu_torch.ops.registry import OpContext, get_op

    out = {}
    gen = mxr.generator("cuda")
    for name, shape, attrs in (
            ("LRN conv1", (ALEXNET_BATCH, 96, 54, 54),
             dict(alpha=1e-4, beta=0.75, knorm=2.0, nsize=5)),
            ("LRN conv2", (ALEXNET_BATCH, 256, 26, 26),
             dict(alpha=1e-4, beta=0.75, knorm=2.0, nsize=5)),
            ("Dropout fc", (ALEXNET_BATCH, 4096), dict(p=0.5,
                                                      mode="training"))):
        op = get_op(name.split()[0])
        at, _ = op.canonicalize_attrs(attrs)
        x = torch.randn(shape, device="cuda", requires_grad=True)
        g = torch.randn(shape, device="cuda")
        octx = OpContext(is_train=True, rng=gen, device=x.device)

        def fwd_bwd():
            y = op.forward(octx, at, [x], [])[0][0]
            torch.autograd.grad(y, x, g)

        out[name] = device_ms(fwd_bwd, n=20)
    return out


def run_zoo(mx, build):
    """17(c): each network of ZOO at full width, batch ZOO_BATCH: two fused
    steps through tools/train_imagenet.fit (eager, then captured and
    replayed), a finite loss; one inference forward at batch
    ZOO_CPU_BATCH, card vs CPU, from the trained parameters."""
    import gc

    from mxnet_tpu_torch.tools import train_imagenet

    for net, shape, classes, extra in ZOO:
        args = zoo_args(net, ZOO_BATCH, shape, classes, 2, 1,
                        ["--lr", str(ZOO_LR)] + extra)
        loss = []

        def batch_end(param):
            mod, batch = param.locals["self"], param.locals["data_batch"]
            p = mod.get_outputs()[0].data.float()
            lab = batch.label[0].data.long()
            loss.append(-p.gather(1, lab[:, None]).clamp_min(1e-30).log()
                        .mean())

        for k in build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        mod, record = train_imagenet.fit(args, batch_end_callback=[batch_end],
                                         eval_data=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss = [float(v) for v in loss]
        tr = mod._fused.trainer if mod._fused is not None else None
        check(tr is not None and tr.captures == 1 and tr.replays == 1,
              "%s: the two steps did not run one captured graph" % net)
        check(not any(k.launches for k in build.KERNELS.values()),
              "a port kernel ran on %s's path" % net)
        check(len(loss) == 2 and all(math.isfinite(v) for v in loss),
              "%s: non-finite loss %s" % (net, loss))
        arg_params, aux_params = ({n: a.asnumpy() for n, a in d.items()}
                                  for d in mod.get_params())
        dshape = (ZOO_CPU_BATCH,) + tuple(int(x) for x in shape.split(","))
        X = np.random.RandomState(8).randn(*dshape).astype(np.float32)
        outs = {}
        for ctx in (mx.gpu(0), mx.cpu()):
            m = mx.mod.Module(mod.symbol, context=ctx)
            m.bind(data_shapes=[("data", dshape)],
                   label_shapes=[("softmax_label", (ZOO_CPU_BATCH,))],
                   for_training=False)
            m.set_params(arg_params, aux_params)
            m.forward(mx.io.DataBatch([mx.nd.array(X, ctx=ctx)], None),
                      is_train=False)
            outs[ctx.type] = m.get_outputs()[0].asnumpy()
        err = float(np.abs(outs["cuda"] - outs["cpu"]).max()
                    / np.abs(outs["cpu"]).max())
        log("  %s %s at batch %d: 2 fused steps (1 capture, 1 replay) in "
            "%.2f s with the set-up, loss %s; forward at batch %d card vs "
            "CPU: max abs diff / max %.3e (tol %.0e)"
            % (net, shape, ZOO_BATCH, wall, ["%.4f" % v for v in loss],
               ZOO_CPU_BATCH, err, ZOO_OUT_TOL))
        check(np.isfinite(outs["cuda"]).all(), "%s: card outputs not finite"
              % net)
        check(err <= ZOO_OUT_TOL, "%s: card forward disagrees with the CPU"
              % net)
        del mod, m, tr
        gc.collect()
        torch.cuda.empty_cache()


def run_rnn_dropout(mx, rnn_op):
    """17(d): the LSTM LM with dropout RNN_DROPOUT between its two layers
    (the RNN op's, or DropoutCell's nodes) through BucketingModule.fit on
    the card, three steps of one bucket: eager, captured and replayed,
    replayed. The two replays' masks must differ."""
    V = LSTM["vocab_size"]
    rng = np.random.RandomState(3)
    sents = [list(2 + (s + np.arange(RNN_BUCKET)) % (V - 2))
             for s in rng.randint(0, V, 3 * LSTM_BATCH)]
    np.random.seed(3)   # BucketSentenceIter shuffles with numpy's RNG
    it = mx.rnn.BucketSentenceIter(sents, LSTM_BATCH, buckets=[RNN_BUCKET],
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(
        mx.models.lstm_lm(fused=rnn_op, dropout=RNN_DROPOUT, **LSTM),
        default_bucket_key=RNN_BUCKET, context=mx.gpu(0))
    masks = {}
    metric = mx.metric.Perplexity(ignore_label=0)

    def batch_end(param):
        k = param.nbatch
        if k == 0:
            masks["n"] = len(tap.calls)
        else:
            n = masks["n"]
            masks[k] = [m.clone() for m in tap.calls[n:2 * n]]

    with MaskTap() as tap:
        mod.fit(it, num_epoch=1, kvstore="local", optimizer="sgd",
                optimizer_params=LSTM_SGD,
                initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)),
                eval_metric=metric, batch_end_callback=batch_end)
    torch.cuda.synchronize()
    tr = mod._buckets[RNN_BUCKET]._fused.trainer
    n = masks["n"]
    differ = sum(not torch.equal(a, b) for a, b in zip(masks[1], masks[2]))
    kept = float(torch.stack([(m > 0).float().mean() for m in masks[1]]).mean())
    ppl = metric.get()[1]
    log("  [%s] 3 steps of bucket %d: captures %d, replays %d; %d dropout "
        "mask(s) a step, %d of them differ between replays 1 and 2; kept "
        "share %.4f (p %.1f); perplexity %.3f"
        % ("RNN op" if rnn_op else "DropoutCell", RNN_BUCKET, tr.captures,
           tr.replays, n, differ, kept, RNN_DROPOUT, ppl))
    check(tr.captures == 1 and tr.replays == 2, "the bucket did not replay")
    check(n >= 1 and differ == n, "the two replays drew the same masks")
    check(abs(kept - (1 - RNN_DROPOUT)) < 0.02, "kept share off")
    check(math.isfinite(ppl), "non-finite perplexity")


def run_image_zoo(mx, build, card):
    """Phase 17."""
    log("  (a) AlexNet at examples/train_imagenet.py's defaults (%s)" % card)
    mod, f_record, f_rec, f_hits, _ = run_alexnet(mx, build, True)
    c_mod, c_record, c_rec, _, _ = run_alexnet(mx, build, False)
    first, last = f_hits[:ALEXNET_POOL].mean(0), f_hits[-ALEXNET_POOL:].mean(0)
    log("  [fused] batch top-1 / top-5 accuracy / cross-entropy over the "
        "first epoch %.4f / %.4f / %.4f, over the last %.4f / %.4f / %.4f; "
        "the fit's final train metrics %s"
        % (first[0], first[1], first[2], last[0], last[1], last[2],
           f_record["train"]))
    # top-1 of a 1000-way head after 30 steps is a few hits of 768 (runs
    # on one H100: 1-5 in the first epoch and in the last): logged,
    # not held; top-5 and the loss move well past that noise
    check(np.isfinite(f_hits).all(), "non-finite loss")
    check(last[1] > first[1] and last[2] < first[2],
          "top-5 accuracy did not rise, or the loss did not fall, within the "
          "run")
    log("  host wall per step: fused graph %.5f s (%.1f images/s), classic "
        "%.5f s (%.1f images/s), %.2fx"
        % (f_record["step_s"], f_record["images_per_sec"], c_record["step_s"],
           c_record["images_per_sec"], c_record["step_s"] / f_record["step_s"]))
    batch = mx.io.DataBatch(
        [mx.nd.NDArray(torch.randn((ALEXNET_BATCH,) + ALEXNET_SHAPE,
                                   device="cuda"))],
        [mx.nd.NDArray(torch.randint(0, ALEXNET_CLASSES, (ALEXNET_BATCH,),
                                     device="cuda").float())], pad=0)

    for path, m, record in (("fused", mod, f_record),
                            ("classic", c_mod, c_record)):
        def step(m=m):
            m.forward(batch, is_train=True)
            m.backward()
            m.update()

        log_profile("AlexNet " + path, device_profile(step), record["step_s"])
    del c_mod
    for name, ms in time_lrn_dropout().items():
        log("  %s forward + backward at batch %d: %.4f device ms"
            % (name, ALEXNET_BATCH, ms))
    log("  (b) checks")
    alexnet_lr_checks(mx, f_rec, c_rec)
    alexnet_mask_checks(mx, build, mod, f_rec)
    params = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    alexnet_step_card_vs_cpu(mx, params)
    log("  (c) the rest of the zoo at full width")
    run_zoo(mx, build)
    log("  (d) the LSTM LM with dropout %.1f between its layers"
        % RNN_DROPOUT)
    run_rnn_dropout(mx, rnn_op=True)
    run_rnn_dropout(mx, rnn_op=False)


# --------------------------------------- DCGAN and the op sweep (phase 18)
# MXNet's example/gan/dcgan.py widths (the zoo model's defaults): 64x64
# images, 3 channels, batch 64, z 100
DCGAN = dict(ngf=64, nc=3)
DCGAN_BATCH = 64
DCGAN_Z = 100
DCGAN_STEPS = 45
DCGAN_LR = 2e-4
DCGAN_CPU_BATCH = 8
# the op sweep, card vs CPU: relative to the largest CPU value of each
# output and gradient for smooth float32 ops; exact for the rest
SWEEP_TOL = 1e-5


def run_dcgan(mx, build, card):
    """18(a): DCGAN at the reference widths through tools/dcgan.train:
    DCGAN_STEPS steps of the example's loop; every loss finite; host wall
    per step, images/s, peak memory, losses by third, then one
    torch.profiler window of three steps. Returns the generator and
    discriminator modules."""
    from mxnet_tpu_torch.tools import dcgan

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen, dis, feed, rec = dcgan.train(DCGAN_BATCH, DCGAN_Z, DCGAN_LR,
                                      DCGAN_STEPS, torch.device("cuda", 0),
                                      **DCGAN)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launched = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    log("  DCGAN ngf=ndf=%d nc %d batch %d z %d, %d steps (%s): host wall per "
        "step %.5f s (median after 2; first %.3f s), %.1f images/s, peak "
        "memory %.3f GiB over what earlier phases hold; D loss first/last third %.4f / %.4f, G loss %.4f / "
        "%.4f; port kernels launched: %s"
        % (DCGAN["ngf"], DCGAN["nc"], DCGAN_BATCH, DCGAN_Z, rec["steps"], card,
           rec["step_s"], rec["first_step_s"], rec["images_per_sec"], peak,
           rec["d_loss"]["first_third"], rec["d_loss"]["last_third"],
           rec["g_loss"]["first_third"], rec["g_loss"]["last_third"],
           launched or "none"))
    check(rec["finite"], "DCGAN: a non-finite loss")
    check(not launched, "a port kernel ran on DCGAN's path")

    def step():
        dcgan.gan_step(gen, dis, feed.noise(), feed.real[0], feed.ones,
                       feed.zeros)

    log_profile("DCGAN GAN step", device_profile(step), rec["step_s"])
    return gen, dis


def dcgan_step_card_vs_cpu(mx, gen, dis):
    """18(b): one GAN step's gradients at batch DCGAN_CPU_BATCH, card vs
    CPU, from the same parameters (the trained ones) and inputs: D's
    parameter gradients summed over its fake and real passes, and G's
    parameter and input gradients from D's input gradient on the fake
    batch with label 1 (the loop's calls, without the updates), within
    GRAD_TOL of each one's largest CPU value, at a point the CPU finds
    smooth (phase 6's rule); where the card still lands across a kink of
    LeakyReLU or ReLU there, the next such point (17(b)'s rule)."""
    from mxnet_tpu_torch.tools import dcgan

    b = DCGAN_CPU_BATCH
    rng = np.random.RandomState(11)
    z = rng.randn(b, DCGAN_Z, 1, 1).astype(np.float32)
    real = (rng.rand(b, DCGAN["nc"], 64, 64) * 2 - 1).astype(np.float32)
    g_args, g_auxs = ({n: a.asnumpy() for n, a in d.items()} for d in gen.get_params())
    d_args, d_auxs = ({n: a.asnumpy() for n, a in d.items()} for d in dis.get_params())
    params = {"G:" + n: v for n, v in g_args.items()}
    params.update({"D:" + n: v for n, v in d_args.items()})

    def step(ctx, point):
        g, d = dcgan.make_modules(b, DCGAN_Z, DCGAN_LR, ctx, **DCGAN)
        g.set_params({n[2:]: v for n, v in point.items() if n[0] == "G"}, g_auxs)
        d.set_params({n[2:]: v for n, v in point.items() if n[0] == "D"}, d_auxs)
        ones = mx.nd.ones((b,), ctx=ctx)
        zeros = mx.nd.zeros((b,), ctx=ctx)
        g.forward(mx.io.DataBatch([mx.nd.array(z, ctx=ctx)], None), is_train=True)
        fake = g.get_outputs()[0]
        d.forward(mx.io.DataBatch([fake], [zeros]), is_train=True)
        d.backward()
        dex = d._exec_group.execs[0]
        grads = {"D:" + n: dex.grad_dict[n].asnumpy() for n in d_args}
        d.forward(mx.io.DataBatch([mx.nd.array(real, ctx=ctx)], [ones]),
                  is_train=True)
        d.backward()
        for n in d_args:
            grads["D:" + n] += dex.grad_dict[n].asnumpy()
        d.forward(mx.io.DataBatch([fake], [ones]), is_train=True)
        out = d.get_outputs()[0].asnumpy()
        d.backward()
        g.backward([d.get_input_grads()[0]])
        gex = g._exec_group.execs[0]
        grads.update({"G:" + n: gex.grad_dict[n].asnumpy() for n in g_args})
        grads["G:rand (input)"] = g.get_input_grads()[0].asnumpy()
        return out, grads

    crossed = []
    k = 0
    while True:
        point, k, move, kink, out_h, g_h = smooth_point(mx, step, params, first=k)
        out_c, g_c = step(mx.gpu(0), point)
        grel = rel(g_c, g_h)
        worst = max(grel, key=grel.get)
        if grel[worst] <= GRAD_TOL or k == KINK_TRIES:
            break
        crossed.append(k)
        log("  %s, smooth on the CPU: the card's gradient of %s is %.3e of its "
            "largest away: the card crossed a kink there; the next seeded point"
            % ("the trained parameters" if k == 0 else "seeded point %d" % k,
               worst, grel[worst]))
        k += 1
    out_err = float(np.abs(out_c - out_h).max() / np.abs(out_h).max())
    log("  one GAN step at batch %d, card vs CPU, %s (CPU gradient's largest "
        "move under a +-%.0e parameter move %.3e, %s; points where the card "
        "crossed a kink: %s): D(fake) max abs diff / max %.3e; worst gradient "
        "%s: max abs diff / max abs grad %.3e (tol %.0e over %d gradients)"
        % (b, "at the trained parameters" if k == 0 else
           "at seeded point %d within %.0e of the trained parameters"
           % (k, KINK_STEP), PERTURBATION, move, kink, crossed, out_err,
           worst, grel[worst], GRAD_TOL, len(grel)))
    check(all(np.isfinite(v).all() for v in g_c.values()), "non-finite gradient")
    check(grel[worst] <= GRAD_TOL, "DCGAN gradients: card disagrees with CPU")


def op_sweep(mx):
    """18(c): every registered op name (and the sweep's variants) forward
    and backward on the card against the port's own CPU result, at the
    CPU tests' shapes and seeds (mxnet_tpu_torch.test_utils): every
    output, gradient and aux array on cuda:0; smooth float32 ops within
    SWEEP_TOL of the largest CPU value, the rest exactly; the samplers by
    shape, dtype and finiteness."""
    from mxnet_tpu_torch.ops.registry import list_ops
    from mxnet_tpu_torch.test_utils import op_cases, run_case

    cases = op_cases(list_ops())
    worst, failures, kinds, errors = (None, -1.0), [], {}, {}
    for cid in sorted(cases):
        case = cases[cid]
        kinds[case.kind] = kinds.get(case.kind, 0) + 1
        devices = []
        try:
            c_out, c_grad, c_aux = run_case(mx, case, mx.gpu(0), devices)
            h_out, h_grad, h_aux = run_case(mx, case, mx.cpu())
        except Exception as e:  # noqa: BLE001 - every failure is listed
            failures.append("%s: %s" % (cid, e))
            continue
        if any(d != "cuda:0" for d in devices):
            failures.append("%s: arrays on %s" % (cid, sorted(set(devices))))
        pairs = (list(zip(c_out, h_out)) + [(c_grad[n], h_grad[n]) for n in h_grad]
                 + list(zip(c_aux, h_aux)))
        for a, h in pairs:
            if a.shape != h.shape or a.dtype != h.dtype:
                failures.append("%s: %s %s against %s %s"
                                % (cid, a.shape, a.dtype, h.shape, h.dtype))
            elif case.kind == "random":
                if not np.isfinite(a).all():
                    failures.append("%s: non-finite draw" % cid)
            elif case.kind == "exact":
                if not np.array_equal(a, h, equal_nan=True):
                    failures.append("%s: not bitwise equal" % cid)
            else:
                a64, h64 = a.astype(np.float64), h.astype(np.float64)
                err = float(np.nanmax(np.abs(a64 - h64)) / max(np.nanmax(np.abs(h64)), 1e-30)) \
                    if h.size else 0.0
                if not np.array_equal(np.isnan(a64), np.isnan(h64)):
                    err = math.inf
                if err > worst[1]:
                    worst = (cid, err)
                errors[cid] = max(errors.get(cid, 0.0), err)
                if err > SWEEP_TOL:
                    failures.append("%s: %.3e of the largest" % (cid, err))
    log("  op sweep, card vs CPU: %d cases over %d registered op names (%s); "
        "worst smooth case %s at %.3e of the largest CPU value (tol %.0e); "
        "%d failures%s"
        % (len(cases), len(list_ops()), ", ".join("%d %s" % (n, k) for k, n in
                                                   sorted(kinds.items())),
           worst[0], worst[1], SWEEP_TOL, len(failures),
           "".join("\n    " + f for f in failures)))
    check(not failures, "the op sweep failed on the card")
    return cases, errors


def run_dcgan_tool():
    """18(d): tools/dcgan.py at the example's defaults for a few steps."""
    from mxnet_tpu_torch.tools import dcgan

    rc = dcgan.main(["--num-epochs", "1", "--steps-per-epoch", "10"])
    check(rc == 0, "tools/dcgan.py failed (a non-finite loss)")


# ------------------------------ SSD-300, Custom and SequentialModule (phase 19)
# the reference's SSD training configuration (example/ssd/train.py, which
# examples/train_ssd.py mirrors): VOC's 20 classes, 300x300, labels of 8
# rows, SGD lr 0.004 momentum 0.9 wd 5e-4, Xavier; batch 32
SSD_BATCH = 32
SSD_CLASSES = 20
SSD_POOL = 4              # batches in the fused fit's set: 5 epochs, 20 steps
SSD_EPOCHS = 5
SSD_CLASSIC_STEPS = 5
SSD_CPU_BATCH = 2
SSD_OUT_TOL = 1e-4        # outputs card vs CPU, of the largest
MULTIBOX_TOL = 1e-5       # boxes, scores, encodings card vs CPU
SSD_TRIES = 3             # seeded points tried under the tie rule
# the six SSD-300 feature maps (38x38 ... 1x1) that MultiBoxPrior spans
SSD_MAPS = (38, 19, 10, 5, 3, 1)
# 19(e): a few fits of small symbols, card vs CPU
SMALL_FIT_TOL = 1e-4


def ssd_args(num_examples, epochs):
    from mxnet_tpu_torch.tools import train_ssd

    return train_ssd.parse_args(["--batch-size", str(SSD_BATCH), "--num-examples",
                                 str(num_examples), "--num-epochs", str(epochs),
                                 "--num-classes", str(SSD_CLASSES)])


def ssd_batch(mx, batch, ctx):
    """The tool's first ``batch`` images and labels, on ``ctx``."""
    from mxnet_tpu_torch.tools import train_ssd

    X, Y = train_ssd.synthetic_set(batch, SSD_CLASSES)
    return mx.io.DataBatch([mx.nd.array(X, ctx=ctx)], [mx.nd.array(Y, ctx=ctx)], pad=0)


def run_ssd(mx, build, fused=True):
    """19(a): SSD-300 through tools/train_ssd.fit on the card, fused (one
    CUDA graph, replayed) or classic: every metric finite, host wall per
    step, images/s, peak memory; no port kernel on the path."""
    from mxnet_tpu_torch.tools import train_ssd

    steps = SSD_POOL * SSD_EPOCHS if fused else SSD_CLASSIC_STEPS
    args = (ssd_args(SSD_BATCH * SSD_POOL, SSD_EPOCHS) if fused
            else ssd_args(SSD_BATCH * SSD_CLASSIC_STEPS, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in build.KERNELS.values():
        k.launches = 0
    with contextlib.nullcontext() if fused else no_fused():
        mod, record = train_ssd.fit(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
    path = "fused" if fused else "classic"
    check(record["steps"] == steps, "SSD fit ran %d steps" % record["steps"])
    check(not launches, "a port kernel ran on SSD's path: %s" % launches)
    check(all(np.isfinite(v) for v in record["train"].values()),
          "SSD: a non-finite metric %s" % record["train"])
    if fused:
        tr = mod._fused.trainer if mod._fused is not None else None
        check(tr is not None and tr.captures == 1 and tr.replays == steps - 1,
              "SSD's fit did not run one captured graph")
    else:
        check(mod._fused is None, "MXNET_MODULE_NO_FUSED=1 still fused")
    log("  [%s] %d steps of batch %d: first step %.4f s; host wall per step "
        "(median after 2, synchronized; the metric's host pass included) "
        "%.5f s = %.1f images/s; peak memory %.3f GB; last CrossEntropy %.4f "
        "SmoothL1 %.4f; %s"
        % (path, steps, SSD_BATCH, record["first_step_s"], record["step_s"],
           record["images_per_sec"], peak / 1e9, record["train"]["CrossEntropy"],
           record["train"]["SmoothL1"], record["device"]["nvidia_smi"]))
    return mod, record, peak


def ssd_first_step(mx, fused, seed):
    """The parameters and matching targets after one step of the tool's
    fit at seed ``seed`` (parameters and data order), fused or classic."""
    from mxnet_tpu_torch.tools import train_ssd

    args = ssd_args(SSD_BATCH, 1)
    seen = []
    real_seed = mx.random.seed

    def first(param):
        seen.append(param.locals["self"].get_outputs()[2].asnumpy())

    mx.random.seed = lambda s: real_seed(s + seed)
    try:
        with contextlib.nullcontext() if fused else no_fused():
            mod, _ = train_ssd.fit(args, batch_end_callback=[first])
    finally:
        mx.random.seed = real_seed
    return ({n: a.asnumpy() for n, a in mod.get_params()[0].items()}, seen[0])


def ssd_fused_against_classic(mx):
    """19(a): the fused and classic parameters after the first step, when
    both steps chose the same matching targets (the tie rule: where the
    hard-negative boundary differs, the next seed, logged)."""
    for k in range(SSD_TRIES):
        f_par, f_cls = ssd_first_step(mx, True, k)
        c_par, c_cls = ssd_first_step(mx, False, k)
        if np.array_equal(f_cls, c_cls):
            break
        log("  seed %d: the fused and classic steps' targets differ at %d "
            "anchors (a mining boundary within rounding); the next seed"
            % (k, int((f_cls != c_cls).sum())))
    check(np.array_equal(f_cls, c_cls), "fused and classic targets differ at "
          "every seed")
    fused_against_classic(f_par, c_par, "of SSD-300 after the first step "
                          "(seed %d)" % k)


def ssd_anchors(mx, ctx):
    """SSD-300's 8732 anchors (1, 8732, 4), from MultiBoxPrior over the
    six feature maps with the zoo's sizes and ratios."""
    from mxnet_tpu_torch.models import ssd

    parts = []
    for hw, sizes, ratios in zip(SSD_MAPS, ssd.SIZES, ssd.RATIOS):
        fm = mx.nd.zeros((1, 1, hw, hw), ctx=ctx)
        parts.append(mx.nd.contrib.MultiBoxPrior(fm, sizes=tuple(sizes),
                                                 ratios=tuple(ratios)).data)
    return mx.nd.NDArray(torch.cat(parts, 1))


def multibox_inputs(seed):
    """Seeded inputs of SSD's matching and detection at batch ``batch``:
    labels as the tool draws them, class logits N(0, 1), their softmax,
    offsets N(0, 0.1^2)."""
    r = np.random.RandomState(seed)
    batch = SSD_BATCH
    A = sum(hw * hw * k for hw, k in zip(SSD_MAPS, (4, 6, 6, 6, 4, 4)))
    lab = -np.ones((batch, 8, 5), np.float32)
    for i in range(batch):
        for j in range(r.randint(1, 4)):
            x0, y0 = r.rand(2) * 0.6
            lab[i, j] = [r.randint(0, SSD_CLASSES), x0, y0,
                         x0 + 0.2 + r.rand() * 0.2, y0 + 0.2 + r.rand() * 0.2]
    logits = r.standard_normal((batch, SSD_CLASSES + 1, A)).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (0.1 * r.standard_normal((batch, A * 4))).astype(np.float32)
    return lab, logits, prob, loc


MULTIBOX_TARGET = dict(overlap_threshold=0.5, ignore_label=-1,
                       negative_mining_ratio=3, minimum_negative_samples=0,
                       negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2))
MULTIBOX_DETECTION = dict(nms_threshold=0.5, force_suppress=False,
                          variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)


def multibox_ops(mx, ctx, lab, logits, prob, loc):
    """MultiBoxTarget and MultiBoxDetection at SSD's attrs on ``ctx``."""
    anchors = ssd_anchors(mx, ctx)
    arr = lambda a: mx.nd.array(a, ctx=ctx)            # noqa: E731
    target = mx.nd.contrib.MultiBoxTarget(anchors, arr(lab), arr(logits),
                                          **MULTIBOX_TARGET)
    det = mx.nd.contrib.MultiBoxDetection(arr(prob), arr(loc), anchors,
                                          **MULTIBOX_DETECTION)
    return target, det


def multibox_card_vs_cpu(mx):
    """19(c): SSD's matching and detection at batch 32 over its 8732
    anchors, card vs CPU on the same inputs: targets' classes and mask
    and the detections' classes (so the kept set) exact, encodings,
    boxes and scores within MULTIBOX_TOL; where an exact part differs,
    the next seeded point, logged. Returns the device ms of the two ops
    together."""
    for k in range(SSD_TRIES):
        inputs = multibox_inputs(k)
        (c_t, c_d), (h_t, h_d) = (multibox_ops(mx, ctx, *inputs)
                                   for ctx in (mx.gpu(0), mx.cpu()))
        c_t, h_t = [a.asnumpy() for a in c_t], [a.asnumpy() for a in h_t]
        c_d, h_d = c_d.asnumpy(), h_d.asnumpy()
        exact = (np.array_equal(c_t[2], h_t[2]) and np.array_equal(c_t[1], h_t[1])
                 and np.array_equal(c_d[..., 0], h_d[..., 0]))
        if exact:
            break
        log("  seeded point %d: the card's targets or kept set differ from the "
            "CPU's (%d target, %d detection rows); the next seeded point"
            % (k, int((c_t[2] != h_t[2]).sum()),
               int((c_d[..., 0] != h_d[..., 0]).sum())))
    check(exact, "MultiBox targets or kept sets differ at every seeded point")
    loc_err = float(np.abs(c_t[0] - h_t[0]).max() / np.abs(h_t[0]).max())
    det_err = float(np.abs(c_d[..., 1:] - h_d[..., 1:]).max())
    kept = int((h_d[..., 0] >= 0).sum())
    log("  MultiBoxTarget/MultiBoxDetection at batch %d, 8732 anchors, card vs "
        "CPU (seeded point %d): targets (%d positive, %d mined negatives) and "
        "the kept set (%d rows) exact; encodings %.3e of the largest, boxes and "
        "scores max abs diff %.3e (tol %.0e)"
        % (SSD_BATCH, k, int((h_t[2] > 0).sum()), int((h_t[2] == 0).sum()),
           kept, loc_err, det_err, MULTIBOX_TOL))
    check(loc_err <= MULTIBOX_TOL and det_err <= MULTIBOX_TOL,
          "MultiBox encodings, boxes or scores differ on the card")
    lab, logits, prob, loc = multibox_inputs(0)
    anchors = ssd_anchors(mx, mx.gpu(0))
    arrs = [mx.nd.array(a, ctx=mx.gpu(0)) for a in (lab, logits, prob, loc)]

    def both():
        mx.nd.contrib.MultiBoxTarget(anchors, arrs[0], arrs[1], **MULTIBOX_TARGET)
        mx.nd.contrib.MultiBoxDetection(arrs[2], arrs[3], anchors, **MULTIBOX_DETECTION)

    ms = device_ms(both, n=5)
    log("  MultiBoxTarget + MultiBoxDetection (400 NMS rows) at batch %d: "
        "%.3f device ms per call" % (SSD_BATCH, ms))
    return ms


def ssd_step(mx, ctx, point, names=(), install=None):
    """One SSD-300 training step at batch SSD_CPU_BATCH on ``ctx`` through
    ``simple_bind`` from ``point`` (parameters) and the tool's first
    images: (outputs, the internal values ``names``, gradients); with
    ``install``, the port takes its ReLU and max-pooling choices from it
    (mxnet_tpu_torch.test_utils.installed_decisions)."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.test_utils import installed_decisions
    from mxnet_tpu_torch.tools import train_ssd

    X, Y = train_ssd.synthetic_set(SSD_CPU_BATCH, SSD_CLASSES)
    net = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    ints = net.get_internals()
    group = mx.sym.Group([net] + [ints[n] for n in names])
    exe = group.simple_bind(ctx=ctx, data=X.shape, label=Y.shape)
    exe.arg_dict["data"][:] = X
    exe.arg_dict["label"][:] = Y
    exe.copy_params_from(point)
    with (contextlib.nullcontext() if install is None
          else installed_decisions(group, install)):
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward()
    grads = {n: exe.grad_dict[n].asnumpy() for n in point}
    return outs[:4], dict(zip(names, outs[4:])), grads


def ssd_step_card_vs_cpu(mx, params):
    """19(b): one SSD-300 step at batch SSD_CPU_BATCH, card vs CPU, from
    the fused fit's parameters: the CPU runs first and records its ReLU
    masks and max-pooling inputs; the card runs natively (to count where
    its rounding crossed a ReLU kink) and then with the CPU's choices
    installed (test_utils.installed_decisions). Targets exact (the tie
    rule: where they differ, the next seeded point, logged), outputs
    within SSD_OUT_TOL of the largest, detections under the trading rule,
    gradients within GRAD_TOL of each one's largest."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.test_utils import decision_names, detections_match

    names = decision_names(ssd.get_symbol_train(num_classes=SSD_CLASSES))
    relus = [n for n in names if n.startswith("relu")]
    for k in range(SSD_TRIES):
        point = params if k == 0 else moved(params, KINK_STEP, k)
        h_out, ref, h_grad = ssd_step(mx, mx.cpu(), point, names)
        _, native, _ = ssd_step(mx, mx.gpu(0), point, relus)
        c_out, _, c_grad = ssd_step(mx, mx.gpu(0), point, install=ref)
        if np.array_equal(c_out[2], h_out[2]):
            break
        log("  %s: the card's targets differ at %d anchors (a mining boundary "
            "within rounding); the next seeded point"
            % ("the trained parameters" if k == 0 else "seeded point %d" % k,
               int((c_out[2] != h_out[2]).sum())))
    check(np.array_equal(c_out[2], h_out[2]), "SSD targets differ at every point")
    crossed = sum(int(((native[n] > 0) != (ref[n] > 0)).sum()) for n in relus)
    out_err = [float(np.abs(c_out[i] - h_out[i]).max() / np.abs(h_out[i]).max())
               for i in (0, 1)]
    traded = detections_match(c_out[3], h_out[3], SSD_OUT_TOL)
    grel = rel(c_grad, h_grad)
    worst = max(grel, key=grel.get)
    log("  one SSD-300 step at batch %d, card vs CPU (%s; ReLU inputs the card's "
        "rounding put across zero natively: %d): targets exact (%d positive); "
        "cls_prob %.3e, loc_loss %.3e of the largest (tol %.0e); detections "
        "%s; worst gradient %s %.3e of its largest (tol %.0e over %d)"
        % (SSD_CPU_BATCH, "at the trained parameters" if k == 0 else
           "at seeded point %d" % k, crossed, int((h_out[2] > 0).sum()),
           out_err[0], out_err[1], SSD_OUT_TOL,
           "differ" if traded is None else "equal (%d rows traded places)" % traded,
           worst, grel[worst], GRAD_TOL, len(grel)))
    check(max(out_err) <= SSD_OUT_TOL, "SSD outputs: card disagrees with CPU")
    check(traded is not None, "SSD detections: card disagrees with CPU")
    check(grel[worst] <= GRAD_TOL, "SSD gradients: card disagrees with CPU")


def run_ssd_tool():
    """19(d): tools/train_ssd.py --evaluate at the example's defaults, as a
    subprocess; its JSON record, mAP finite."""
    import os

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.train_ssd",
                          "--evaluate"], capture_output=True, text=True,
                         timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, "tools/train_ssd.py failed: %s" % out.stderr[-2000:])
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    log("  tools/train_ssd.py --evaluate (%.1f s): %s"
        % (time.perf_counter() - t0, json.dumps(rec)))
    check(np.isfinite(rec["mAP"]), "tools/train_ssd.py: mAP not finite")


def small_fit(mx, ctx, kind):
    """19(e): a few epochs of a small symbol on ``ctx`` from seeded
    parameters: ``"custom"`` (two FullyConnected into the sweep's Custom op
    ``sweep_mul_add`` under a SoftmaxOutput) or ``"sequential"`` (a
    SequentialModule of two Modules). Returns (module, parameters)."""
    from mxnet_tpu_torch.test_utils import _register_sweep_custom

    r = np.random.RandomState(3)
    X = r.rand(40, 5).astype(np.float32)
    y = r.randint(0, 6, (40,)).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=10)
    sym = mx.sym
    if kind == "custom":
        _register_sweep_custom(mx)
        d = sym.Variable("data")
        net = sym.Custom(sym.FullyConnected(d, num_hidden=6, name="fa"),
                         sym.FullyConnected(d, num_hidden=6, name="fb"),
                         op_type="sweep_mul_add", name="cop")
        mod = mx.mod.Module(sym.SoftmaxOutput(net, name="softmax"), context=ctx)
        shapes = {"fa_weight": (6, 5), "fb_weight": (6, 5)}
    else:
        net1 = sym.Activation(sym.FullyConnected(sym.Variable("data"), num_hidden=8,
                                                 name="fc1"), act_type="tanh")
        net2 = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"), num_hidden=6,
                                                    name="fc2"), name="softmax")
        mod = mx.mod.SequentialModule()
        mod.add(mx.mod.Module(net1, label_names=None, context=ctx))
        mod.add(mx.mod.Module(net2, context=ctx), take_labels=True, auto_wiring=True)
        shapes = {"fc1_weight": (8, 5), "fc2_weight": (6, 8)}
    params = {n: r.uniform(-0.3, 0.3, s).astype(np.float32) for n, s in shapes.items()}
    params.update({n.replace("weight", "bias"): np.zeros(s[0], np.float32)
                   for n, s in shapes.items()})
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    stages = [s.module for s in mod._stages] if kind == "sequential" else [mod]
    for m in stages:
        m.set_params({n: mx.nd.array(params[n], ctx=ctx)
                      for n in m.get_params()[0]}, {})
    mod.fit(it, num_epoch=3, optimizer="sgd", kvstore="local",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod, {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


def custom_and_sequential_card_vs_cpu(mx):
    """19(e): the Custom fit and the SequentialModule fit on the card equal
    the same fits on the CPU; the Custom symbol trains on the classic path
    (host Python is never replayed from a captured graph)."""
    for kind in ("custom", "sequential"):
        c_mod, c_par = small_fit(mx, mx.gpu(0), kind)
        _, h_par = small_fit(mx, mx.cpu(), kind)
        diff = {n: float(np.abs(c_par[n] - h_par[n]).max() / np.abs(h_par[n]).max())
                for n in h_par}
        worst = max(diff, key=diff.get)
        veto = c_mod._fused_veto("local") if kind == "custom" else "-"
        log("  %s fit (3 epochs of 4 steps) on the card against the CPU: worst "
            "parameter %s %.3e of its largest (tol %.0e); %s"
            % (kind, worst, diff[worst], SMALL_FIT_TOL,
               "classic path: %s" % veto if kind == "custom"
               else "%d stages" % len(c_mod._stages)))
        check(diff[worst] <= SMALL_FIT_TOL, "%s fit: card disagrees with CPU" % kind)
        if kind == "custom":
            check(c_mod._fused is None and "Custom" in veto,
                  "a symbol with a Custom op took the captured step")


def run_ssd_phase(mx, build, card, sweep):
    """Phase 19."""
    log("  (a) SSD-300 through Module.fit at the reference's training "
        "configuration (%s)" % card)
    mod, f_record, f_peak = run_ssd(mx, build, True)
    c_mod, c_record, c_peak = run_ssd(mx, build, False)
    log("  host wall per step: fused graph %.5f s (%.1f images/s), classic "
        "%.5f s (%.1f images/s), %.2fx; peak memory fused %.3f GB, classic "
        "%.3f GB"
        % (f_record["step_s"], f_record["images_per_sec"], c_record["step_s"],
           c_record["images_per_sec"], c_record["step_s"] / f_record["step_s"],
           f_peak / 1e9, c_peak / 1e9))
    batch = ssd_batch(mx, SSD_BATCH, mx.gpu(0))
    for path, m in (("fused", mod), ("classic", c_mod)):
        def step(m=m):
            m.forward(batch, is_train=True)
            m.backward()
            m.update()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        log("  [%s] the step alone (no metric): host wall %.5f s per step"
            % (path, step_s))
        log_profile("SSD-300 " + path, device_profile(step), step_s)
    del c_mod
    ssd_fused_against_classic(mx)
    log("  (b) one SSD-300 step, card vs CPU")
    ssd_step_card_vs_cpu(mx, {n: a.asnumpy() for n, a in mod.get_params()[0].items()})
    del mod
    log("  (c) the contrib ops and Custom in the operator sweep; MultiBox at "
        "SSD's shapes")
    from mxnet_tpu_torch.ops.registry import get_op, list_ops

    cases, errors = sweep
    names = {n for n in list_ops() if get_op(n).forward.__module__ in
             ("mxnet_tpu_torch.ops.contrib_ops", "mxnet_tpu_torch.operator")}
    check(len(names) == 22, "the slice registers %d op names" % len(names))
    new = [cid for cid in cases if cases[cid].name in names]
    worst = max(new, key=lambda c: errors.get(c, 0.0))
    log("  the sweep held %d cases of the slice's 22 op names card vs CPU (phase "
        "18(c)): worst smooth case %s at %.3e of the largest (tol %.0e)"
        % (len(new), worst, errors.get(worst, 0.0), SWEEP_TOL))
    multibox_card_vs_cpu(mx)
    log("  (d) tools/train_ssd.py --evaluate at the example's defaults")
    run_ssd_tool()
    log("  (e) Custom and SequentialModule, card vs CPU")
    custom_and_sequential_card_vs_cpu(mx)


# ---------------------------------------------------------------- phase 20
AG_SHAPE = (32, 4, 128, 64)   # K1/K2a/K2b's training shape (phase 11)
MHA_BATCH, MHA_SEQ = 32, 128  # one attention block of phase 5's LM
AG_OUT_TOL = F32_TOL          # phase 3's float32 flash tolerance
PIPE_IMAGES = 320
PIPE_BATCH = 32
PIPE_THREADS = 8              # the card machine's host cores
PIPE_PASSES = 2
REC_EPOCHS = 2
WIRE_BATCH = 4                # phase 10's batch
WIRE_STEPS = 3                # eager, capture, replay
SSD_REC_IMAGES = 40          # 5 steps: the Speedometer (every 5) resets after the 6th
SSD_REC_BATCH = 8
MEAN_RGB, STD_RGB = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


class plain_flash:
    """Within the block, the flash ops' autograd Function runs the plain
    forward and backward (on card tensors too), not the kernels."""

    def __init__(self, A):
        self.A = A

    def __enter__(self):
        A = self.A
        self.saved = A.flash_attention_forward, A.flash_attention_backward
        A.flash_attention_forward = lambda q, k, v, causal=False, sm_scale=None: \
            A._flash_forward_plain(q, k, v, causal, A._scale(sm_scale, q.shape[-1]))
        A.flash_attention_backward = lambda q, k, v, out, lse, g, causal=False, \
            sm_scale=None: A._flash_backward_plain(
                q, k, v, out, lse, g, causal, A._scale(sm_scale, q.shape[-1]))

    def __exit__(self, *exc):
        self.A.flash_attention_forward, self.A.flash_attention_backward = self.saved


def recorded_grads(mx, make_out, inputs, head):
    """``contrib.autograd`` over ``make_out(*arrays)`` on the card: marks
    the ``inputs`` (numpy), records, backward with head gradient ``head``;
    returns (output, gradients) as numpy."""
    ag = mx.contrib.autograd
    ctx = mx.gpu(0)
    arrs = [mx.nd.array(x, ctx=ctx) for x in inputs]
    grads = [mx.nd.zeros(x.shape, ctx=ctx) for x in inputs]
    ag.mark_variables(arrs, grads)
    with ag.train_section():
        out = make_out(*arrs)
    ag.backward([out], out_grads=[mx.nd.array(head, ctx=ctx)])
    torch.cuda.synchronize()
    ag._MARKED.clear()
    return out.asnumpy(), [g.asnumpy() for g in grads]


def autograd_phase(mx, A, build):
    """20(a): returns the kernels' launches in the two recorded runs."""
    rng = np.random.RandomState(20)
    b, h, s, d = AG_SHAPE
    qkv = [rng.standard_normal(AG_SHAPE).astype(np.float32) for _ in range(3)]
    dm = TRAIN["model_dim"]
    x = rng.standard_normal((MHA_BATCH, MHA_SEQ, dm)).astype(np.float32)
    wi = (rng.standard_normal((3 * dm, dm)) / math.sqrt(dm)).astype(np.float32)
    wo = (rng.standard_normal((dm, dm)) / math.sqrt(dm)).astype(np.float32)
    cases = (
        ("FlashAttention %s float32 causal" % (AG_SHAPE,),
         lambda q, k, v: mx.nd.contrib.FlashAttention(q, k, v, causal=True),
         qkv, rng.standard_normal(AG_SHAPE).astype(np.float32)),
        ("MultiHeadAttention block (%d, %d, %d), %d heads" % (
            MHA_BATCH, MHA_SEQ, dm, TRAIN["num_heads"]),
         lambda xx, w1, w2: mx.nd.relu(mx.nd.contrib.MultiHeadAttention(
             xx, w1, w2, num_heads=TRAIN["num_heads"], causal=True) + xx),
         [x, wi, wo], rng.standard_normal(x.shape).astype(np.float32)))
    total = {}
    for what, fn, inputs, head in cases:
        for k in build.KERNELS.values():
            k.launches = 0
        out, grads = recorded_grads(mx, fn, inputs, head)
        launched = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
        with plain_flash(A):
            p_out, p_grads = recorded_grads(mx, fn, inputs, head)
        check(not any(k.launches != launched.get(n, 0)
                      for n, k in build.KERNELS.items()),
              "the plain run launched a kernel")
        out_err = float(np.abs(out - p_out).max())
        g_err = [float(np.abs(g - p).max() / np.abs(p).max())
                 for g, p in zip(grads, p_grads)]
        log("  %s under contrib.autograd: launches %s; output max abs diff "
            "%.3e (tol %.0e); gradients' max abs diff / largest %s (tol %.0e) "
            "against the plain versions on the card"
            % (what, launched, out_err, AG_OUT_TOL,
               ", ".join("%.3e" % e for e in g_err), GRAD_TOL))
        check(launched == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1},
              "the recorded graph did not launch K1, K2a and K2b once each")
        check(np.isfinite(out).all() and all(np.isfinite(g).all() for g in grads),
              "autograd gave non-finite values")
        check(out_err <= AG_OUT_TOL, "autograd output: kernels disagree with plain")
        check(max(g_err) <= GRAD_TOL, "autograd gradients: kernels disagree with plain")
        for n, v in launched.items():
            total[n] = total.get(n, 0) + v
    sym = mx.sym
    data = sym.Variable("data")
    ops = (("FullyConnected+tanh", sym.tanh(sym.FullyConnected(data, num_hidden=16)),
            (8, 32)),
           ("Convolution", sym.Convolution(data, num_filter=8, kernel=(3, 3),
                                           pad=(1, 1)), (4, 3, 16, 16)),
           ("BatchNorm", sym.BatchNorm(data, fix_gamma=False), (4, 6, 8, 8)),
           ("softmax", sym.softmax(data), (8, 100)),
           ("Pooling", sym.Pooling(data, kernel=(2, 2), stride=(2, 2),
                                   pool_type="max"), (4, 3, 16, 16)))
    from mxnet_tpu_torch import test_utils as tu

    for what, net, shape in ops:
        worst = tu.check_consistency(
            net, [{"ctx": mx.cpu(), "shapes": {"data": shape}},
                  {"ctx": mx.gpu(0), "shapes": {"data": shape}}],
            raise_on_err=False)
        log("  check_consistency [cpu, gpu(0)] %s %s: worst violation %.3f of "
            "the float32 tolerance 1e-3 (outputs and gradients)"
            % (what, shape, worst))
        check(worst <= 1.0, "check_consistency: %s differs card vs CPU" % what)
    return total


def synthetic_jpegs(root, n, seed, boxes=False):
    """``n`` JPEGs of ImageNet-like size (short side 256-500, aspect up to
    1.5) under ``root``: smooth seeded colour fields with noise, two class
    folders. Returns their paths."""
    import os

    from PIL import Image

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        short = rng.randint(256, 501)
        long_ = int(short * rng.uniform(1.0, 1.5))
        hh, ww = (short, long_) if rng.rand() < 0.5 else (long_, short)
        base = Image.fromarray((rng.rand(6, 8, 3) * 255).astype(np.uint8))
        img = np.asarray(base.resize((ww, hh), Image.BILINEAR), np.float32)
        img = np.clip(img + rng.standard_normal(img.shape) * 12, 0, 255)
        d = os.path.join(root, "class%d" % (i % 2))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "%04d.jpg" % i)
        Image.fromarray(img.astype(np.uint8)).save(path, quality=90)
        paths.append(path)
    return paths


def decoder_against_pil(mx, rec_path, n=32):
    """The native decoder's pixels against PIL's on the first ``n``
    records: (max abs diff, mean abs diff)."""
    import ctypes
    import io as _io

    from PIL import Image

    from mxnet_tpu_torch import _native

    lib = _native.load()
    rec = mx.recordio.MXRecordIO(rec_path, "r")
    worst, mean = 0, []
    for _ in range(n):
        raw = rec.read()
        if raw is None:
            break
        _, img = mx.recordio.unpack(raw)
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        hh, ww = ctypes.c_int(), ctypes.c_int()
        check(lib.mxt_decode_jpeg(img, len(img), ctypes.byref(ptr),
                                  ctypes.byref(hh), ctypes.byref(ww)) == 0,
              "the native decoder failed on a record")
        got = np.ctypeslib.as_array(ptr, shape=(hh.value, ww.value, 3)).astype(np.int16)
        lib.mxt_rec_free(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_char)),
                         hh.value * ww.value * 3)
        want = np.asarray(Image.open(_io.BytesIO(img)).convert("RGB")).astype(np.int16)
        check(got.shape == want.shape, "decoded shape differs from PIL's")
        diff = np.abs(got - want)
        worst = max(worst, int(diff.max()))
        mean.append(float(diff.mean()))
    rec.close()
    return worst, float(np.mean(mean))


def pipeline_rate(mx, rec_path, backend, threads):
    """Images/s of ImageRecordIter into a null consumer over
    ``PIPE_PASSES`` passes (start-up included)."""
    it = mx.io_image.ImageRecordIter(
        rec_path, (3, 224, 224), PIPE_BATCH, rand_crop=True, rand_mirror=True,
        mean_r=MEAN_RGB[0], mean_g=MEAN_RGB[1], mean_b=MEAN_RGB[2],
        std_r=STD_RGB[0], std_g=STD_RGB[1], std_b=STD_RGB[2],
        backend=backend, preprocess_threads=threads, wire_dtype="uint8")
    images = 0
    t0 = time.perf_counter()
    for p in range(PIPE_PASSES):
        if p:
            it.reset()
        for b in it:
            images += PIPE_BATCH - b.pad
    dt = time.perf_counter() - t0
    native = it._native is not None
    it.close()
    check(native == (backend == "native"), "the %s backend did not run" % backend)
    return images / dt, images


def imagenet_args(data_dir, threads, extra=()):
    from mxnet_tpu_torch.tools import train_imagenet as ti

    return ti.parse_args(["--network", "resnet", "--num-layers", "50",
                          "--batch-size", str(RESNET_BATCH), "--dtype", "bfloat16",
                          "--num-classes", "1000", "--kv-store", "device",
                          "--data-dir", data_dir,
                          "--data-nthreads", str(threads),
                          "--num-examples", str(PIPE_IMAGES),
                          "--num-epochs", str(REC_EPOCHS), "--lr", "0.05",
                          "--rgb-std", ",".join(str(v) for v in STD_RGB)]
                         + list(extra))


def record_fit(mx, build, data_dir, rn_fused, threads):
    """20(c): ResNet-50 from the records through tools/train_imagenet.fit
    with ``threads`` decode threads."""
    from mxnet_tpu_torch.tools import train_imagenet as ti

    args = imagenet_args(data_dir, threads)
    for k in build.KERNELS.values():
        k.launches = 0
    mod, rec = ti.fit(args, eval_data=False)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in build.KERNELS.items() if k.launches}
    log("  tools/train_imagenet.py --data-dir (ResNet-50, batch %d, bf16 over "
        "f32 masters, fused): %s" % (args.batch_size, json.dumps(rec)))
    tr = mod._fused.trainer if mod._fused is not None else None
    check(tr is not None and tr.captures == 1 and tr.replays == rec["steps"] - 1,
          "the record fit did not replay one captured graph")
    buf = tr.input_buffers()["data"]
    c, hh, ww = (int(v) for v in args.image_shape.split(","))
    check(tr.wire is not None and buf.dtype == torch.uint8
          and tuple(buf.shape) == (args.batch_size, hh, ww, c),
          "the fused step's static input is not the uint8 NHWC batch")
    check(rec["data"]["backend"] == "native" and rec["data"]["wire"] == "uint8",
          "the record fit did not read through the native stage's uint8 wire")
    check(all(np.isfinite(v) for v in rec["train"].values()), "non-finite metric")
    check(not launches, "a port kernel ran on ResNet's path: %s" % launches)
    # the steps again, each with its batch drawn from the records, under
    # one profiler window
    train, _ = ti.make_iters(args, (c, hh, ww), mx.context.default_device())

    def step():
        try:
            batch = train.next()
        except StopIteration:
            train.reset()
            batch = train.next()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 6
    prof = device_profile(step)
    train.close()
    busy = prof[0] / (step_s * 1e3) if prof else float("nan")
    log_profile("ResNet-50 from records", prof, step_s)
    syn = rn_fused["step_s"]
    # input bound: the fit's step more than 5 % over the synthetic one while
    # the device idles more than a tenth of the step
    bound = rec["step_s"] > 1.05 * syn and busy < 0.9
    log("  records, %d decode threads: host wall per step %.5f s in the fit "
        "(%.1f images/s, %.3fx phase 9's), %.5f s in the profiled steps, busy "
        "share %.3f; phase 9's synthetic-data step %.5f s (%.1f images/s): the "
        "fit is %s" % (threads, rec["step_s"], rec["images_per_sec"],
                       rec["step_s"] / syn, step_s, busy, syn,
                       args.batch_size / syn,
                       "input bound" if bound else "not input bound"))
    return rec


def wire_checks(mx, A):
    """20(d): the wire's op card vs CPU; fused steps fed the uint8 wire
    against the same steps fed host-normalized float32 batches."""
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (8, 224, 224, 3)).astype(np.uint8)
    attrs = dict(mean=MEAN_RGB, std=STD_RGB)
    got = mx.nd._image_wire_normalize(mx.nd.array(x, ctx=mx.gpu(0), dtype=np.uint8),
                                      **attrs).asnumpy()
    want = mx.nd._image_wire_normalize(mx.nd.array(x, ctx=mx.cpu(), dtype=np.uint8),
                                       **attrs).asnumpy()
    log("  _image_wire_normalize (8, 224, 224, 3) uint8 on the card against the "
        "CPU: %s (max abs diff %.3e)"
        % ("bitwise equal" if np.array_equal(got, want) else "differ",
           float(np.abs(got - want).max())))
    check(np.array_equal(got, want), "_image_wire_normalize: card differs from CPU")
    sym = mx.models.resnet(**RESNET)
    X = rng.randint(0, 256, (WIRE_STEPS, WIRE_BATCH, 224, 224, 3)).astype(np.uint8)
    Y = rng.randint(0, 1000, (WIRE_STEPS, WIRE_BATCH)).astype(np.float32)
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind(data_shapes=[("data", (WIRE_BATCH, 3, 224, 224))],
              label_shapes=[("softmax_label", (WIRE_BATCH,))])
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2, rng=torch.Generator().manual_seed(3)))
    args0, auxs0 = ({n: a.asnumpy() for n, a in d.items()} for d in init.get_params())
    wire = mx.io.WireSpec(MEAN_RGB, STD_RGB, "NHWC")
    mean = np.asarray(MEAN_RGB, np.float32)
    std = np.asarray(STD_RGB, np.float32)

    def steps(fed, deterministic):
        """WIRE_STEPS fused steps fed ``fed``: (outputs, params, auxs)."""
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            mod = mx.mod.Module(sym, context=mx.gpu(0))
            mod.bind(data_shapes=[("data", (WIRE_BATCH, 3, 224, 224))],
                     label_shapes=[("softmax_label", (WIRE_BATCH,))])
            mod.init_params(arg_params=args0, aux_params=auxs0)
            mod.init_optimizer(kvstore="device", optimizer="sgd",
                               optimizer_params={"learning_rate": 0.05,
                                                 "momentum": 0.9,
                                                 "rescale_grad": 1.0 / WIRE_BATCH})
            for i in range(WIRE_STEPS):
                if fed == "wire":
                    data = mx.nd.array(X[i], ctx=mx.cpu(), dtype=np.uint8)
                else:
                    data = mx.nd.array(((X[i].astype(np.float32) - mean) / std)
                                       .transpose(0, 3, 1, 2), ctx=mx.cpu())
                batch = mx.io.DataBatch([data], [mx.nd.array(Y[i], ctx=mx.cpu())],
                                        wire=wire if fed == "wire" else None)
                mod.forward(batch, is_train=True)
                mod.update()
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = saved
        tr = mod._fused.trainer
        check(tr.captures == 1 and tr.replays == WIRE_STEPS - 1,
              "the %s-fed steps did not replay a graph" % fed)
        check((tr.wire is not None) == (fed == "wire"), "the step's input format")
        return (mod.get_outputs()[0].asnumpy(),
                *({n: a.asnumpy() for n, a in d.items()} for d in mod.get_params()))

    def differ(a, b):
        (o_a, a_a, x_a), (o_b, a_b, x_b) = a, b
        out_err = float(np.abs(o_a - o_b).max() / np.abs(o_b).max())
        aux = max(float(np.abs(x_a[n] - x_b[n]).max() / np.abs(x_b[n]).max())
                  for n in x_b)
        _, glob = compare_step(args0, a_a, args0, a_b)
        same = np.array_equal(o_a, o_b) and all(
            np.array_equal(a_a[n], a_b[n]) for n in a_b)
        return out_err, aux, glob, same

    # cuDNN's default convolution algorithms are not run-to-run
    # deterministic, and three steps of ResNet-50 at batch 4 amplify their
    # differences, so the feeds are compared under its deterministic ones
    noise = differ(steps("float32", False), steps("float32", False))
    log("  two float-fed runs of %d fused float32 steps at batch %d with cuDNN's "
        "default algorithms: outputs %.3e of the largest, worst BN statistic "
        "%.3e, updates %.3e of the largest (%s)"
        % (WIRE_STEPS, WIRE_BATCH, *noise[:3],
           "bitwise equal" if noise[3] else "not bitwise equal"))
    out_err, aux, glob, same = differ(steps("wire", True), steps("float32", True))
    log("  %d fused float32 steps at batch %d (eager, capture, replay; cuDNN's "
        "deterministic algorithms) fed the uint8 wire against host-normalized "
        "float32: outputs %.3e of the largest (tol %.0e), worst BN statistic "
        "%.3e (tol %.0e), updates %.3e of the largest (tol %.0e); %s"
        % (WIRE_STEPS, WIRE_BATCH, out_err, RESNET_OUT_TOL, aux, RESNET_AUX_TOL,
           glob, RESNET_OUT_TOL, "bitwise equal" if same else "not bitwise equal"))
    check(out_err <= RESNET_OUT_TOL and aux <= RESNET_AUX_TOL
          and glob <= RESNET_OUT_TOL, "the wire-fed step differs from the float one")


def det_records(mx, path, n, seed):
    """``n`` detection records of synthetic JPEGs with one to three boxes
    each (label [2, 5, cls, x0, y0, x1, y1, ...])."""
    import os
    import tempfile

    rng = np.random.RandomState(seed)
    with tempfile.TemporaryDirectory() as tmp:
        paths = synthetic_jpegs(tmp, n, seed)
        w = mx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                          path, "w")
        for i, p in enumerate(paths):
            boxes = []
            for _ in range(rng.randint(1, 4)):
                x0, y0 = rng.rand(2) * 0.6
                boxes += [rng.randint(0, SSD_CLASSES), x0, y0,
                          x0 + 0.2 + 0.2 * rng.rand(), y0 + 0.2 + 0.2 * rng.rand()]
            with open(p, "rb") as f:
                w.write_idx(i, mx.recordio.pack(
                    mx.recordio.IRHeader(0, np.array([2, 5] + boxes, np.float32),
                                         i, 0), f.read()))
        w.close()


def run_data_phase(mx, A, build, card, rn_fused):
    """Phase 20; returns the kernels' launches of (a)'s recorded runs."""
    import os
    import tempfile

    log("  (a) contrib.autograd over the flash kernels at full width")
    launches = autograd_phase(mx, A, build)
    log("  (b) the pipeline alone")
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    lib_decoder = _native.decoder()
    log("  decoder: %s (the native stage, built in %.2f s); the Python "
        "pipeline decodes with %s" % (lib_decoder, time.perf_counter() - t0,
                                       mx.image.python_decoder()))
    check(lib_decoder != "none", "the native stage has no JPEG decoder")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthetic_jpegs(os.path.join(tmp, "images"), PIPE_IMAGES, 0)
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        from mxnet_tpu_torch.tools import im2rec

        prefix = os.path.join(data_dir, "train")
        im2rec.main([prefix, os.path.join(tmp, "images"), "--list", "--recursive"])
        im2rec.main([prefix, os.path.join(tmp, "images"), "--pass-through"])
        rec_path = prefix + ".rec"
        log("  %d JPEGs (short side 256-500) packed by tools/im2rec.py into %s "
            "(%.1f MB) in %.1f s" % (PIPE_IMAGES, os.path.basename(rec_path),
                                     os.path.getsize(rec_path) / 1e6,
                                     time.perf_counter() - t0))
        worst, mean = decoder_against_pil(mx, rec_path)
        log("  %s against PIL on 32 records: max abs pixel diff %d, mean %.4f"
            % (lib_decoder, worst, mean))
        for backend in ("native", "python"):
            rate, n = pipeline_rate(mx, rec_path, backend, PIPE_THREADS)
            log("  ImageRecordIter %s backend, %d threads, batch %d, random 224 "
                "crop + mirror, uint8 wire: %.1f images/s into a null consumer "
                "(%d images, %d passes, start-up included) (%s)"
                % (backend, PIPE_THREADS, PIPE_BATCH, rate, n, PIPE_PASSES, card))
        log("  (c) ResNet-50 from the records through tools/train_imagenet.py "
            "--data-dir")
        os.remove(prefix + ".idx")
        for threads in (PIPE_THREADS, PIPE_THREADS // 2):
            record_fit(mx, build, data_dir, rn_fused, threads)
    log("  (d) the uint8 wire: the op and the fused step")
    wire_checks(mx, A)
    log("  (e) tools/train_ssd.py --data-dir over ImageDetRecordIter records")
    with tempfile.TemporaryDirectory() as tmp:
        det_records(mx, os.path.join(tmp, "train.rec"), SSD_REC_IMAGES, 1)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.train_ssd", "--data-dir",
             tmp, "--batch-size", str(SSD_REC_BATCH), "--num-epochs", "1",
             "--data-nthreads", str(PIPE_THREADS)],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(out.returncode == 0, "tools/train_ssd.py --data-dir failed: %s"
              % out.stderr[-2000:])
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        log("  tools/train_ssd.py --data-dir (%.1f s): %s"
            % (time.perf_counter() - t0, json.dumps(rec)))
        check(rec["data"] == "ImageDetRecordIter" and rec["steps"] ==
              SSD_REC_IMAGES // SSD_REC_BATCH, "train_ssd did not read the records")
        check(all(np.isfinite(v) for v in rec["train"].values()),
              "train_ssd from records: non-finite loss")
    return launches


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
    op_us = host_us_per_op()
    log("  host time to enqueue a small op: %.3f us" % op_us)

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
    wide_err = check_flash_wide(A, build)
    log("  worst errors: flash %s, paged %s, paged_multi %s, flash_bwd %s, "
        "flash_wide %s"
        % ({str(k)[6:]: v for k, v in flash_err.items()},
           {str(k)[6:]: v for k, v in paged_err.items()},
           {str(k)[6:]: v for k, v in multi_err.items()},
           {str(k)[6:]: v for k, v in bwd_err.items()},
           {str(k)[6:]: v for k, v in wide_err.items()}))

    log("== 4. serving at full width")
    cfg, params, launches, counts = run_serving(S, M, build, tel)
    teacher_forced(S, M, cfg, params)

    log("== 5. training at full width through Module.fit")
    t_launches, t_counts, t_params, t_mod = run_training(mx, build)
    c_launches, c_counts, c_params, _ = run_training(mx, build, fused=False)
    fused_against_classic(t_params, c_params)
    log("  host wall per step: fused graph %.5f s, classic %.5f s (%.2fx)"
        % (t_counts["step_s"], c_counts["step_s"],
           c_counts["step_s"] / t_counts["step_s"]))

    log("== 6. one training step, card vs CPU")
    train_step_card_vs_cpu(mx, t_params)

    log("== 7. speculative serving at full width from the phase-5 checkpoint")
    spec_runs = run_spec_serving(mx, S, M, build, tel, t_mod)

    log("== 8. training at head_dim 512 (the wide flash kernels)")
    w_launches, w_params = run_wide_training(mx, build)
    # phase 6's check at head_dim 512: the wide kernels on the card against
    # the plain versions on the CPU through a whole step
    train_step_card_vs_cpu(mx, w_params, WIDE)

    log("== 9. ResNet-50 through Module.fit at bench.py's configuration")
    rn_fused = run_resnet(mx, build)
    rn_classic = run_resnet(mx, build, fused=False)
    log("  host wall per step: fused graph %.5f s (%.1f images/s), classic "
        "%.5f s (%.1f images/s), %.2fx"
        % (rn_fused["step_s"], RESNET_BATCH / rn_fused["step_s"],
           rn_classic["step_s"], RESNET_BATCH / rn_classic["step_s"],
           rn_classic["step_s"] / rn_fused["step_s"]))

    log("== 10. ResNet-50, one fused step, card vs CPU")
    resnet_card_vs_cpu(mx)

    log("== 11. times (%s)" % card)
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
    total = {n: launches[n] + t_launches[n] + w_launches[n]
             + sum(r[1][n] for r in spec_runs.values()) for n in launches}
    wide_fwd = time_flash(A, WIDE_BATCH, WIDE["num_heads"], WIDE["seq_len"],
                          WIDE["model_dim"] // WIDE["num_heads"], wide=True)
    wide_dkv, wide_dq = time_flash_bwd(
        A, build, WIDE_BATCH, WIDE["num_heads"], WIDE["seq_len"],
        WIDE["model_dim"] // WIDE["num_heads"], wide=True)
    wide_per = "training at head_dim 512 %%d (%d per step)" % (
        WIDE["num_layers"])
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
                total["paged_decode_multi"] / spec_steps)),
            ("flash_wide_fwd", "mxnet_tpu_torch/csrc/flash_wide.cu",
             "mxnet_tpu/ops/attention.py:142", wide_fwd,
             wide_per % w_launches["flash_wide_fwd"]),
            ("flash_wide_bwd_dkv", "mxnet_tpu_torch/csrc/flash_wide.cu",
             "mxnet_tpu/ops/attention.py:303", wide_dkv,
             wide_per % w_launches["flash_wide_bwd_dkv"]),
            ("flash_wide_bwd_dq", "mxnet_tpu_torch/csrc/flash_wide.cu",
             "mxnet_tpu/ops/attention.py:331", wide_dq,
             wide_per % w_launches["flash_wide_bwd_dq"])):
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
    # the wide route at a long sequence, beside its plain versions, SDPA
    # and its bound
    long_fwd = time_flash(A, *WIDE_LONG, wide=True)
    long_dkv, long_dq = time_flash_bwd(A, build, *WIDE_LONG, wide=True)
    for name, res in (("flash_wide_fwd", long_fwd),
                      ("flash_wide_bwd_dkv", long_dkv),
                      ("flash_wide_bwd_dq", long_dq)):
        t_bytes = res["nbytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = res["flops"] / res["peak"] * 1e3
        log("  %s long sequence at %s: kernel_ms %.6f plain_ms %.6f "
            "library_ms %.6f bound_ms %.6f (%s: %d bytes at 3.35 TB/s, %d "
            "FLOP at %s) max_abs_err %.3e"
            % (name, res["shape"], res["ms"], res["plain"], res["lib"],
               max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
               "operations", res["nbytes"], res["flops"], res["peak_name"],
               res["err"]))
        check(res["err"] <= F32_TOL, "%s disagrees at a long sequence" % name)
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

    log("== 12. device profiles of the training steps")
    for label, step, step_s in PROFILES:
        log_profile(label, device_profile(step), step_s)

    log("== 13. the bucketed LSTM LM through BucketingModule.fit (%s)" % card)
    l_fused, _, _ = run_lstm(mx, build)
    l_classic, _, _ = run_lstm(mx, build, fused=False)
    # the same 1e-4 as the LM's (phase 5): the embedding's backward sums
    # its rows in an order that changes from run to run
    fused_against_classic(l_fused, l_classic, "of the LSTM LM after %d "
                          "epochs" % LSTM_EPOCHS)

    log("== 14. the fused RNN op (models.lstm_lm(fused=True))")
    r_fused, _, _ = run_lstm(mx, build, rnn_op=True)
    lstm_step_card_vs_cpu(mx, r_fused, rnn_op=True)
    lstm_step_card_vs_cpu(mx, l_fused, rnn_op=False)

    log("== 15. resume on the Transformer-LM (fit(auto_resume=...)) (%s)" % card)
    for fused in (True, False):
        for name, n in run_resume(mx, build, fused).items():
            row = next(r for r in rows if r["name"] == name)
            row["launches"] += n

    log("== 16. serving through the bucket graphs; the decode symbol (%s)"
        % card)
    g_launches = graphs_against_eager(S, M, build, params,
                                      prompt_mix(SERVE["vocab_size"]))
    for row in rows:
        row["launches"] += g_launches[row["name"]]
    decode_symbol_check(mx, t_params)
    paged_op_check(mx, A, build)
    graph_recovery(S, params, card)

    log("== 17. the image-classification zoo through tools/train_imagenet "
        "(%s)" % card)
    run_image_zoo(mx, build, card)

    log("== 18. DCGAN through two Modules; the operator sweep (%s)" % card)
    log("  host time to enqueue a small op: %.3f us (phase 1: %.3f us)"
        % (host_us_per_op(), op_us))
    log("  (a) DCGAN at the reference widths")
    gen, dis = run_dcgan(mx, build, card)
    log("  (b) one GAN step, card vs CPU")
    dcgan_step_card_vs_cpu(mx, gen, dis)
    del gen, dis
    log("  (c) every registered op, card vs CPU")
    sweep = op_sweep(mx)
    log("  (d) tools/dcgan.py at the example's defaults")
    run_dcgan_tool()

    log("== 19. SSD-300 through Module.fit; Custom and SequentialModule (%s)"
        % card)
    run_ssd_phase(mx, build, card, sweep)

    log("== 20. autograd over the flash kernels; the data pipeline (%s)" % card)
    for name, n in run_data_phase(mx, A, build, card, rn_fused).items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
