"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch`` (never the JAX package) on ``cuda:0``:

1. device — requires CUDA; prints the card's name and power limit, the
   torch and CUDA versions;
2. build — compiles every hand-written kernel from
   ``mxnet_tpu_torch/csrc`` with ``nvcc`` (one process per source, all
   started together) and prints the ptxas report; beside them, the host
   builds that phases 20 and 26 load (the native host stage, the C
   library and its clients);
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
   through ``BucketingModule.fit`` for 2 epochs of 2000 seeded sentences
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
   subprocess (running beside (b), (c) and (e) since PR 24), its JSON
   line, mAP finite; (e) a fit of a symbol holding a
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
   over ``ImageDetRecordIter`` records for a few steps (running beside
   (d) since PR 24).

21. the example scripts and ``mx.kv`` — (a) ``examples/train_lm.py``
   from its own source with only its import lines pointed at the port, at
   its defaults (``mx.tpu()``, the fused step; ``mx.context.auto()`` must
   be ``cuda:0``): one capture, perplexity falling, one launch of K1, K2a
   and K2b per layer and step (counts set to 0 just before, read just
   after); (b) ``tools/launch.py -n 2 -s 1``: two workers on ``cuda:0`` and
   one server on the host train the zoo Transformer-LM at phase 5's width
   (batch 32 per worker, 2 epochs of 4 batches of each worker's half of
   256 sequences, Adam on the server) with ``kvstore='dist_sync'``, fused
   (the gradient step one CUDA graph, the exchange on the host, the
   pulled weights copied into the captured masters) and then with
   ``MXNET_MODULE_NO_FUSED=1`` (the two clusters and (c)'s run at once,
   so their walls per step are taken side by side): each worker's
   perplexity finite and
   falling, one launch of each flash kernel per layer and step in each
   worker, the two workers' final parameters bitwise equal, fused
   against classic within phase 5's 1e-4, the server's exit line saying
   it never initialized CUDA, and each path's host wall per step beside
   phase 5's fused ``local`` one; every cluster in its own process group,
   killed past its time limit; (c) ``examples/train_mnist.py --kv-store
   dist_sync`` under the same launcher, every process seeded with
   ``MNIST_SEED``: both epochs' validation accuracy finite, the last above
   0.5 in each worker.
22. model parallelism — (a) ``build_mesh({"sp": 4})``: four positions on
   ``cuda:0`` (printed); ring and Ulysses attention at (2, 8, 4096, 64)
   float32 causal over them against one whole-sequence
   ``flash_attention`` call and against the same schemes over the plain
   versions: outputs within 2e-5 and q/k/v gradients within 1e-4 of the
   largest (the JAX tests' tolerances), 10 launches of K1, K2a and K2b
   per ring forward and backward and 4 per Ulysses (counts set to 0 just
   before each, read just after), and the device ms of each beside the
   whole-sequence call; (b) ``ParallelLMModule.fit`` at the zoo LM's
   width with seq 1024, batch 8, Adam 3e-3, 6 steps of
   ``examples/train_lm_parallel.py``'s corpus in dense, sp (4 positions),
   pp (4 stages, 4 microbatches) and ep (4 positions, 8 experts,
   capacity 2.0): every loss finite and the last below the first, sp's
   and pp's losses within rtol 2e-4 of dense's, sp's launches (10 K1 per
   layer and forward, the step's and the metric's; as many K2a/K2b per
   backward), per-step host wall and peak memory of each mode; (c)
   ``examples/model_parallel_lstm.py``'s net from its own source with its
   layer groups on ``tpu(0)`` and ``cpu(0)`` and ``out`` on ``tpu(0)``:
   5 steps of forward, backward and SGD against the graph bound to
   ``tpu(0)`` alone, outputs and parameters within 1e-4 of the largest,
   each parameter on its group's device, copies per step printed; (d)
   the Transformer-LM's classic ``Module.fit`` with ``context=[tpu(0),
   tpu(0)]`` against one context: the first batch's summed gradients
   within 1e-4 and the parameters after 4 SGD steps within 1e-3 of the
   largest, one K1, K2a and K2b per layer, executor and step.

23. A7's training half on the zoo LM at full width (batch 32 x 128,
   Adam; K1, K2a, K2b) — (a) the fused ``fit(guard="rollback")`` over 12
   batches with ``MXNET_FAULT_SPEC="nan:after=5,times=1"``,
   ``max_bad_steps=1``, ``snapshot_every=4``: exactly one bad step and one
   rollback to batch 4, the batches replayed from there in the one CUDA
   graph, the final parameters within 1e-6 of the largest of the
   unguarded fit's, the launches (one of each per layer and step, the
   bad step included) and both fits' host wall per step; (b) the classic
   path under ``skip`` with a NaN-poisoned gradient: the parameters after
   that step bitwise those before it; (c) a ``stall`` in the device
   feed's transfer stage with ``MXNET_GUARD_STALL_S=3``: ``StallError``
   within 8 s of the last step, no feed thread or feed left; (d)
   ``fit(monitor=Monitor(1))`` (SGD): the first batch's records on the
   card against the CPU port's from the same weights and batch, node
   outputs within 1e-4 relative, gradients and updated weights within
   phase 6's 1e-3, K1 launched by the monitored forward; (e) the profiler in mode
   ``all`` with ``MXNET_PROFILER_TRACE_DIR`` (traces under
   ``build/phase23/``) around 3 classic steps, whose device trace
   holds as many K1/K2a/K2b kernel events as the launch counters moved,
   and around 3 graph replays (what the trace shows is printed); (f)
   ``compileobs.program_table()`` (the fused-step captures, phase 4's and
   16's serving graphs, the nvcc builds), a seq_len recompile of
   ``fused.step`` when the LM (its block reshape written as a batch
   split, one graph at every length) is fit at seq 128 then 64, and
   ``Executor.memory_analysis()`` of the classic executor: peak above the
   arguments, the next step unchanged by the call; (g) a 100 GB request
   under ``oom_guard("executor.fwd")``: torch's OOM after a report naming
   the program, then a step that runs. Then ``MXNET_BACKWARD_DO_MIRROR=1``
   against plain on the fused step (K1 per replay twice the plain
   step's, host wall, peak, parameters within 1e-6) and
   ``examples/memcost.py``'s network at its defaults (both peaks).

24. A6c, the parameter server's HA and elastic half, on phase 21(b)'s LM
   fit (256 sequences, batch 32, 2 epochs of 4 steps per worker, Adam,
   fused on ``cuda:0``; the sequences reordered so that the contiguous
   shard ``num_parts=2`` gives each worker phase 21's) under
   ``tools/launch.py --elastic`` with 0.5 s heartbeats and a 2 s timeout:
   (a) ``-s 4`` with ``MXNET_KV_REPLICAS=1`` (groups [0, 1] and [2, 3]),
   server checkpoints every 2 steps, and server 2, group 1's primary,
   SIGKILLed mid-epoch 1 (``kill_server``): the launcher exits 0, both
   workers finish on the server map 0,3 with bitwise equal parameters,
   the logs show the promotion, the map adopted, server 2 relaunched, a
   checkpoint written, the optimizer state restored and the rejoin as a
   backup, and every server (the relaunched one too) stops without having
   initialized CUDA; (b) ``-s 1`` with worker 1 SIGKILLed at its third
   batch (``kill_worker``): the survivor reconfigures and goes on alone,
   the relaunched worker rejoins, recaptures its gradient graph on
   ``cuda:0`` and trains; both end bitwise equal, each last epoch's
   batches those of a fresh ``NDArrayIter`` on shard (2, rank), K1, K2a
   and K2b launched by both incarnations; in both runs rank 0 holds its
   batch end once the membership changed until the relaunched process is
   back (so the cycle completes inside the fit); (c) a plain ``dist_sync``
   cluster whose rank 1 sleeps 0.5 s in its data iterator per batch after
   its second: rank 0's ``cluster_stats()`` holds both ranks and names
   rank 1 (stage data_wait), and ``request_server_trace()`` attributes
   pushes and pulls to both ranks and their last step. Printed: the
   seconds from the last step before each kill to the first step after
   it, the median host wall per fused step before and after each event,
   the launches per incarnation, each run's final perplexity and its
   parameters' largest difference from phase 21(b)'s. (c) runs with
   per-rank telemetry sinks (``MXNET_TELEMETRY_FILE``) and profiler
   traces (``MXNET_PROFILER_AUTOSTART``), and rank 0 runs ``mxtop --once``
   while it trains, for 25(d). Since PR 24 (c)'s cluster runs beside
   25(a)-(c), which read nothing of it and hold no time.

25. A7's compiler half. The whole run has ``MXNET_COMPILE_CACHE_DIR``
   set to a fresh directory, so phase 2's builds fill the cache. (a)
   Phase 5's fused fit (the LM at full width, 20 Adam steps) in two
   processes, with the default graph passes and with
   ``MXNET_GRAPH_PASSES=none``: the nodes eliminated and in fusion
   groups, the per-step metric and the final parameters against each
   other (rtol/atol 1e-5), the host wall per fused step both ways and
   K1/K2a/K2b launched 80 times in each; the LM built in the other
   operand order has the same optimized digest. (b) A process on a
   fresh copy of the package (an empty ``build/``) and the same cache:
   no ``nvcc`` runs, one cache hit per kernel source, no miss; it holds
   K1, K2a, K2b, K3, K4 and the wide route against their plain versions
   with phase 3's checks; the summed ``nvcc.*`` seconds cold and warm.
   Then one byte of the fastest source's artifact is flipped, and
   another fresh copy rebuilds that one library (one ``nvcc`` run), counts
   ``compile.cache_errors`` and passes that kernel's check. (c)
   ``mx.rtc`` ``y = x * 2 + 1`` on ``cuda:0`` bitwise equal to the CPU,
   with its registry row. (d) 24(c)'s run: ``mxtop --once`` showed both
   ranks with their step times; ``trace_merge`` writes one trace with the
   two worker lanes and the ``cluster`` lane, and rank 1's residual
   spread is below worker 0's wall per step.

26. A8a, the C boundary. The port's C library (``_capi.build``: the
   predict, NDArray, RecordIO and training C APIs, CPython embedded) is
   built and loaded into this process with ``ctypes``, and the clients
   under ``mxnet_tpu_torch/csrc/capi/clients`` are compiled against it.
   (a) Phase 5's trained LM as a checkpoint through ``MXPredCreate``,
   ``MXPredSetInput`` (token ids as float32), ``MXPredForward`` and
   ``MXPredGetOutput`` in this process: the probabilities bitwise equal
   to the Python ``Predictor`` on the card (created with no context: it
   must land on ``cuda:0``) and within ``OUT_REL_TOL`` of the
   ``Predictor`` under ``with mx.cpu():``; K1 launched once per layer and
   forward; ``MXPredCreatePartialOut`` of ``lm_head_output`` and a second
   create at batch 3, each bitwise equal to the Python ``Predictor``
   (``reshape`` for the second). (b) ``predict_client.c`` in a process of
   its own (no Python of its own; ``PYTHONPATH`` to the checkout, no
   ``MXNET_DEFAULT_CONTEXT``): its logits bitwise equal to (a)'s, its
   median predict call beside (a)'s. (c) ``lm_trainer.cpp`` over
   ``mxnet_cpp.hpp`` with ``Context("gpu", 0)``: in this process through
   ``ctypes``, 20 steps of forward, backward and ``MXExecutorSGDUpdate``
   with K1, K2a and K2b launched once per layer in every step, step 1's
   gradients bitwise equal to the port's Python ``Executor`` on the card,
   the loss falling; then as a process of its own, its step-1 gradients
   bitwise equal to the in-process run's. (d) ResNet-50 scoring at batch
   32 in float32 through ``MXPredForward`` (the client's process, and
   this process through ``ctypes``) and through the Python ``Predictor``:
   the scores bitwise equal, images/s of each. A C entry point that
   returns -1, a library that does not build and a predictor on the CPU
   each stop the run with ``MXGetLastError()``'s or the compiler's text.
   Since PR 24 (b)'s and (c)'s client processes start when the phase's
   inputs are written and run beside (a) and (c)'s in-process run, and
   27(a)'s cluster runs beside the whole phase: the calls and steps they
   time are printed, not held.

27. A7's last part, ``analysis/``: the engine dependency sanitizer and
   the lock witness in strict mode. (a) Phase 21(b)'s fused ``dist_sync``
   fit again (two workers on ``cuda:0``, the server on the host), every
   process with ``MXNET_ENGINE_SANITIZER=strict`` and
   ``MXNET_LOCK_WITNESS=strict``, each worker's witness seeded with the
   static lock graph of ``mxnet_tpu_torch/`` (``lockgraph.build``, built
   once by this process and handed to the workers as a JSON file): the
   launcher exits 0 with no ``EngineSanitizerError`` or
   ``LockWitnessError`` in any log, every ``engine.sanitizer.*`` counter
   and ``lock.order_violations`` 0 and ``engine.pushes`` above 0 in each
   worker, K1, K2a and K2b once per layer and step, the two workers'
   final parameters bitwise equal and within ``RESUME_TOL`` of 21(b)'s
   (the largest difference and the host wall per step beside 21(b)'s are
   printed). (b) The witness strict and seeded in this process over a
   ``ServingEngine`` at phase 4's width serving phase 4's prompts: the
   token streams equal phase 4's, K1 and K3 launched as in phase 4, the
   observed nesting edges a subset of the static ones,
   ``lock.held_seconds`` of the engine lock observed, no violation. (c)
   The negatives must raise: under ``ThreadedEngine`` a pushed fn writing
   a card ``NDArray`` whose var it declared const (``const_write`` at
   ``wait_for_var``), and two declared locks nested in an order the static
   graph lacks (``unknown_edge``).

28. A8b, the Python-free artifact. From the end of phase 2 a process at
   the lowest CPU priority builds the runtime
   ``libmxtpu_predict_native.so`` (``_predict_native.build``: ``g++`` over
   ``csrc/native_rt/``, linked against libtorch and the K1, K2a, K2b and
   K1-wide libraries); the phase waits for it and compiles the JAX
   package's two C clients, unchanged, against it. (a) Phase 5's trained LM exported with
   ``mx.export_predict_artifact`` at batch 4: ``predict_native_client.c``
   in a process of its own (``ldd`` of the runtime and that process's
   ``/proc/<pid>/maps`` name no libpython), and the same artifact through
   ``MXPredCreateFromFile`` (``dev_type`` 2) in this process with
   ``ctypes``: within 1e-6 of the Python ``Predictor`` on ``cuda:0``
   (bitwise expected; the largest difference printed) and of the client
   process, within ``OUT_REL_TOL`` of the ``Predictor`` under ``with
   mx.cpu():``; K1 once per layer and forward by the runtime's own
   counters, each forward or timed run read between a reset and a read,
   and a refused launch not counted; the median predict call beside 26(a)'s; a launch refused by
   K1 itself (``MXTPU_NATIVE_FAIL_KERNEL``) returns -1 with its error
   text. (b) The LM exported with ``mx.export_train_artifact`` (Adam at
   ``TRAIN_LR``, batch 32, phase 5's initial parameters):
   ``train_native_client.c`` for 8 steps (phase 5's 4 batches, cycled) in
   a process of its own, the same 8 steps through ``MXTrainNative*`` here
   beside the port's fused step (``SPMDTrainer`` on ``cuda:0``): step 1's parameters within 1e-6 of
   the fused step's, every later step within ``RESUME_TOL`` of the
   largest parameter (each step's largest difference printed), K1, K2a
   and K2b once per layer in every step (the compared, the loss and the
   timed steps, each read), the first batch's loss lower at
   its third visit than at its first, the client's
   ``MXTrainNativeSaveParams`` file equal to the in-process parameters;
   the eager C++ step's wall beside the fused step's. (c) ResNet-50
   scoring in float32 at batch 32 from a predict artifact, within 1e-5
   of the Python ``Predictor``, images/s of each. (d) Phase 8's head_dim
   512 LM from a predict artifact: K1's wide route once per layer, within
   1e-6 of the ``Predictor``. (e) A Dropout MLP's train artifact on the
   card (masks drawn there, seeded ``seed + t``): two trainers of one
   seed step to the same parameters, another seed to others. (f) The
   LM's train artifact (batch 32, phase 5's initial parameters) under
   each rule the runtime gained in PR 24 — NAG, AdaGrad, RMSProp plain
   and centered, AdaDelta, Ftrl — for 3 steps: ``train_native_client.c``
   in a process per rule (all at once) and the same steps through
   ``MXTrainNative*`` here against the port's fused step under the same
   rule: step 1 within 1e-6, later steps within ``RESUME_TOL`` of the
   largest parameter, the client's saved file bitwise the in-process
   trainer's, K1, K2a and K2b once per layer in every step read.
29. the repo tools on the card, each at its published widths and a cut
   depth: (a) ``tools/bench_pipeline.py``'s ladder (PIL and cv2 decode;
   ``ImageRecordIter`` into a null consumer at 1, 2 and 4 threads, the
   uint8 wire, the native stage on nvJPEG; the device feed and wire
   decode; ``Module.fit`` of a small conv net four ways, fused) at 224
   pixels, 256 images, 3 windows of 10 batches; (b) ``bandwidth`` over
   ResNet-50's gradients, ``local`` and ``device`` with two positions on
   ``cuda:0``, every pulled value the sum pushed; (c) ``baseline_matrix``
   DCGAN classic and fused (the whole iteration as one CUDA graph), 20
   steps each at batch 64: images/s of each, finite losses, the fused
   step's first replay bitwise equal to its eager step on the same ``z``
   (cuDNN deterministic) and two replays' ``z`` apart; (d) SSD-300 and
   the LSTM LM ``--quick``: finite losses, the perplexity falling; (e)
   ``gen_op_docs`` and ``gen_api_docs`` (each equal to the committed
   file) and ``c_api_coverage --check`` against the libraries phases 2
   and 28 built. Each sub-phase prints its wall.
30. A6d, the data-parallel fused step (``SPMDTrainer`` over a ``dp``
   mesh; on one card its positions are two on ``cuda:0``, each its own
   replica, the exchange real copies). (a) The zoo LM at ``TRAIN``'s
   widths, global batch 32, Adam: one fwd+bwd at dp 2 against dp 1 (the
   loss and every gradient within ``DP_GRAD_TOL`` of the largest, both
   positions holding the same summed gradient), then ``DP_LM_STEPS``
   steps of each, one captured CUDA graph apiece with K1, K2a and K2b
   launched 4 per position per step, the perplexities falling and within
   ``DP_PPL_TOL``; the step times beside each other. (b) ResNet-50 in
   bf16 at batch 32, SGD with momentum, 3 steps at dp 2 and dp 1: after
   the first step and after the third, the parameters and BatchNorm's
   moving statistics (global statistics: a sum over the positions inside
   the step) apart by no more than ``DP_RESNET_FACTOR`` times the dp 1
   run's distance from its float32 twin. (c) ``param_rules`` splitting the
   LM's FFN input weights over ``{"dp": 1, "tp": 2}``: 4 steps bitwise
   equal to the unsharded trainer's, each position holding half of
   each matched weight and of its Adam slots. (d) ``Module.fit`` over
   every card's context with ``kvstore='device'`` against one card's,
   only where two or more cards are visible (one card: "30(d) not run"),
   held to (a)'s yardstick: one fwd+bwd over the cards against dp 1, and
   the fits' perplexities batch by batch within ``DP_PPL_TOL``.
31. A6d's remainder, the data-parallel train artifact
   (``export_train_artifact(num_devices=N)``; the Python-free runtime's
   step over N positions, all on ``cuda:0`` here, C41), and
   ``Executor.reshape``. (a) The zoo LM at full width, batch 32 x 128,
   Adam, exported at dp 2 and at dp 1 and trained by the runtime in this
   process for ``DPA_STEPS`` steps over phase 5's 4 batches, cycled: each
   dp 2 step within ``DPA_STEP_TOL`` of each parameter's largest of the
   port's ``SPMDTrainer`` over a dp 2 mesh on the same batches, the first
   step's loss dp 1's, the perplexities within ``DP_PPL_TOL`` of dp 1's,
   K1/K2a/K2b 8 per dp 2 step from the runtime's own counters, read every
   step; both step times. (b) ResNet-50 bf16 at batch 32 exported at dp 2
   from 30(b)'s start and trained 2 SGD steps on 30(b)'s inputs: the
   parameters and moving statistics against 30(b)'s ``SPMDTrainer`` at dp
   2 after its second step, within ``DP_RESNET_FACTOR`` times 30(b)'s dp 1
   bf16 run's distance from float32 (BatchNorm's global form at full
   width). (c) The JAX package's C training client, unchanged, trains a dp
   8 MLP artifact with its positions on ``cuda:0``: the loss below half its
   first. (d) The LM executor bound at batch 32, reshaped to 16 and 8: the
   parameters the same arrays and storage, each forward through K1 once
   per layer, the logits within ``LOGIT_TOL`` of the CPU's.

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


# a phase's header carries the seconds since the script started
_T0 = time.time()


def log(*a):
    if a and str(a[0]).startswith("== "):
        a = a + ("[%.1f s in]" % (time.time() - _T0),)
    print(*a, flush=True)


def timed(fn, *args):
    """(``fn(*args)``, the seconds it took)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


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
                                   "steps": steps,
                                   "streams": [list(r.generated) for r in reqs]}


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
LSTM_EPOCHS = 2
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


def start_tool(args):
    """``python -m mxnet_tpu_torch.tools.<args>`` started in a process of
    its own from the checkout's root: (the process, its start time).
    Phases 19 and 20 start their tool runs before correctness checks that
    time nothing and collect them after (:func:`finish_tool`)."""
    import os

    return (subprocess.Popen(
        [sys.executable, "-m"] + list(args), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))), time.perf_counter())


def finish_tool(started, what):
    """The tool run's JSON record (its last line) and wall seconds; a
    failed run stops the phase with its error text."""
    proc, t0 = started
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, "%s failed: %s" % (what, err[-2000:]))
    return json.loads(out.strip().splitlines()[-1]), time.perf_counter() - t0


def run_ssd_tool(started):
    """19(d): tools/train_ssd.py --evaluate at the example's defaults, as a
    subprocess (started by the phase after (a)); its JSON record, mAP
    finite."""
    rec, wall = finish_tool(started, "tools/train_ssd.py")
    log("  tools/train_ssd.py --evaluate (%.1f s, beside (b), (c) and (e)): %s"
        % (wall, json.dumps(rec)))
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
    # (d)'s tool run, beside the correctness checks (b), (c) and (e)
    ssd_tool = start_tool(["mxnet_tpu_torch.tools.train_ssd", "--evaluate"])
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
    log("  (e) Custom and SequentialModule, card vs CPU")
    custom_and_sequential_card_vs_cpu(mx)
    log("  (d) tools/train_ssd.py --evaluate at the example's defaults")
    run_ssd_tool(ssd_tool)


# ---------------------------------------------------------------- phase 20
AG_SHAPE = (32, 4, 128, 64)   # K1/K2a/K2b's training shape (phase 11)
MHA_BATCH, MHA_SEQ = 32, 128  # one attention block of phase 5's LM
AG_OUT_TOL = F32_TOL          # phase 3's float32 flash tolerance
# C13's bound on the native decoder against PIL (libjpeg), per RGB channel
# over 32 records: nvJPEG on the card (no libjpeg there) rounds its IDCT and
# chroma upsampling otherwise. An H100 run saw at most 20 levels and a
# mean of 1.4563 over all channels (PERF.md §6); the bounds leave a fifth
# more
DECODE_MAX_DIFF = 24
DECODE_MEAN_DIFF = 2.5
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
    forward and backward (on card tensors too), not the kernels; so does
    the ring attention's float32 backward."""

    NAMES = ("flash_attention_forward", "flash_attention_backward",
             "flash_attention_backward_f32")

    def __init__(self, A):
        self.A = A

    def __enter__(self):
        A = self.A
        self.saved = [getattr(A, n) for n in self.NAMES]
        A.flash_attention_forward = lambda q, k, v, causal=False, sm_scale=None: \
            A._flash_forward_plain(q, k, v, causal, A._scale(sm_scale, q.shape[-1]))
        A.flash_attention_backward = lambda q, k, v, out, lse, g, causal=False, \
            sm_scale=None: A._flash_backward_plain(
                q, k, v, out, lse, g, causal, A._scale(sm_scale, q.shape[-1]))
        A.flash_attention_backward_f32 = lambda q, k, v, out, lse, g, \
            causal=False, sm_scale=None: A._flash_backward_plain(
                q, k, v, out, lse, g, causal, A._scale(sm_scale, q.shape[-1]),
                keep_f32=True)

    def __exit__(self, *exc):
        for n, f in zip(self.NAMES, self.saved):
            setattr(self.A, n, f)


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
    records, per RGB channel: (max abs diffs, mean abs diffs)."""
    import ctypes
    import io as _io

    from PIL import Image

    from mxnet_tpu_torch import _native

    lib = _native.load()
    rec = mx.recordio.MXRecordIO(rec_path, "r")
    worst, mean = np.zeros(3, np.int64), []
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
        diff = np.abs(got - want).reshape(-1, 3)
        worst = np.maximum(worst, diff.max(axis=0))
        mean.append(diff.mean(axis=0))
    rec.close()
    return [int(w) for w in worst], [float(m) for m in np.mean(mean, axis=0)]


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
    from mxnet_tpu_torch import _native

    check(rec["data"]["decoder"] == _native.decoder(),
          "the fit's record does not name the native stage's decoder")
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


def run_data_phase(mx, A, build, card, rn_fused, native_s):
    """Phase 20 (``native_s``: phase 2's build of the native host stage);
    returns the kernels' launches of (a)'s recorded runs."""
    import os
    import tempfile

    log("  (a) contrib.autograd over the flash kernels at full width")
    launches = autograd_phase(mx, A, build)
    log("  (b) the pipeline alone")
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    lib_decoder = _native.decoder()
    log("  decoder: %s (the native stage, built in phase 2 in %.2f s, "
        "loaded in %.2f s); the Python pipeline decodes with %s"
        % (lib_decoder, native_s, time.perf_counter() - t0,
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
        log("  %s against PIL on 32 records, per R/G/B channel: max abs pixel "
            "diff %s (bound %d), mean %s (bound %.1f)"
            % (lib_decoder, worst, DECODE_MAX_DIFF,
               ["%.4f" % m for m in mean], DECODE_MEAN_DIFF))
        check(max(worst) <= DECODE_MAX_DIFF and max(mean) <= DECODE_MEAN_DIFF,
              "the native decoder's pixels are further from PIL's than the "
              "stated bound (C13)")
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
    with tempfile.TemporaryDirectory() as tmp:
        # (e)'s tool run, beside the correctness checks of (d)
        det_records(mx, os.path.join(tmp, "train.rec"), SSD_REC_IMAGES, 1)
        ssd_tool = start_tool(
            ["mxnet_tpu_torch.tools.train_ssd", "--data-dir", tmp,
             "--batch-size", str(SSD_REC_BATCH), "--num-epochs", "1",
             "--data-nthreads", str(PIPE_THREADS)])
        log("  (d) the uint8 wire: the op and the fused step")
        wire_checks(mx, A)
        log("  (e) tools/train_ssd.py --data-dir over ImageDetRecordIter "
            "records")
        rec, wall = finish_tool(ssd_tool, "tools/train_ssd.py --data-dir")
        log("  tools/train_ssd.py --data-dir (%.1f s, beside (d)): %s"
            % (wall, json.dumps(rec)))
        check(rec["data"] == "ImageDetRecordIter" and rec["steps"] ==
              SSD_REC_IMAGES // SSD_REC_BATCH, "train_ssd did not read the records")
        check(all(np.isfinite(v) for v in rec["train"].values()),
              "train_ssd from records: non-finite loss")
    return launches


# ------------------------------- mx.kv and the example scripts (phase 21)
# (b): each worker of the cluster trains on every other one of these
# sequences (its shard), 4 batches of 32 per epoch
DIST_SEQS = 256
DIST_BATCH = 32
# two epochs: phase 24's faults fall in the first, and the second runs on
# the membership the fault left (its batches are checked)
DIST_EPOCHS = 2
# each cluster's own limit: the launcher's process group is killed past it
DIST_TIMEOUT = 420
# (c): train_mnist's epochs under the launcher, and the seed of every
# process's draws (the initial weights, each worker's shuffle). The example
# itself is unseeded, and at its lr 0.1 and momentum 0.9 some draws diverge
# in the second epoch in the JAX package and in the port alike, on the same
# draws: a fixed draw makes the check below a check of the port, not of the
# draw
MNIST_EPOCHS = 2
MNIST_SEED = 0


def example_source(name):
    """``examples/<name>.py`` with only its import lines pointed at the
    port (``mxnet_tpu`` -> ``mxnet_tpu_torch``)."""
    import os
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name + ".py")
    out = []
    with open(path) as f:
        for line in f:
            if (re.match(r"\s*(import|from)\s+mxnet_tpu\b", line)
                    or 'import_module("mxnet_tpu' in line):
                line = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", line)
            out.append(line)
    return path, "".join(out)


def exec_example(name, argv, seed=None):
    """Run ``examples/<name>.py`` from its source (import lines rewritten)
    as ``__main__`` with ``argv``; a launcher's worker and server both run
    this (the server serves inside the ``import``). ``seed``, when given,
    seeds numpy's global generator and ``mx.random`` first, as a user's
    ``mx.random.seed`` at the top of the script would."""
    if seed is not None:
        np.random.seed(seed)
        import mxnet_tpu_torch as mx

        mx.random.seed(seed)
    path, src = example_source(name)
    sys.argv = [path] + list(argv)
    exec(compile(src, path, "exec"), {"__name__": "__main__", "__file__": path})


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_cluster(command, env_extra, what, servers=1, launch_args=()):
    """``tools/launch.py -n 2 -s <servers> <command>`` in its own process
    group, killed past ``DIST_TIMEOUT``: returns (stdout, stderr); a failed
    or hung cluster fails the phase. Each server id must write, on exit,
    one line saying that it never initialized CUDA (a killed server
    writes none; its relaunch does)."""
    import os
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    cmd = ([sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
            "2", "-s", str(servers), "--port", str(_free_port())]
           + list(launch_args) + command)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        out, err = proc.communicate()
        check(False, "%s: the cluster hung past %d s: %s" % (what, DIST_TIMEOUT,
                                                             err[-3000:]))
    log("  %s: launcher exit %d after %.1f s" % (what, proc.returncode,
                                                 time.perf_counter() - t0))
    check(proc.returncode == 0, "%s: the cluster failed: %s" % (what, err[-3000:]))
    lines = [l for l in err.splitlines()
             if l.startswith("kvstore-server") and ": stopped;" in l]
    for line in lines:
        log("  %s" % line)
    check(sorted(l.split(":")[0] for l in lines)
          == ["kvstore-server %d" % i for i in range(servers)]
          and all(l.endswith("cuda initialized: False") for l in lines),
          "%s: the servers did not each report that they kept off CUDA"
          % what)
    return out, err


def dist_lm_worker():
    """One process of phase 21(b), started by ``tools/launch.py`` (a server
    serves inside the ``import`` and exits there): the zoo Transformer-LM
    at phase 5's width trained by ``Module.fit`` with ``kvstore=
    'dist_sync'`` on ``cuda:0``, fused unless ``MXNET_MODULE_NO_FUSED=1``;
    writes its final parameters and a JSON record to ``SMOKE_OUT``."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build as build

    out_dir = os.environ["SMOKE_OUT"]
    # phase 27(a): the same fit with the sanitizer and the witness strict
    # (the launcher's environment) and the witness seeded with the static
    # lock graph the parent built (a JSON list of edges)
    static = os.environ.get("SMOKE_STATIC_EDGES")
    sanitized = static is not None
    if sanitized:
        from mxnet_tpu_torch import telemetry
        from mxnet_tpu_torch.analysis import witness

        with open(static) as f:
            witness.seed_static(json.load(f))
        telemetry.enable()
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    X, Y = lm_stream(DIST_SEQS)
    shard = slice(rank, None, kv.num_workers)
    it = mx.io.NDArrayIter(X[shard], Y[shard], batch_size=DIST_BATCH,
                           shuffle=False)
    mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=None)
    stamps, ppl = [], []

    def batch_end(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # each worker draws other initial weights: the servers keep rank 0's
    mod.fit(it, num_epoch=DIST_EPOCHS, kvstore=kv, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(rank)),
            eval_metric=metric, batch_end_callback=batch_end,
            epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
    per_step = np.diff([t0] + stamps)
    tr = mod._fused.trainer if mod._fused is not None else None
    rec = {"rank": rank, "fused": mod._fused is not None, "ppl": ppl,
           "steps": len(stamps), "step_s": float(np.median(per_step[2:])),
           "first_steps_s": [float(x) for x in per_step[:2]],
           "launches": {n: k.launches for n, k in build.KERNELS.items()},
           "captures": None if tr is None else tr.captures,
           "replays": None if tr is None else tr.replays,
           "update_on_kvstore": mod._update_on_kvstore,
           "context": str(torch.device(mod._context[0]))}
    params = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    tag = "fused" if rec["fused"] else "classic"
    if sanitized:
        from mxnet_tpu_torch import telemetry
        from mxnet_tpu_torch.analysis import sanitizer, witness

        tag = "sanitized"
        rec["modes"] = [sanitizer.mode(), witness.mode()]
        rec["counters"] = {n: telemetry.counter(n).value for n in (
            SANITIZER_COUNTERS + ("lock.order_violations", "engine.pushes"))}
    np.savez(os.path.join(out_dir, "%s-%d.npz" % (tag, rank)), **params)
    with open(os.path.join(out_dir, "%s-%d.json" % (tag, rank)), "w") as f:
        json.dump(rec, f)
    kv.barrier()
    if rank == 0:
        kv._stop_servers()


def run_train_lm_example(mx, build):
    """21(a): ``examples/train_lm.py`` at its defaults, in this process."""
    import torch as _torch

    auto = mx.context.auto()
    check(auto == mx.tpu(0) and _torch.device(auto) == _torch.device("cuda", 0),
          "mx.context.auto() returned %r" % (auto,))
    log("  mx.context.auto() = %r -> %s; mx.current_context() = %r"
        % (auto, _torch.device(auto), mx.current_context()))
    fits = []
    fit = mx.mod.Module.fit

    def recording_fit(self, *a, **kw):
        metric = kw["eval_metric"]
        ppl = []
        kw["epoch_end_callback"] = [lambda *x: ppl.append(metric.get()[1])]
        fits.append((self, ppl))
        return fit(self, *a, **kw)

    mx.mod.Module.fit = recording_fit
    argv = sys.argv
    np.random.seed(0)
    _torch.manual_seed(0)
    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        exec_example("train_lm", [])
    finally:
        del mx.mod.Module.fit
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in build.KERNELS.items()}
    check(len(fits) == 1, "train_lm did not fit one module")
    mod, ppl = fits[0]
    tr = mod._fused.trainer if mod._fused is not None else None
    check(tr is not None and tr.captures == 1,
          "train_lm's fit did not run one captured graph")
    steps = tr.replays + 1
    L = 4  # the example's default --num-layers
    log("  examples/train_lm.py (defaults: vocab 64, 4 layers, d 256, batch "
        "32, seq 128, 5 epochs) on %s: %d steps in %.2f s (%.5f s per step, "
        "start-up included); perplexity per epoch %s; launches %s"
        % (mod._context[0], steps, wall, wall / steps,
           ["%.3f" % p for p in ppl], launches))
    # the module keeps its Context (tpu(0)); the device torch reads from it
    check(str(torch.device(mod._context[0])) == "cuda:0",
          "train_lm ran on %s" % mod._context[0])
    check(len(ppl) == 5 and all(math.isfinite(p) for p in ppl)
          and ppl[-1] < ppl[0], "train_lm's perplexity did not fall")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches[name] == L * steps, "train_lm: %s launched %d times "
              "in %d steps" % (name, launches[name], steps))
    return launches


def run_dist_phase(mx, build, card, t_counts):
    """Phase 21; returns the kernels' launches of its main paths, worker
    0's final parameters of the fused dist_sync fit and its host wall per
    step."""
    import os
    import tempfile

    log("  (a) examples/train_lm.py through mx.tpu() and the fused step")
    launches = run_train_lm_example(mx, build)
    log("  (b) tools/launch.py -n 2 -s 1: two workers on cuda:0 and a server "
        "on the host train the LM at phase 5's width, kvstore='dist_sync'")
    L = TRAIN["num_layers"]
    recs, params = {}, {}
    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(3) as pool:
        # (b)'s two clusters and (c)'s run at once: nothing in one reads
        # another, and each mostly waits for its processes to start
        jobs = {tag: pool.submit(
            run_cluster, [sys.executable, "-c",
                          "import chip_smoke; chip_smoke.dist_lm_worker()"],
            dict(extra, SMOKE_OUT=tmp), "dist_sync %s" % tag)
            for tag, extra in (("fused", {}),
                               ("classic", {"MXNET_MODULE_NO_FUSED": "1"}))}
        mnist = pool.submit(
            run_cluster,
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.exec_example('train_mnist', sys.argv[1:], %d)"
             % MNIST_SEED,
             "--kv-store", "dist_sync", "--num-epochs", str(MNIST_EPOCHS)],
            {}, "train_mnist dist_sync")
        for tag, job in jobs.items():
            job.result()
            for r in (0, 1):
                with open(os.path.join(tmp, "%s-%d.json" % (tag, r))) as f:
                    recs[tag, r] = json.load(f)
                with np.load(os.path.join(tmp, "%s-%d.npz" % (tag, r))) as z:
                    params[tag, r] = {k: z[k] for k in z.files}
    steps = DIST_EPOCHS * (DIST_SEQS // 2 // DIST_BATCH)
    for (tag, r), rec in sorted(recs.items()):
        log("  [%s, worker %d] %s: %d steps, perplexity per epoch %s, host wall "
            "per step %.5f s (median after the first two: %s), captures %s, "
            "replays %s, launches %s"
            % (tag, r, rec["context"], rec["steps"],
               ["%.3f" % p for p in rec["ppl"]], rec["step_s"],
               ["%.3f" % x for x in rec["first_steps_s"]], rec["captures"],
               rec["replays"], {n: rec["launches"][n] for n in
                                ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}))
        check(rec["context"] == "cuda:0" and rec["update_on_kvstore"],
              "worker %d did not train on cuda:0 with the servers' updates" % r)
        check(rec["fused"] == (tag == "fused"), "%s worker %d took the other "
              "path" % (tag, r))
        check(rec["steps"] == steps, "%s worker %d ran %d steps"
              % (tag, r, rec["steps"]))
        check(all(math.isfinite(p) for p in rec["ppl"])
              and rec["ppl"][-1] < rec["ppl"][0],
              "%s worker %d: the perplexity did not fall" % (tag, r))
        if tag == "fused":
            check(rec["captures"] == 1 and rec["replays"] == steps - 1,
                  "fused worker %d did not replay one gradient graph" % r)
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            n = rec["launches"][name]
            check(n == L * steps, "%s worker %d: %s launched %d times in %d "
                  "steps" % (tag, r, name, n, steps))
            launches[name] += n
    for tag in ("fused", "classic"):
        differ = [k for k in params[tag, 0]
                  if not np.array_equal(params[tag, 0][k], params[tag, 1][k])]
        log("  [%s] the two workers' final parameters: %s"
            % (tag, "bitwise equal" if not differ else "differ in %s" % differ))
        check(not differ, "%s: the workers' parameters differ" % tag)
    fused_against_classic(params["fused", 0], params["classic", 0],
                          "of the dist_sync LM after %d steps" % steps)
    f_s, c_s = recs["fused", 0]["step_s"], recs["classic", 0]["step_s"]
    log("  host wall per step (%s): dist_sync fused %.5f s, dist_sync classic "
        "%.5f s, phase 5's fused local %.5f s (dist_sync fused / local "
        "%.2fx)" % (card, f_s, c_s, t_counts["step_s"], f_s / t_counts["step_s"]))
    log("  (c) examples/train_mnist.py --kv-store dist_sync under the "
        "launcher (run beside (b)'s clusters)")
    _, err = mnist.result()
    acc = [float(l.rsplit("=", 1)[1]) for l in err.splitlines()
           if "Validation-accuracy=" in l]
    log("  train_mnist validation accuracy per epoch and worker: %s" % acc)
    check(len(acc) == 2 * MNIST_EPOCHS and all(math.isfinite(a) for a in acc)
          and min(acc[-2:]) > 0.5, "train_mnist under dist_sync did not learn")
    return launches, params["fused", 0], f_s


# --------------------------------------- model parallelism (phase 22)
# (a): ring and Ulysses attention over 4 positions on cuda:0, float32,
# causal, against the whole sequence's flash call and the plain versions;
# the JAX tests' tolerances, of the largest value
SP_SHAPE = (2, 8, 4096, 64)
SP_POSITIONS = 4
SP_OUT_TOL = 2e-5
SP_GRAD_TOL = 1e-4
# (b): ParallelLMModule.fit at the zoo LM's full width, each mode 6 steps
PLM = dict(vocab_size=32000, num_layers=4, model_dim=256, num_heads=4,
           ffn_dim=1024, seq_len=1024)
PLM_BATCH = 8
PLM_STEPS = 6
PLM_LR = 3e-3
PLM_EXPERTS = 8
# sp and pp against dense: the JAX package's CPU test's rtol on the losses
PLM_LOSS_RTOL = 2e-4
# (c): examples/model_parallel_lstm.py's defaults; card and host against
# the card alone after 5 SGD steps, of the largest value
MPL_ARGS = dict(seq_len=8, num_hidden=64, num_layers=4, vocab=128,
                num_groups=2)
MPL_BATCH = 16
MPL_STEPS = 5
MPL_LR = 0.5
MPL_TOL = 1e-4
# (d): two contexts on one card against one, classic. The first batch's
# probabilities (the merged outputs of the two executors against the one
# executor's), phase 6's 1e-5 of the largest; then 4 SGD steps, the
# parameters within 1e-3 of the largest. The gradients are not held:
# each executor's GEMMs round the FFN's pre-activations in their own
# order, and a ReLU input within rounding of 0 that falls the other way
# moves its unit's gradient by ~1e-2 (C6; 4.4e-4 of the largest gradient
# on an H100). The LM's SoftmaxOutput gradients are not normalized
# (pos_embed's reach ~22) and each step feeds the last one's rounding
# back: on an H100 the two fits part by 1.7e-4 of the largest parameter
# after 4 steps at this lr, while each is bitwise reproducible; a lost
# or doubled executor moves them by ~0.1
MC_SGD = {"learning_rate": 0.005}
MC_OUT_TOL = OUT_REL_TOL
MC_PARAM_TOL = 1e-3


def _counts(build):
    return {n: k.launches for n, k in build.KERNELS.items()}


def _zero(build):
    for k in build.KERNELS.values():
        k.launches = 0


def _attn_run(fn, q, k, v, g):
    """Output and q/k/v gradients of ``fn(q, k, v)`` with head gradient g."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return [out.detach()] + list(grads)


def _of_largest(got, want):
    return float((got - want).abs().max() / want.abs().max())


def sequence_parallel_attention(mx, A, build, card):
    """22(a); returns the kernels' launches of one ring and one Ulysses
    forward and backward."""
    mesh = mx.parallel.build_mesh({"sp": SP_POSITIONS})
    log("  mesh: %r" % (mesh,))
    check(mesh.device_list == [torch.device("cuda", 0)] * SP_POSITIONS,
          "the mesh is not %d positions on cuda:0" % SP_POSITIONS)
    n = SP_POSITIONS
    rng = np.random.RandomState(22)
    q, k, v, g = (torch.tensor(rng.standard_normal(SP_SHAPE).astype(np.float32),
                               device="cuda") for _ in range(4))
    whole = _attn_run(lambda a, b, c: A.flash_attention(a, b, c, True),
                      q, k, v, g)
    launches = {}
    for name, fn, per in (
            ("ring", lambda a, b, c: mx.parallel.ring_attention(
                a, b, c, mesh, causal=True), n * (n + 1) // 2),
            ("ulysses", lambda a, b, c: mx.parallel.ulysses_attention(
                a, b, c, mesh, causal=True), n)):
        _zero(build)
        got = _attn_run(fn, q, k, v, g)
        torch.cuda.synchronize()
        counts = _counts(build)
        with plain_flash(A):
            plain = _attn_run(fn, q, k, v, g)
        errs = [_of_largest(a, b) for a, b in zip(got, whole)]
        perrs = [_of_largest(a, b) for a, b in zip(got, plain)]
        log("  %s attention %s f32 causal over %d positions: out, dq, dk, dv "
            "against the whole sequence's flash_attention %s, against its "
            "plain versions %s (of the largest; tolerances %.0e, %.0e); "
            "launches per forward and backward: flash_fwd %d, flash_bwd_dkv %d,"
            " flash_bwd_dq %d"
            % (name, SP_SHAPE, n, ["%.3e" % e for e in errs],
               ["%.3e" % e for e in perrs], SP_OUT_TOL, SP_GRAD_TOL,
               counts["flash_fwd"], counts["flash_bwd_dkv"],
               counts["flash_bwd_dq"]))
        for es in (errs, perrs):
            check(es[0] <= SP_OUT_TOL and max(es[1:]) <= SP_GRAD_TOL,
                  "%s attention disagrees" % name)
        for kname in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            check(counts[kname] == per, "%s: %s launched %d times, not %d"
                  % (name, kname, counts[kname], per))
        launches[name] = counts
    times = {}
    for name, fn in (("whole sequence", lambda a, b, c: A.flash_attention(
            a, b, c, True)),
                     ("ring", lambda a, b, c: mx.parallel.ring_attention(
                         a, b, c, mesh, causal=True)),
                     ("ulysses", lambda a, b, c: mx.parallel.ulysses_attention(
                         a, b, c, mesh, causal=True))):
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))

        def fwd_bwd():
            torch.autograd.grad(fn(qq, kk, vv), (qq, kk, vv), g)

        times[name] = device_ms(fwd_bwd, n=10)
    log("  device ms per forward + backward at %s (%s): whole-sequence K1 + "
        "K2 %.4f, ring %.4f (%.2fx), Ulysses %.4f (%.2fx)"
        % (SP_SHAPE, card, times["whole sequence"], times["ring"],
           times["ring"] / times["whole sequence"], times["ulysses"],
           times["ulysses"] / times["whole sequence"]))
    return {kn: launches["ring"][kn] + launches["ulysses"][kn]
            for kn in launches["ring"]}


def _example_names(name):
    """The module-level names of ``examples/<name>.py`` (its source run
    with its import lines rewritten, but not as ``__main__``)."""
    path, src = example_source(name)
    ns = {"__name__": name, "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


def _plm_iter(mx):
    """PLM_STEPS batches of ``examples/train_lm_parallel.py``'s
    ``synthetic_corpus`` at PLM's width (one seeded batch of tokens rolled
    by one more position each step; float32 token ids, exact below
    2^24)."""
    corpus = _example_names("train_lm_parallel")["synthetic_corpus"](
        PLM["vocab_size"], PLM_BATCH, PLM["seq_len"], PLM_STEPS)
    X, Y = (np.concatenate(a).astype(np.float32) for a in zip(*corpus))
    return mx.io.NDArrayIter(X, Y, batch_size=PLM_BATCH, shuffle=False)


def parallel_lm_fits(mx, build, card):
    """22(b): ParallelLMModule.fit in each mode; returns sp's launches."""
    from mxnet_tpu_torch.parallel.lm import init_lm_params

    res = {}
    for mode, kw in (("dense", {}), ("sp", dict(num_devices=4)),
                     ("pp", dict(num_devices=4, microbatches=4)),
                     ("ep", dict(num_devices=4, num_experts=PLM_EXPERTS,
                                 capacity_factor=2.0))):
        mod = mx.mod.ParallelLMModule(mode=mode, seed=0, **PLM, **kw)
        params = init_lm_params(0, num_experts=kw.get("num_experts", 0), **PLM)
        losses, stamps = [], []

        def batch_end(_p, mod=mod, losses=losses, stamps=stamps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses.append(mod.loss)

        _zero(build)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # earlier phases still hold memory: the fit's peak above it
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mod.fit(_plm_iter(mx), num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": PLM_LR}, arg_params=params,
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                batch_end_callback=[batch_end])
        torch.cuda.synchronize()
        counts = _counts(build)
        walls = np.diff([t0] + stamps)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        mesh = mod._mesh
        log("  [%s%s] %d steps of %d x %d tokens: losses %s; host wall per "
            "step %.5f s (median after the first; first %.3f s); peak memory "
            "%.3f GB above the fit's start; launches flash_fwd %d, flash_bwd_dkv %d, flash_bwd_dq "
            "%d (%s)"
            % (mode, "" if mesh is None else " over %s" % (mesh,), len(losses),
               PLM_BATCH, PLM["seq_len"], ["%.5f" % x for x in losses],
               float(np.median(walls[1:])), walls[0], peak,
               counts["flash_fwd"], counts["flash_bwd_dkv"],
               counts["flash_bwd_dq"], card))
        check(len(losses) == PLM_STEPS and all(math.isfinite(x) for x in losses),
              "%s: a loss is missing or not finite" % mode)
        check(losses[-1] < losses[0], "%s: the loss did not fall" % mode)
        L, n = PLM["num_layers"], 4
        if mode == "sp":
            # each step's forward and the metric's forward after it run the
            # ring: n(n+1)/2 K1 per layer each; the backward as many K2a/K2b
            per = n * (n + 1) // 2 * L * PLM_STEPS
            check(counts["flash_fwd"] == 2 * per
                  and counts["flash_bwd_dkv"] == per
                  and counts["flash_bwd_dq"] == per,
                  "sp launched %s, not %d K1 and %d K2a/K2b" % (
                      counts, 2 * per, per))
            sp_counts = counts
        else:
            check(not any(counts.values()), "%s launched a port kernel: %s"
                  % (mode, counts))
        res[mode] = losses
    for mode in ("sp", "pp"):
        worst = max(abs(a - b) / abs(b) for a, b in zip(res[mode], res["dense"]))
        log("  %s against dense: worst relative loss difference %.3e (tol %.0e)"
            % (mode, worst, PLM_LOSS_RTOL))
        check(worst <= PLM_LOSS_RTOL, "%s's losses are not dense's" % mode)
    return sp_counts


def _mpl_run(mx, net, group2ctx):
    """The example's loop: seeded values, MPL_STEPS of forward, backward and
    SGD on one executor; returns (executor, outputs, params, transfers per
    step)."""
    ex = net.simple_bind(ctx=mx.tpu(0), grad_req="write", group2ctx=group2ctx,
                         data=(MPL_BATCH, MPL_ARGS["seq_len"]),
                         softmax_label=(MPL_BATCH, MPL_ARGS["seq_len"]))
    rng = np.random.RandomState(0)
    for name in sorted(ex.arg_dict):
        if name not in ("data", "softmax_label"):
            arr = ex.arg_dict[name]
            arr[:] = (rng.rand(*arr.shape) * 0.1).astype(np.float32)
    shape = (MPL_BATCH, MPL_ARGS["seq_len"])
    ex.arg_dict["data"][:] = rng.randint(0, MPL_ARGS["vocab"], shape).astype(np.float32)
    ex.arg_dict["softmax_label"][:] = rng.randint(
        0, MPL_ARGS["vocab"], shape).astype(np.float32)
    outs, per_step = [], []
    for _ in range(MPL_STEPS):
        before = ex._placed.transfer_count if ex._placed is not None else 0
        ex.forward(is_train=True)
        ex.backward()
        for name, arr in ex.arg_dict.items():
            g = ex.grad_dict.get(name)
            if g is not None and name not in ("data", "softmax_label"):
                arr[:] = arr - MPL_LR * g
        outs.append(ex.outputs[0].asnumpy())
        if ex._placed is not None:
            per_step.append(ex._placed.transfer_count - before)
    params = {n: a.asnumpy() for n, a in ex.arg_dict.items()
              if n not in ("data", "softmax_label")}
    return ex, outs, params, per_step


def group2ctx_card_and_host(mx, card):
    """22(c): the example's LSTM with its layer groups alternately on the
    card and the host, against the same graph on the card alone."""
    net = _example_names("model_parallel_lstm")["build"](**MPL_ARGS)
    g2c = {"layer%d" % g: (mx.tpu(0) if g % 2 == 0 else mx.cpu(0))
           for g in range(MPL_ARGS["num_groups"])}
    g2c["out"] = mx.tpu(0)
    ex, outs, params, per_step = _mpl_run(mx, net, g2c)
    _, ref_outs, ref_params, _ = _mpl_run(mx, net, None)
    placed = ex._placed
    check(placed is not None, "group2ctx over the card and the host did not "
          "place the graph")
    where = {}
    for name, ctx in sorted(placed.arg_ctx.items()):
        dev = ex.arg_dict[name].data.device
        check(dev == torch.device(ctx), "%s lives on %s, its group's context "
              "is %s" % (name, dev, ctx))
        where.setdefault(str(torch.device(ctx)), []).append(name)
    out_err = max(_of_largest(torch.tensor(a), torch.tensor(b))
                  for a, b in zip(outs, ref_outs))
    par_err = max(rel(params, ref_params).values())
    log("  model_parallel_lstm's net (%s, batch %d) with layer groups on %s: "
        "%d segments %s; parameters by device %s; transfers per step %s; "
        "after %d SGD steps against cuda:0 alone: outputs %.3e, parameters "
        "%.3e of the largest (tol %.0e) (%s)"
        % (MPL_ARGS, MPL_BATCH, {g: str(c) for g, c in g2c.items()},
           len(placed.segments), [str(s.ctx) for s in placed.segments],
           {d: len(v) for d, v in where.items()}, per_step, MPL_STEPS,
           out_err, par_err, MPL_TOL, card))
    check(len(where) == 2, "the parameters are not split between the card "
          "and the host")
    check(out_err <= MPL_TOL and par_err <= MPL_TOL,
          "the card-and-host run disagrees with the card alone")


def two_contexts_one_card(mx, build, card):
    """22(d): the zoo LM's classic fit with two contexts on the card
    against one; returns the two-context run's launches."""
    X, Y = lm_stream(128, cfg=TRAIN)
    res = {}
    for tag, ctx in (("one context", [mx.tpu(0)]),
                     ("two contexts", [mx.tpu(0), mx.tpu(0)])):
        it = mx.io.NDArrayIter(X, Y, batch_size=32, shuffle=False)
        mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mx.init.Xavier(rng=torch.Generator().manual_seed(0)))
        mod.forward(next(iter(it)), is_train=False)
        probs = mod.get_outputs()[0].data.clone()
        it.reset()
        stamps = []
        _zero(build)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_fused():
            mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=MC_SGD,
                    eval_metric=mx.metric.Perplexity(ignore_label=None),
                    batch_end_callback=lambda _p: (
                        torch.cuda.synchronize(),
                        stamps.append(time.perf_counter())))
        counts = _counts(build)
        execs = len(mod._exec_group.execs)
        steps = len(stamps)
        log("  [%s] %d executors on %s, slices %s, kvstore %s: %d classic steps, "
            "host wall per step %.5f s (median after the first); launches "
            "flash_fwd %d, flash_bwd_dkv %d, flash_bwd_dq %d (%s)"
            % (tag, execs, [str(c) for c in ctx], mod._exec_group.slices,
               mod._kvstore and mod._kvstore.type, steps,
               float(np.median(np.diff([t0] + stamps)[1:])),
               counts["flash_fwd"], counts["flash_bwd_dkv"],
               counts["flash_bwd_dq"], card))
        check(mod._fused is None and execs == len(ctx) and steps == 4,
              "%s: not %d classic executors over 4 steps" % (tag, len(ctx)))
        for kname in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            check(counts[kname] == execs * TRAIN["num_layers"] * steps,
                  "%s: %s launched %d times" % (tag, kname, counts[kname]))
        res[tag] = ({"probabilities": probs},
                    {n: a.asnumpy().copy()
                     for n, a in mod.get_params()[0].items()}, counts)
    for what, k, tol in (("first batch's probabilities", 0, MC_OUT_TOL),
                         ("parameters after 4 steps", 1, MC_PARAM_TOL)):
        two, one = res["two contexts"][k], res["one context"][k]
        largest = max(float(abs(v).max()) for v in one.values())
        diff = {n: float(abs(two[n] - one[n]).max()) for n in one}
        worst = max(diff, key=diff.get)
        log("  two contexts against one, %s: worst %s %.3e, %.3e of the "
            "largest %.4g (tol %.0e)" % (what, worst, diff[worst],
                                         diff[worst] / largest, largest, tol))
        check(diff[worst] <= tol * largest,
              "two contexts disagree with one: %s" % what)
    return res["two contexts"][2]


def run_model_parallel_phase(mx, A, build, card):
    """Phase 22; returns the kernels' launches of its main paths."""
    log("  (a) ring and Ulysses attention over a 4-position mesh on cuda:0")
    launches = sequence_parallel_attention(mx, A, build, card)
    log("  (b) ParallelLMModule.fit at the zoo LM's width, seq 1024: dense, "
        "sp, pp, ep")
    for n, c in parallel_lm_fits(mx, build, card).items():
        launches[n] += c
    log("  (c) group2ctx over the card and the host: "
        "examples/model_parallel_lstm.py's net")
    group2ctx_card_and_host(mx, card)
    log("  (d) the Transformer-LM's classic fit, context=[tpu(0), tpu(0)]")
    for n, c in two_contexts_one_card(mx, build, card).items():
        launches[n] += c
    return launches


# ---------------------------------------------------------------- phase 23
OBS_BATCHES = 12                  # batches of 32 in the guarded fits
OBS_SPEC = "nan:after=5,times=1"  # 23(a): the sixth fused step goes bad
OBS_TOL = RESUME_TOL              # 23(a): a healed fit against an unguarded one
MON_TOL = 1e-4                    # 23(d): node-output stats card vs CPU,
#                                   relative; gradients' and weights' at GRAD_TOL
MON_SGD = {"learning_rate": 0.1}  # 23(d): an update linear in the gradient
STALL_S = 3                       # 23(c): the watchdog's deadline
STALL_SPEC = "stall:after=6,times=1,delay_ms=6000"
STALL_LIMIT = STALL_S + 5         # 23(c): StallError within this many seconds
MEMCOST = dict(depth=48, batch=512, hidden=1024)  # examples/memcost.py
FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
FLASH_EVENTS = {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel"}


def _obs_fit(mx, build, mod=None, n=OBS_BATCHES, epochs=1, cfg=TRAIN,
             batch_end=(), **kw):
    """Phase 5's fit of the LM (fused unless the caller wraps it in
    ``no_fused``) over ``n`` batches: (module, host seconds per step, the
    K1/K2a/K2b launches). Counters set to 0 just before, read just
    after."""
    X, Y = lm_stream(32 * n, cfg=cfg)
    it = mx.io.NDArrayIter(X, Y, batch_size=32, shuffle=False)
    if mod is None:
        mod = mx.mod.Module(mx.models.transformer_lm(**cfg),
                            context=mx.gpu(0))
    stamps = []

    def stamp(_p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _zero(build)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=[stamp] + list(batch_end), **kw)
    torch.cuda.synchronize()
    per = np.diff([t0] + stamps)
    return mod, (float(np.median(per[2:])) if len(per) > 3 else None), \
        _counts(build)


def _host_params(mod):
    return {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}


def _params_close(got, want, tol):
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[n] - want[n]).max()) for n in want) / scale, tol


def guarded_fit(mx, build, card):
    """23(a): the LM's fused fit under ``guard="rollback"`` with one
    injected bad step, against the same fit unguarded."""
    import os

    ref, plain_s, _ = _obs_fit(mx, build)
    want = _host_params(ref)
    del ref
    guard = mx.guard.TrainingGuard(mx.guard.GuardPolicy(
        "rollback", max_bad_steps=1, snapshot_every=4))
    log_ = []
    bad_step = guard.bad_step

    def record(reason, epoch, nbatch, applied=False):
        action = bad_step(reason, epoch, nbatch, applied=applied)
        log_.append((reason, nbatch, applied, action))
        return action

    guard.bad_step = record
    seen = []
    os.environ["MXNET_FAULT_SPEC"] = OBS_SPEC
    mx.fault.reset()
    try:
        mod, guarded_s, launches = _obs_fit(
            mx, build, guard=guard,
            batch_end=[lambda p: seen.append(p.nbatch)])
    finally:
        del os.environ["MXNET_FAULT_SPEC"]
        mx.fault.reset()
    err, tol = _params_close(_host_params(mod), want, OBS_TOL)
    L = TRAIN["num_layers"]
    steps = len(seen) + guard.bad_steps   # a bad step has no batch end
    log("  (a) guarded fused fit, %s: bad steps %d, rollbacks %d, decisions "
        "(reason, batch, applied, action) %s, batch ends %s; final parameters "
        "within %.3e of the largest of the unguarded fit's (tolerance %g); "
        "launches %s in %d steps"
        % (OBS_SPEC, guard.bad_steps, guard.rollbacks, log_, seen, err, tol,
           launches, steps))
    log("  (a) host wall per fused step (median, synchronized): guarded "
        "%.6f s, unguarded %.6f s, ratio %.4f (%s)"
        % (guarded_s, plain_s, guarded_s / plain_s, card))
    check(guard.bad_steps == 1 and guard.rollbacks == 1,
          "23(a): %d bad steps, %d rollbacks" % (guard.bad_steps,
                                                 guard.rollbacks))
    check(seen == list(range(5)) + list(range(4, OBS_BATCHES)),
          "23(a): the fit did not replay from the snapshot batch: %s" % seen)
    check(mod._fused is not None and mod._fused.trainer.captures == 1,
          "23(a): the guarded fit left its one CUDA graph")
    check(err <= tol, "23(a): the healed fit is %.3e from the unguarded one"
          % err)
    for name in FLASH:
        check(launches[name] == L * steps, "23(a): %s launched %d times"
              % (name, launches[name]))
    return launches, {"guarded_s": guarded_s, "plain_s": plain_s}


def classic_skip(mx, build):
    """23(b): the classic path under ``skip`` with a poisoned gradient."""
    snaps = []
    guard = mx.guard.TrainingGuard(mx.guard.GuardPolicy("skip"))
    with no_fused(), mx.fault.inject("nan:after=2,times=1"):
        mod, _, launches = _obs_fit(
            mx, build, n=4, guard=guard,
            batch_end=[lambda p: snaps.append(_host_params(
                p.locals["self"]))])
    same = all(np.array_equal(snaps[2][n], snaps[1][n]) for n in snaps[1])
    moved = any(not np.array_equal(snaps[3][n], snaps[2][n]) for n in snaps[1])
    log("  (b) classic fit under skip, nan:after=2: bad steps %d; the "
        "parameters after the poisoned step bitwise those before it: %s; "
        "the next step moved them: %s" % (guard.bad_steps, same, moved))
    check(guard.bad_steps == 1 and same and moved,
          "23(b): skip did not leave the parameters untouched")
    return launches


def stall_check(mx, build):
    """23(c): a stall in the device feed's transfer stage under
    ``MXNET_GUARD_STALL_S``."""
    import gc
    import os
    import threading

    def feeds():
        gc.collect()
        return ({id(o) for o in gc.get_objects()
                 if isinstance(o, mx.io.DeviceFeedIter)},
                {t.ident for t in threading.enumerate()
                 if t.name == "DeviceFeedIter" and t.is_alive()})

    before = feeds()   # an earlier phase's feeds are not this fit's
    os.environ.update(MXNET_GUARD_STALL_S=str(STALL_S), MXNET_FEED_DEPTH="2")
    beats = []
    t_err = None
    try:
        with mx.fault.inject(STALL_SPEC):
            _obs_fit(mx, build, n=16,
                     batch_end=[lambda p: beats.append(time.perf_counter())])
    except mx.guard.StallError as e:
        t_err = time.perf_counter()
        log("  (c) StallError: %s" % e)
    finally:
        del os.environ["MXNET_GUARD_STALL_S"], os.environ["MXNET_FEED_DEPTH"]
    after = feeds()
    held, alive = after[0] - before[0], after[1] - before[1]
    dt = None if t_err is None or not beats else t_err - beats[-1]
    log("  (c) %s, MXNET_GUARD_STALL_S=%d: %d steps, then StallError %s s "
        "after the last one (limit %d s); this fit's feed threads alive %d, "
        "feeds held %d (earlier phases': %d threads, %d feeds)"
        % (STALL_SPEC, STALL_S, len(beats),
           "%.3f" % dt if dt is not None else "never", STALL_LIMIT,
           len(alive), len(held), len(before[1]), len(before[0])))
    check(dt is not None and dt <= STALL_LIMIT,
          "23(c): no StallError within %d s" % STALL_LIMIT)
    check(not alive and not held, "23(c): the device feed outlived the fit")


def _mon_records(mx, net, ctx, params, n=1):
    """``fit(monitor=Monitor(1))`` of the LM ``net`` from ``params`` on
    ``ctx``: the first batch's records and the module."""
    X, Y = lm_stream(32 * n)
    mon = mx.mon.Monitor(1)
    recs = []
    mon.toc_print = lambda: recs.append(mon.toc())
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=32, shuffle=False),
            num_epoch=1, optimizer="sgd", optimizer_params=MON_SGD,
            monitor=mon, arg_params=params)
    return recs[0], mod


def monitored_fit(mx, build, params):
    """23(d): ``fit(monitor=Monitor(interval=1))`` on the card against the
    CPU port from the same weights and batch. SGD: Adam's first step,
    lr·g/(|g|+eps), takes a gradient of the size of eps that the card and
    the CPU round apart to updates up to lr apart (Adam moved
    ``layer3_ln2_beta``'s RMS by 6.2e-4 relative on an H100).
    Node outputs within MON_TOL (the forward: 1.6e-7 there); gradients
    and the weights after the update within phase 6's GRAD_TOL: the flash
    kernels' TF32 split moved ``layer0_ln1_beta``'s gradient RMS by
    1.33e-4, and that beta, 0 before the step, is -lr times it after."""
    net = mx.models.transformer_lm(**TRAIN)   # one symbol: the same names
    _zero(build)
    card_recs, mod = _mon_records(mx, net, mx.gpu(0), params, n=2)
    launches = _counts(build)
    cpu_recs, _ = _mon_records(mx, net, mx.cpu(), params)
    names = [r[1] for r in card_recs]
    worst = {}
    for (_, name, a), (_, _, b) in zip(card_recs, cpu_recs):
        kind = ("gradients" if name.endswith("_grad") else
                "node outputs" if name.endswith("_output") else "weights")
        rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        worst[kind] = max(worst.get(kind, (0.0, "")), (rel, name))
    L = TRAIN["num_layers"]
    log("  (d) monitored fit (SGD %s): %d records in the first batch (%s "
        "... %s); worst relative difference card vs CPU (tolerance): %s; on "
        "the classic path: %s; launches over its 2 steps %s"
        % (MON_SGD, len(card_recs), names[:3], names[-3:],
           {k: ("%.3e" % v[0], v[1], MON_TOL if k == "node outputs"
                else GRAD_TOL) for k, v in sorted(worst.items())},
           mod._fused is None, launches))
    check(names == [r[1] for r in cpu_recs] and len(names) > 50,
          "23(d): the card's and the CPU's records differ in names")
    for kind, (rel, name) in worst.items():
        check(rel <= (MON_TOL if kind == "node outputs" else GRAD_TOL),
              "23(d): monitor stats of %s differ by %.3e (%s)"
              % (kind, rel, name))
    check(mod._fused is None and launches["flash_fwd"] == 2 * L,
          "23(d): the monitored forward did not launch K1 %d times" % (2 * L))
    return launches


def _trace_counts(path):
    """Kernel events of K1/K2a/K2b in an exported torch trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {n: sum(1 for e in events if e.get("cat") == "kernel"
                   and pat in str(e.get("name", "")))
            for n, pat in FLASH_EVENTS.items()}, \
        sum(1 for e in events if e.get("cat") == "kernel")


def profiled_steps(mx, build):
    """23(e): the profiler in mode ``all`` with MXNET_PROFILER_TRACE_DIR
    around 3 classic steps, and around 3 replays of a fused fit's graph
    (captured before the window opens)."""
    import os

    out = os.path.join("build", "phase23")
    os.makedirs(out, exist_ok=True)
    os.environ["MXNET_PROFILER_TRACE_DIR"] = os.path.join(out, "device")
    fused, _, _ = _obs_fit(mx, build, n=3)
    res = {}
    try:
        for label, run in (
                ("classic", lambda: _obs_fit_classic(mx, build)),
                ("fused", lambda: _obs_fit(mx, build, mod=fused, n=3,
                                           epochs=2, begin_epoch=1))):
            py = os.path.join(out, "python_%s.json" % label)
            mx.profiler.profiler_set_config(mode="all", filename=py)
            mx.profiler.profiler_set_state("run")
            try:
                _, _, launches = run()
            finally:
                mx.profiler.profiler_set_state("stop")
            mx.profiler.dump_profile()
            with open(py) as f:
                spans = {e["name"] for e in json.load(f)["traceEvents"]}
            events, kernels = _trace_counts(mx.profiler.last_device_trace())
            res[label] = (launches, events)
            log("  (e) %s: launches %s; kernel events in the device trace "
                "%s of %d kernels; python trace spans include fit.step %s, "
                "executor_fwd_bwd %s" % (
                    label, {n: launches[n] for n in FLASH}, events, kernels,
                    "fit.step" in spans,
                    any(s.startswith("executor_fwd_bwd") for s in spans)))
            check("fit.step" in spans, "23(e): no fit.step span")
    finally:
        del os.environ["MXNET_PROFILER_TRACE_DIR"]
    launches, events = res["classic"]
    check(all(events[n] == launches[n] for n in FLASH),
          "23(e): the device trace's K1/K2a/K2b events %s are not the "
          "launch counts %s" % (events, launches))
    return {n: res["classic"][0][n] + res["fused"][0][n] for n in FLASH}


def _obs_fit_classic(mx, build, **kw):
    with no_fused():
        return _obs_fit(mx, build, n=3, **kw)


def _seq_free_lm(mx, seq_len):
    """The zoo LM with its blocks' ``Reshape(-1, seq_len, d)`` written as
    a split of the batch (``(-4, 32, -1, -2)``): the same computation at
    batch 32, one graph (one symbol digest) at every sequence length."""
    cfg = dict(TRAIN, seq_len=seq_len)
    js = mx.models.transformer_lm(**cfg).tojson()
    old = '"(-1, %d, %d)"' % (seq_len, TRAIN["model_dim"])
    check(old in js, "23(f): the LM's block reshape is not %s" % old)
    return mx.sym.load_json(js.replace(old, '"(-4, 32, -1, -2)"')), cfg


def compile_records(mx, build):
    """23(f): the registry after the run so far, a recompile at seq 64,
    and ``Executor.memory_analysis``."""
    table = mx.compileobs.program_table()
    for row in table:
        log("  (f) program %-24s compiles %3d in %9.4f s, runs %6d in "
            "%9.4f s, recompiles %d, arg bytes %d" % (
                row["program"], row["compile_count"], row["compile_seconds"],
                row["run_count"], row["run_seconds"], row["recompile_count"],
                row["arg_bytes"]))
    names = {r["program"] for r in table}
    check({"fused.step", "serving.prefill", "serving.decode",
           "nvcc.flash_fwd", "nvcc.flash_bwd_dkv", "nvcc.flash_bwd_dq"}
          <= names, "23(f): the registry lacks programs: %s" % sorted(names))
    launches = {n: 0 for n in FLASH}
    digests = []
    for seq in (128, 64):
        net, cfg = _seq_free_lm(mx, seq)
        digests.append(mx.compileobs.symbol_digest(net))
        mod = mx.mod.Module(net, context=mx.gpu(0))
        # the log keeps the newest 256 attributions: select by time
        since = time.time()
        _, _, n = _obs_fit(mx, build, mod=mod, n=3, cfg=cfg)
        launches = {k: launches[k] + n[k] for k in FLASH}
    new = [r for r in mx.compileobs.recompile_log() if r["ts"] >= since]
    log("  (f) the LM at seq 128 then 64 (one graph: digests %s): recompiles "
        "%s" % (digests, [(r["program"], r["cause"], r.get("arg"),
                           r.get("old_shape"), r.get("new_shape"))
                          for r in new]))
    check(digests[0] == digests[1] and any(
        r["program"] == "fused.step" and r["cause"] == "seq_len" for r in new),
        "23(f): no seq_len recompile of fused.step")
    # memory_analysis on the classic executor, between two steps
    X, Y = lm_stream(64)
    outs = []
    for analyze in (False, True):
        with no_fused():
            mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN),
                                context=mx.gpu(0))
            mod.bind([("data", (32, 128))], [("softmax_label", (32, 128))])
            mod.init_params(mx.init.Xavier(rng=torch.Generator().manual_seed(0)))
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": TRAIN_LR})
        for i in range(2):
            if i == 1 and analyze:
                ma = mod._exec_group.execs[0].memory_analysis()
            mod.forward_backward(mx.io.DataBatch(
                [mx.nd.array(X[32 * i:32 * (i + 1)], ctx=mx.gpu(0))],
                [mx.nd.array(Y[32 * i:32 * (i + 1)], ctx=mx.gpu(0))]))
            mod.update()
        outs.append((mod.get_outputs()[0].asnumpy(), _host_params(mod)))
        del mod
    err = max(float(np.abs(outs[1][0] - outs[0][0]).max()),
              _params_close(outs[1][1], outs[0][1], 0)[0])
    log("  (f) memory_analysis of the LM's classic executor (batch 32 x "
        "128): arguments %d, outputs %d, temp %d, peak %d bytes; the next "
        "step with and without the call differs by %.3e"
        % (ma.argument_size_in_bytes, ma.output_size_in_bytes,
           ma.temp_size_in_bytes, ma.peak_memory_in_bytes, err))
    check(ma.peak_memory_in_bytes > ma.argument_size_in_bytes,
          "23(f): the measured peak is not above the arguments")
    check(err <= OBS_TOL, "23(f): memory_analysis moved the next step")
    return launches


def oom_check(mx, build):
    """23(g): a 100 GB request under ``oom_guard("executor.fwd")``."""
    import logging

    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    grab = Grab()
    logger = logging.getLogger("mxnet_tpu_torch.compileobs")
    logger.addHandler(grab)
    raised = None
    try:
        with mx.compileobs.oom_guard("executor.fwd"):
            torch.empty(100 * 10 ** 9, dtype=torch.uint8, device="cuda:0")
    except torch.cuda.OutOfMemoryError as e:
        raised = e
    finally:
        logger.removeHandler(grab)
    report = [m for m in grab.msgs if "OOM at program 'executor.fwd'" in m]
    with no_fused():
        mod, _, launches = _obs_fit(mx, build, n=1)
    ok = np.isfinite(mod.get_outputs()[0].asnumpy()).all()
    log("  (g) 100 GB under oom_guard: %s; report %s (%d lines); the next "
        "step ran, outputs finite: %s" % (
            type(raised).__name__ if raised else "no error",
            "naming executor.fwd" if report else "missing",
            report[0].count("\n") + 1 if report else 0, ok))
    check(raised is not None and report and ok, "23(g): OOM path failed")
    return launches


def mirrored_steps(mx, build, card):
    """The fused LM step with MXNET_BACKWARD_DO_MIRROR=1 against the plain
    one: K1 per step, host wall, peak memory, parameters; and
    ``examples/memcost.py``'s network at its defaults, both peaks."""
    import os

    res = {}
    for mirror in ("0", "1"):
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = mirror
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            mod, step_s, launches = _obs_fit(mx, build, n=8)
            peak = torch.cuda.max_memory_allocated() - base
            res[mirror] = (step_s, peak, mod._fused.trainer._per_replay,
                           _host_params(mod), launches)
            del mod
        finally:
            del os.environ["MXNET_BACKWARD_DO_MIRROR"]
    err, _ = _params_close(res["1"][3], res["0"][3], 0)
    L = TRAIN["num_layers"]
    log("  mirror: fused LM step host wall %.6f s mirrored, %.6f s plain "
        "(%.4fx); peak above the fit's start %.3f GB mirrored, %.3f GB "
        "plain; K1 per replay %d mirrored, %d plain; parameters after 8 "
        "steps within %.3e of the largest (%s)"
        % (res["1"][0], res["0"][0], res["1"][0] / res["0"][0],
           res["1"][1] / 1e9, res["0"][1] / 1e9,
           res["1"][2].get("flash_fwd", 0), res["0"][2].get("flash_fwd", 0),
           err, card))
    check(res["1"][2].get("flash_fwd") == 2 * L
          and res["0"][2].get("flash_fwd") == L,
          "mirror: K1 per replay %s, not twice the plain step's"
          % res["1"][2])
    check(err <= OBS_TOL, "mirror: parameters differ by %.3e" % err)
    peaks = {}
    for mirror in ("0", "1"):
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = mirror
        try:
            net = mx.sym.Variable("data")
            for i in range(MEMCOST["depth"]):
                net = mx.sym.FullyConnected(net, num_hidden=MEMCOST["hidden"],
                                            name="fc%d" % i)
                net = mx.sym.Activation(net, act_type="relu",
                                        name="relu%d" % i)
            net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                net, num_hidden=10, name="out"), name="softmax")
            ex = net.simple_bind(ctx=mx.gpu(0), data=(MEMCOST["batch"],
                                                      MEMCOST["hidden"]))
            peaks[mirror] = ex.memory_analysis().peak_memory_in_bytes
            del ex
        finally:
            del os.environ["MXNET_BACKWARD_DO_MIRROR"]
    log("  memcost at its defaults (depth %d, batch %d, hidden %d): peak "
        "bytes without mirror %.1f MB, with mirror %.1f MB, saved %.1f%% (%s)"
        % (MEMCOST["depth"], MEMCOST["batch"], MEMCOST["hidden"],
           peaks["0"] / 1e6, peaks["1"] / 1e6,
           100.0 * (peaks["0"] - peaks["1"]) / max(peaks["0"], 1), card))
    check(peaks["0"] > 0 and peaks["1"] > 0, "memcost: no measured peak")
    return {n: res["0"][4][n] + res["1"][4][n] for n in FLASH}


def run_observability_phase(mx, build, card):
    """Phase 23: A7's training half on the LM's fused fit (see the module
    docstring). Returns the K1/K2a/K2b launches of its main paths."""
    total = {n: 0 for n in FLASH}

    def add(launches):
        for n in FLASH:
            total[n] += launches.get(n, 0)

    t0 = time.perf_counter()
    a_launches, walls = guarded_fit(mx, build, card)
    add(a_launches)
    add(classic_skip(mx, build))
    stall_check(mx, build)
    init = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.cpu())
    init.bind([("data", (32, 128))], [("softmax_label", (32, 128))])
    init.init_params(mx.init.Xavier(rng=torch.Generator().manual_seed(0)))
    params = {n: a.asnumpy() for n, a in init.get_params()[0].items()}
    del init
    add(monitored_fit(mx, build, params))
    add(profiled_steps(mx, build))
    add(compile_records(mx, build))
    add(oom_check(mx, build))
    add(mirrored_steps(mx, build, card))
    torch.cuda.empty_cache()
    log("  phase 23: %.1f s; K1/K2a/K2b launches on its main paths %s"
        % (time.perf_counter() - t0, total))
    return total


# ------------------------------------ A6c: HA and elastic membership (24)
ELASTIC_HB = {"MXNET_ELASTIC_HEARTBEAT_S": "0.5",
              "MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S": "2"}
# (b): worker 1 dies at the top of its third batch (epoch 0, batch 2)
WORKER_KILL_AFTER = 2
# (a): server 2 dies once group 1's keys took this many steps of updates
# (mid-epoch 0, batch 3), and the servers checkpoint every this many
SERVER_KILL_STEPS = 3
SERVER_CKPT_STEPS = 2
# (c): rank 1's sleep per batch in its data iterator, after this many
STRAGGLER_SLEEP_S = 0.5
STRAGGLER_WARMUP = 2
# rank 0's wait at a batch end for the relaunched process to be back
HOLD_LIMIT_S = 240


def elastic_stream():
    """Phase 21(b)'s sequences reordered so that ``num_parts=2`` part r is
    phase 21's shard of rank r (``X[r::2]``)."""
    X, Y = lm_stream(DIST_SEQS)
    return (np.concatenate([X[0::2], X[1::2]]),
            np.concatenate([Y[0::2], Y[1::2]]))


def _checksum(x):
    return float(np.abs(np.asarray(x, np.float64)).sum())


def elastic_lm_worker():
    """One process of phase 24, started by ``tools/launch.py`` (a server
    serves inside the ``import`` and exits there): phase 21(b)'s fit on
    ``cuda:0``, fused, on contiguous shards that the elastic session
    reshards. Every batch end appends a JSON line (time, incarnation,
    step, membership epoch, server map, launches so far, the batch's
    checksum) to ``SMOKE_OUT``, so a killed incarnation leaves its record;
    the end writes the parameters and a summary. ``WAIT_FOR``
    (``server:<id>`` or ``worker:<rank>``) makes rank 0 wait at its first
    batch end after a membership change until that process is back in
    the registry's table; ``SMOKE_STRAGGLE=1`` slows rank 1's data path."""
    import os

    if os.environ.get("DMLC_PS_RECOVERY"):
        # the kill rule is the first incarnation's
        os.environ.pop("MXNET_FAULT_SPEC", None)
    trace_dir = os.environ.get("SMOKE_TRACE_DIR")
    if trace_dir:
        # 25(d): every process of the job (the server too) traces there
        os.makedirs(trace_dir, exist_ok=True)
        os.environ["MXNET_PROFILER_FILENAME"] = os.path.join(
            trace_dir, "profile.%d.json" % os.getpid())
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.ops import _build as build

    out_dir = os.environ["SMOKE_OUT"]
    wait_for = os.environ.get("WAIT_FOR")
    straggle = os.environ.get("SMOKE_STRAGGLE") == "1"
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    inc = "relaunch" if kv.is_recovery else "first"
    X, Y = elastic_stream()

    class Paced(mx.io.NDArrayIter):
        served = 0

        def next(self):
            Paced.served += 1
            if straggle and rank == 1 and Paced.served > STRAGGLER_WARMUP:
                time.sleep(STRAGGLER_SLEEP_S)
            return super().next()

    it = Paced(X, Y, batch_size=DIST_BATCH, shuffle=False,
               num_parts=kv.num_workers, part_index=rank)
    mod = mx.mod.Module(mx.models.transformer_lm(**TRAIN), context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=None)
    ppl, held, probe = [], [], {}
    path = os.path.join(out_dir, "steps-%d-%s.jsonl" % (rank, inc))
    for k in build.KERNELS.values():
        k.launches = 0

    def back(table):
        kind, who = wait_for.split(":")
        return int(who) in table["servers" if kind == "server" else "workers"]

    def hold():
        deadline = time.time() + HOLD_LIMIT_S
        while time.time() < deadline:
            raw = kv.registry_fetch("mb_get")
            if raw and back(json.loads(raw.decode())):
                held.append(time.time())
                return
            time.sleep(0.1)
        raise SystemExit("%s never came back" % wait_for)

    def watch(param):
        # three steps into rank 1's sleep: the merged view of both ranks
        step = param.epoch * 4 + param.nbatch
        if "stats" in probe or step < STRAGGLER_WARMUP + 3:
            return
        for _ in range(40):
            stats = kv.cluster_stats()
            if all(((stats["workers"].get(r) or {}).get("window") or {}).get(
                    "steps") for r in (0, 1)):
                probe["stats"] = stats
                break
            time.sleep(0.1)
        probe["at"] = step
        evs = tel.events("kv.straggler")
        probe["named"] = dict(evs[0]) if evs else None
        if trace_dir and "stats" in probe:
            # 25(d): mxtop --once, an observer of the plane with none of
            # this job's sinks or roles
            env = {k: v for k, v in os.environ.items()
                   if k not in ("MXNET_TELEMETRY_FILE", "DMLC_ROLE",
                                "MXNET_PROFILER_AUTOSTART",
                                "MXNET_PROFILER_FILENAME")}
            p = subprocess.run([sys.executable, "-m",
                                "mxnet_tpu_torch.tools.mxtop", "--once"],
                               env=env, capture_output=True, text=True,
                               timeout=120)
            probe["mxtop"] = {"rc": p.returncode, "out": p.stdout,
                              "err": p.stderr[-2000:]}

    def batch_end(param):
        torch.cuda.synchronize()
        tr = mod._fused.trainer if mod._fused is not None else None
        rec = {"t": time.time(), "rank": rank, "inc": inc,
               "epoch": param.epoch, "nbatch": param.nbatch,
               "mepoch": kv.membership_epoch, "smap": list(kv._smap),
               "checksum": _checksum(param.locals["data_batch"].data[0]
                                     .asnumpy()),
               "launches": {n: build.KERNELS[n].launches for n in FLASH},
               "captures": None if tr is None else tr.captures}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if rank == 0 and straggle:
            watch(param)
        if rank == 0 and wait_for and not held and kv.membership_epoch >= 1:
            hold()

    mod.fit(it, num_epoch=DIST_EPOCHS, kvstore=kv, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(rank)),
            eval_metric=metric, batch_end_callback=batch_end,
            epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
    tr = mod._fused.trainer if mod._fused is not None else None
    summary = {"rank": rank, "inc": inc, "ppl": ppl, "smap": list(kv._smap),
               "fused": mod._fused is not None,
               "context": str(torch.device(mod._context[0])),
               "captures": None if tr is None else tr.captures,
               "launches": {n: build.KERNELS[n].launches for n in FLASH},
               "held": held}
    if rank == 0 and straggle:
        stats = probe.get("stats") or {}
        trace = kv.request_server_trace()
        workers = stats.get("workers") or {}
        summary["probe"] = {
            "named": probe.get("named"), "at": probe.get("at"),
            "mxtop": probe.get("mxtop"),
            "held": sorted(r for r, s in workers.items() if s),
            "straggler": stats.get("straggler"),
            "windows": {r: (s or {}).get("window") for r, s in
                        workers.items()},
            "trace": next(iter(trace.values()))["per_rank"]}
    np.savez(os.path.join(out_dir, "params-%d.npz" % rank),
             **{n: a.asnumpy() for n, a in mod.get_params()[0].items()})
    with open(os.path.join(out_dir, "done-%d.json" % rank), "w") as f:
        json.dump(summary, f)
    kv.barrier()
    if rank == 0:
        kv._stop_servers()


def _elastic_run(what, out_dir, env, servers=1, elastic=True):
    """One phase-24 cluster; returns (stderr, {rank: summary}, {rank:
    params}, [every batch-end record, by time])."""
    import glob
    import os

    os.makedirs(out_dir)
    command = [sys.executable, "-c",
               "import chip_smoke; chip_smoke.elastic_lm_worker()"]
    t0 = time.time()
    _, err = run_cluster(command, dict(env, SMOKE_OUT=out_dir), what,
                         servers=servers,
                         launch_args=("--elastic",) if elastic else ())
    log("  %s: %.1f s" % (what, time.time() - t0))
    done, params = {}, {}
    for r in (0, 1):
        with open(os.path.join(out_dir, "done-%d.json" % r)) as f:
            done[r] = json.load(f)
        with np.load(os.path.join(out_dir, "params-%d.npz" % r)) as z:
            params[r] = {k: z[k] for k in z.files}
    steps = []
    for p in glob.glob(os.path.join(out_dir, "steps-*.jsonl")):
        with open(p) as f:
            steps += [json.loads(l) for l in f if l.strip()]
    steps.sort(key=lambda r: r["t"])
    return err, done, params, steps


def _median_walls(steps, rank):
    """``{membership epoch: rank's median host wall per step}``: the gaps
    between its batch ends within one epoch and incarnation, the first two
    of each left out (the hold, a capture) when more than four remain."""
    out = {}
    for e in sorted({r["mepoch"] for r in steps}):
        rows = [r for r in steps if r["rank"] == rank and r["mepoch"] == e]
        gaps = [cur["t"] - prev["t"] for prev, cur in zip(rows, rows[1:])
                if cur["inc"] == prev["inc"]]
        gaps = sorted(gaps[2:] if len(gaps) > 4 else gaps)
        out[e] = gaps[len(gaps) // 2] if gaps else float("nan")
    return out


def _walls_line(walls):
    return ", ".join("membership epoch %d: %s" % (e, "%.5f s" % w if w == w
                                                 else "one step")
                     for e, w in sorted(walls.items()))


def _incarnation_launches(steps):
    """Each (rank, incarnation)'s launches by its last batch end."""
    last = {}
    for r in steps:
        last[r["rank"], r["inc"]] = r["launches"]
    return last


def _largest_diff(params, ref):
    return max(float(np.abs(params[k] - ref[k]).max()) for k in ref)


def _check_elastic_common(what, done, params, steps, ref):
    L = TRAIN["num_layers"]
    differ = [k for k in params[0]
              if not np.array_equal(params[0][k], params[1][k])]
    log("  [%s] the two workers' final parameters: %s"
        % (what, "bitwise equal" if not differ else "differ in %s" % differ))
    check(not differ, "%s: the workers' parameters differ" % what)
    for r in (0, 1):
        check(done[r]["context"] == "cuda:0" and done[r]["fused"],
              "%s: worker %d did not train fused on cuda:0" % (what, r))
    ppl = done[0]["ppl"]
    log("  [%s] worker 0's perplexity per epoch %s; largest parameter "
        "difference from phase 21(b)'s unfaulted fit %.3e"
        % (what, ["%.3f" % p for p in ppl], _largest_diff(params[0], ref)))
    check(len(ppl) == DIST_EPOCHS and all(math.isfinite(p) for p in ppl)
          and ppl[-1] < ppl[0], "%s: the perplexity did not fall" % what)
    for key, n in sorted(_incarnation_launches(steps).items()):
        log("  [%s] worker %d, %s incarnation: launches %s" % (what, key[0],
                                                              key[1], n))
        check(all(n[k] > 0 and n[k] % L == 0 for k in FLASH),
              "%s: worker %d's %s incarnation launched %s" % (what, key[0],
                                                            key[1], n))


def straggler_run(work, dist_params):
    """Phase 24(c): a plain ``dist_sync`` cluster whose rank 1 sleeps in
    its data path, with per-rank telemetry sinks and profiler traces under
    ``work`` for 25(d); returns its K1/K2a/K2b launches and what 25(d)
    reads."""
    import os

    steps_per_epoch = DIST_SEQS // 2 // DIST_BATCH
    log("  (c) dist_sync, rank 1 sleeping %.1f s per batch in its data "
        "path after %d" % (STRAGGLER_SLEEP_S, STRAGGLER_WARMUP))
    # with per-rank telemetry sinks and profiler traces, for 25(d)
    trace_dir = os.path.join(work, "24c", "trace")
    err, done, params, steps = _elastic_run(
        "cluster statistics", os.path.join(work, "24c"), {
            "SMOKE_STRAGGLE": "1", "MXNET_CLUSTER_STATS_INTERVAL_S": "0.15",
            "MXNET_STRAGGLER_FACTOR": "2.0", "SMOKE_TRACE_DIR": trace_dir,
            "MXNET_TELEMETRY_FILE": os.path.join(
                trace_dir, "telemetry.{rank}.jsonl"),
            "MXNET_PROFILER_AUTOSTART": "1"}, elastic=False)
    probe = done[0]["probe"]
    verdict = probe["straggler"]
    log("  (c) rank 0's cluster_stats() at step %s: ranks %s, straggler "
        "%s; windows %s; the publisher's first kv.straggler event %s"
        % (probe["at"], probe["held"], verdict, probe["windows"],
           probe["named"]))
    check(probe["held"] == [0, 1],
          "(c): cluster_stats() holds ranks %s" % probe["held"])
    check(verdict is not None and verdict["rank"] == 1
          and verdict["stage"] == "data_wait",
          "(c): cluster_stats() names the straggler %s" % verdict)
    trace = probe["trace"]
    last = ((DIST_EPOCHS - 1) << 32) | (steps_per_epoch - 1)
    log("  (c) the server's trace: %s" % trace)
    check(all(trace[r]["pushes"] > 0 and trace[r]["pulls"] > 0
              and trace[r]["last_step"] == last for r in ("0", "1")),
          "(c): the trace does not attribute both ranks' RPCs")
    differ = [k for k in dist_params
              if not np.array_equal(params[0][k], dist_params[k])]
    log("  (c) final parameters against phase 21(b)'s: %s"
        % ("bitwise equal" if not differ else "largest difference %.3e"
           % _largest_diff(params[0], dist_params)))
    total = {k: 0 for k in FLASH}
    for n, c in _incarnation_launches(steps).items():
        for k in FLASH:
            total[k] += c[k]
    return total, {"trace_dir": trace_dir, "mxtop": probe.get("mxtop"),
                   "step_wall": _median_walls(steps, 0)[0]}


def run_elastic_phase(mx, build, card, dist_params, work):
    """Phase 24's (a) and (b) (see the module docstring); returns the
    K1/K2a/K2b launches of their runs, every incarnation's. (c),
    :func:`straggler_run`, runs beside 25(a)-(c)."""
    import os
    import tempfile

    total = {n: 0 for n in FLASH}
    steps_per_epoch = DIST_SEQS // 2 // DIST_BATCH
    names = [n for n in mx.models.transformer_lm(**TRAIN).list_arguments()
             if n not in ("data", "softmax_label")]
    group1 = sum(1 for i in range(len(names)) if i % 2 == 1)
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        log("  (a) -s 4, MXNET_KV_REPLICAS=1: server 2 (group 1's primary) "
            "killed after %d updates (%d keys in group 1, %d steps)"
            % (group1 * SERVER_KILL_STEPS, group1, SERVER_KILL_STEPS))
        err, done, params, steps = _elastic_run(
            "server failover", os.path.join(tmp, "a"), dict(
                ELASTIC_HB, MXNET_KV_REPLICAS="1",
                MXNET_KV_SERVER_CKPT_STEPS=str(group1 * SERVER_CKPT_STEPS),
                MXNET_KV_SERVER_CKPT_DIR=os.path.join(tmp, "ckpt"),
                MXNET_FAULT_SPEC="kill_server:server_id=2,after=%d,times=1"
                % (group1 * SERVER_KILL_STEPS),
                WAIT_FOR="server:2"), servers=4)
        check(done[0]["smap"] == done[1]["smap"] == [0, 3],
              "(a): the workers ended on server maps %s, %s"
              % (done[0]["smap"], done[1]["smap"]))
        for event in ("PROMOTED to primary", "adopting server map",
                      "relaunching server 2", "optimizer-state checkpoint",
                      "restored optimizer state", "rejoined as a backup"):
            n = err.count(event)
            log("  (a) log: %r x%d" % (event, n))
            check(n > 0, "(a): the logs never say %r" % event)
        _check_elastic_common("(a)", done, params, steps, dist_params)
        r0 = [r for r in steps if r["rank"] == 0]
        before = [r for r in r0 if r["smap"] != [0, 3]]
        after = [r for r in r0 if r["smap"] == [0, 3]]
        check(before and after, "(a): no step on each side of the failover")
        log("  (a) %.3f s from the last step before the kill (epoch %d batch "
            "%d) to the first step on the map 0,3; worker 0's median host "
            "wall per fused step by membership epoch: %s"
            % (after[0]["t"] - before[-1]["t"], before[-1]["epoch"],
               before[-1]["nbatch"], _walls_line(_median_walls(steps, 0))))
        for n, c in _incarnation_launches(steps).items():
            for k in FLASH:
                total[k] += c[k]

        log("  (b) -s 1: worker 1 killed at its batch %d"
            % (WORKER_KILL_AFTER + 1))
        err, done, params, steps = _elastic_run(
            "worker kill", os.path.join(tmp, "b"), dict(
                ELASTIC_HB, MXNET_KV_SERVER_CKPT_DIR=os.path.join(tmp, "ckpt_b"),
                MXNET_FAULT_SPEC="kill_worker:rank=1,after=%d,times=1"
                % WORKER_KILL_AFTER, WAIT_FOR="worker:1"))
        for event in ("elastic: reconfigured to membership epoch",
                      "elastic: joined membership epoch",
                      "relaunching worker 1"):
            n = err.count(event)
            log("  (b) log: %r x%d" % (event, n))
            check(n > 0, "(b): the logs never say %r" % event)
        check(done[1]["inc"] == "relaunch" and done[0]["inc"] == "first",
              "(b): incarnations %s, %s" % (done[0]["inc"], done[1]["inc"]))
        check(done[1]["captures"] and done[1]["captures"] >= 1,
              "(b): the relaunched worker captured no gradient graph")
        _check_elastic_common("(b)", done, params, steps, dist_params)
        keys = _incarnation_launches(steps)
        check((1, "first") in keys and (1, "relaunch") in keys,
              "(b): launches of %s" % sorted(keys))
        X, Y = elastic_stream()
        for r in (0, 1):
            fresh = mx.io.NDArrayIter(X, Y, batch_size=DIST_BATCH,
                                      num_parts=2, part_index=r)
            want = [_checksum(b.data[0].asnumpy()) for b in fresh]
            got = [s["checksum"] for s in steps if s["rank"] == r
                   and s["epoch"] == DIST_EPOCHS - 1][-steps_per_epoch:]
            check(got == want, "(b): worker %d's last epoch read %s, a fresh "
                  "shard (2, %d) %s" % (r, got, r, want))
        log("  (b) each worker's last epoch: the batches of a fresh "
            "NDArrayIter on shard (2, rank)")
        first1 = [s for s in steps if s["rank"] == 1 and s["inc"] == "first"]
        relaunch1 = [s for s in steps if s["rank"] == 1
                     and s["inc"] == "relaunch"]
        log("  (b) %.3f s from worker 1's last step (epoch %d batch %d) to "
            "its relaunch's first step; worker 0's median host wall per "
            "fused step by membership epoch (0: two workers, 1: alone, 2: "
            "rejoined): %s"
            % (relaunch1[0]["t"] - first1[-1]["t"], first1[-1]["epoch"],
               first1[-1]["nbatch"], _walls_line(_median_walls(steps, 0))))
        for n, c in keys.items():
            for k in FLASH:
                total[k] += c[k]
    log("  phase 24 (a) and (b): %.1f s; K1/K2a/K2b launches %s"
        % (time.time() - t_phase, total))
    return total


# --------------------------------------- A7's compiler half (phase 25)
# 25(b): each kernel source's check, phase 3's, by the library it lives in
SOURCE_CHECKS = {
    "nvcc.flash_fwd": ("flash",), "nvcc.flash_bwd_dkv": ("flash_bwd",),
    "nvcc.flash_bwd_dq": ("flash_bwd",), "nvcc.paged_decode": ("paged",),
    "nvcc.paged_decode_multi": ("paged_multi",),
    "nvcc.flash_wide": ("flash_wide",)}
CHILD_TIMEOUT = 600


def _child(fn, env_extra, what, cwd=None):
    """``python -c "import chip_smoke; chip_smoke.<fn>()"`` from ``cwd``
    (default: the checkout's root, which is then on ``PYTHONPATH``);
    returns its stdout. A failed or hung child fails the phase."""
    import os

    cwd = cwd or os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "MXNET_GRAPH_PASSES"}
    env["PYTHONPATH"] = cwd + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c",
                              "import chip_smoke; chip_smoke.%s()" % fn],
                             cwd=cwd, env=env, capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        check(False, "%s: the child hung past %d s" % (what, CHILD_TIMEOUT))
    log("  %s: child exit %d after %.1f s" % (what, out.returncode,
                                               time.perf_counter() - t0))
    check(out.returncode == 0, "%s: the child failed: %s %s"
          % (what, out.stdout[-2000:], out.stderr[-3000:]))
    return out.stdout


def graphpass_fit_child():
    """25(a): phase 5's fused fit in a process of its own (the graph
    passes as ``MXNET_GRAPH_PASSES`` says), written to ``SMOKE_OUT``.json
    and .npz: the metric after every step, the host wall per step, the
    K1/K2a/K2b launches, the captured graph's digest and its nodes."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.ops import _build as build
    from mxnet_tpu_torch.symbol import _topo_order

    out = os.environ["SMOKE_OUT"]
    X, Y = lm_stream(128)
    net = mx.models.transformer_lm(**TRAIN)
    # JAX's graph-pass parity case: one fwd+bwd of an executor from a
    # seeded point (the label's probability and every gradient)
    ex = net.simple_bind(ctx=mx.gpu(0), data=(32, TRAIN["seq_len"]),
                         softmax_label=(32, TRAIN["seq_len"]))
    rs = np.random.RandomState(7)
    for name in sorted(ex.arg_dict):
        a = ex.arg_dict[name]
        a[:] = (X[:32] if name == "data" else Y[:32] if name.endswith("label")
                else (rs.randn(*a.shape) * 0.1).astype(np.float32))
    ex.forward(is_train=True)
    ex.backward()
    prob = ex.outputs[0].data.reshape(-1, TRAIN["vocab_size"])
    picked = torch.gather(prob, 1, torch.as_tensor(
        Y[:32].reshape(-1), device=prob.device).long()[:, None])
    step = {"prob": picked.cpu().numpy()}
    step.update({"grad:" + n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if g is not None})
    np.savez(out + "-step.npz", **step)
    del ex, prob, picked
    it = mx.io.NDArrayIter(X, Y, batch_size=32, shuffle=False)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    metric = mx.metric.Perplexity(ignore_label=None)
    stamps, metrics, ppl = [], [], []

    def batch_end(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(metric.get()[1])

    def epoch_end(*_a):
        ppl.append(metric.get()[1])

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=5, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)),
            eval_metric=metric, batch_end_callback=batch_end,
            epoch_end_callback=epoch_end)
    torch.cuda.synchronize()
    tr = mod._fused.trainer
    opt = tr._opt_symbol
    # fwlint: disable=env-raw-read — the raw setting this child ran with, recorded as a label and never parsed
    rec = {"passes": os.environ.get("MXNET_GRAPH_PASSES", "default"),
           "metrics": metrics, "ppl": ppl,
           "step_s": float(np.median(np.diff([t0] + stamps)[1:])),
           "launches": {n: build.KERNELS[n].launches for n in FLASH},
           "captures": tr.captures, "replays": tr.replays,
           "digest": tr._digest, "optimized": opt is not net,
           "nodes": len(_topo_order(opt._entries)),
           "nodes_built": len(_topo_order(net._entries)),
           "fused_nodes": sum(1 for n in _topo_order(opt._entries)
                              if n._extra_attrs.get("__fuse_group__")),
           "eliminated": tel.totals("graphpass.nodes_eliminated")[1],
           "fallbacks": tel.totals("graphpass.fallbacks")[1]}
    np.savez(out + ".npz",
             **{n: a.asnumpy() for n, a in mod.get_params()[0].items()})
    with open(out + ".json", "w") as f:
        json.dump(rec, f)


def _swap_operands(net):
    """``net`` built in the other operand order: every commutative binary
    node's two inputs swapped."""
    from mxnet_tpu_torch.graphpass import passes
    from mxnet_tpu_torch.symbol import _topo_order

    g = net.__copy__()
    n = 0
    for node in _topo_order(g._entries):
        if not node.is_variable and node.op in passes._COMMUTATIVE \
                and len(node.inputs) == 2:
            node.inputs = node.inputs[::-1]
            n += 1
    return g, n


def graphpass_fits(mx, work):
    """25(a): the passes on and off in phase 5's fused fit; returns the
    K1/K2a/K2b launches of both."""
    import os

    net = mx.models.transformer_lm(**TRAIN)
    swapped, n_swapped = _swap_operands(net)
    digest = mx.compileobs.symbol_digest
    d_raw = (digest(net), digest(swapped))
    d_opt = (digest(mx.graphpass.optimize(net)),
             digest(mx.graphpass.optimize(swapped)))
    log("  (a) the LM built in two operand orders (%d commutative nodes "
        "swapped): digests as built %s, after the passes %s"
        % (n_swapped, d_raw, d_opt))
    check(n_swapped > 0 and d_raw[0] != d_raw[1] and d_opt[0] == d_opt[1],
          "25(a): the optimized digest depends on the operand order")
    recs, params, step = {}, {}, {}
    from concurrent.futures import ThreadPoolExecutor

    runs = (("on", None), ("off", "none"))
    with ThreadPoolExecutor(len(runs)) as pool:   # the two fits at once
        list(pool.map(lambda run: _child(
            "graphpass_fit_child",
            dict({"SMOKE_OUT": os.path.join(work, "passes_" + run[0])},
                 **({"MXNET_GRAPH_PASSES": run[1]} if run[1] else {})),
            "(a) passes %s" % run[0]), runs))
    for label, _ in runs:
        path = os.path.join(work, "passes_" + label)
        with open(path + ".json") as f:
            recs[label] = json.load(f)
        with np.load(path + ".npz") as z:
            params[label] = {k: z[k] for k in z.files}
        with np.load(path + "-step.npz") as z:
            step[label] = {k: z[k] for k in z.files}
    on, off = recs["on"], recs["off"]
    for label, r in recs.items():
        log("  (a) passes %s: graph of %d nodes (%d as built), %d in fusion "
            "groups, nodes eliminated %d, fallbacks %d; digest %s; %d "
            "captures, %d replays; host wall per fused step %.5f s; "
            "launches %s" % (label, r["nodes"], r["nodes_built"],
                             r["fused_nodes"], r["eliminated"],
                             r["fallbacks"], r["digest"], r["captures"],
                             r["replays"], r["step_s"], r["launches"]))
        check(r["captures"] == 1 and r["replays"] == 19,
              "25(a) passes %s: not one captured graph" % label)
        check(all(r["launches"][k] == TRAIN["num_layers"] * 20
                  for k in FLASH),
              "25(a) passes %s: launches %s" % (label, r["launches"]))
    check(on["optimized"] and not off["optimized"]
          and on["nodes"] < off["nodes"] and on["fused_nodes"] > 0
          and on["fallbacks"] == 0,
          "25(a): the fused step did not run the optimized graph")
    check(on["digest"] == d_opt[0] and off["digest"] == d_raw[0],
          "25(a): the trainers' digests are not the graphs'")
    def rel_to_bound(a, b):
        """max |a - b| / (1e-5 + 1e-5 |b|): at most 1 within rtol/atol
        1e-5, JAX's test_graphpass.py parity bound."""
        return float(np.max(np.abs(a - b) / (1e-5 + 1e-5 * np.abs(b))))

    one = {k: rel_to_bound(step["on"][k], step["off"][k]) for k in step["off"]}
    worst_one = max(one, key=one.get)
    log("  (a) one fwd+bwd of the LM's executor from a seeded point, passes "
        "on against off: the label's probability and %d gradients, largest "
        "|a-b| / (1e-5 + 1e-5 |b|) %.4f (at %s)"
        % (len(one) - 1, one[worst_one], worst_one))
    check(one[worst_one] <= 1.0,
          "25(a): the passes moved one step's outputs or gradients")
    m_on, m_off = np.array(on["metrics"]), np.array(off["metrics"])
    m_rel = np.abs(m_on - m_off) / np.abs(m_off)
    p_rel = float(abs(on["ppl"][-1] - off["ppl"][-1]) / off["ppl"][-1])
    worst, worst_n = 0.0, None
    for n in params["off"]:
        e = rel_to_bound(params["on"][n], params["off"][n])
        if e > worst:
            worst, worst_n = e, n
    log("  (a) the fits, passes on against off: the metric after step 1 "
        "(the first fused forward) differs by %.3e relative, after each step "
        "%s; perplexity per epoch %s / %s (last %.3e apart); final "
        "parameters: largest |a-b| / (1e-5 + 1e-5 |b|) %.3f at %s; host "
        "wall per fused step %.5f / %.5f s (%.4fx)"
        % (m_rel[0], ["%.1e" % r for r in m_rel],
           ["%.3f" % p for p in on["ppl"]], ["%.3f" % p for p in off["ppl"]],
           p_rel, worst, worst_n, on["step_s"], off["step_s"],
           on["step_s"] / off["step_s"]))
    # past the first steps the two fits part by more than rounding: Adam
    # from its first step moves a weight by ~lr whatever its gradient's
    # size, so a sign that rounding decides decides a full step (on the
    # CPU, which is deterministic, too); the fits are held at their first
    # step and at the perplexity they reach
    check(m_rel[0] <= 1e-5, "25(a): the passes moved the first step's loss")
    for r in recs.values():
        check(all(b < a for a, b in zip(r["ppl"], r["ppl"][1:])),
              "25(a): a fit's perplexity did not fall every epoch")
    check(p_rel <= 1e-2, "25(a): the fits end at other perplexities")
    return {k: on["launches"][k] + off["launches"][k] for k in FLASH}


def warm_start_child():
    """25(b): a process on a fresh copy of the package (its own empty
    ``build/``) and the parent's ``MXNET_COMPILE_CACHE_DIR``: builds every
    kernel, writes its ``nvcc`` runs and cache counts to ``SMOKE_OUT``,
    then holds the kernels ``SMOKE_CHECKS`` names against their plain
    versions with phase 3's bounds."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache, telemetry as tel
    from mxnet_tpu_torch.ops import _build as build
    from mxnet_tpu_torch.ops import attention as A

    here = os.path.dirname(os.path.abspath(__file__))
    check(build.BUILD_DIR.startswith(here) and build.CSRC.startswith(here),
          "25(b): the child's package is not its copy")
    check(not os.path.exists(build.BUILD_DIR) or not any(
        f.endswith(".so") for f in os.listdir(build.BUILD_DIR)),
        "25(b): the child's build directory is not empty")
    t0 = time.perf_counter()
    build.build()
    t_build = time.perf_counter() - t0
    programs = sorted({k.program for k in build.KERNELS.values()})
    rows = [r for r in mx.compileobs.program_table()
            if r["program"].startswith("nvcc.")]
    rec = {"nvcc_runs": build.nvcc_runs, "build_s": t_build,
           "nvcc_seconds": sum(r["compile_seconds"] for r in rows),
           "hits": {p: tel.counter("compile.cache_hits", program=p).value
                    for p in programs},
           "misses": {p: tel.counter("compile.cache_misses", program=p).value
                      for p in programs},
           "errors": tel.totals("compile.cache_errors")[1],
           "stats": compile_cache.stats()}
    with open(os.environ["SMOKE_OUT"], "w") as f:
        json.dump(rec, f)
    for name in os.environ["SMOKE_CHECKS"].split(","):
        if name == "flash":
            check_flash(A)
        elif name == "flash_bwd":
            check_flash_bwd(A)
        elif name == "paged":
            check_paged(A)
        elif name == "paged_multi":
            check_paged_multi(A)
        elif name == "flash_wide":
            check_flash_wide(A, build)
    log("WARM_CHILD_OK")


def _fresh_copy(dst):
    """The package and this script, copied to ``dst`` (no ``build/``)."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    shutil.copytree(os.path.join(root, "mxnet_tpu_torch"),
                    os.path.join(dst, "mxnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    return dst


def warm_start(mx, build, work):
    """25(b): the compile cache's warm start, and a corrupt artifact."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import compile_cache

    programs = sorted({k.program for k in build.KERNELS.values()})
    cold = {r["program"]: r["compile_seconds"]
            for r in mx.compileobs.program_table()
            if r["program"].startswith("nvcc.")}
    stats = compile_cache.stats()
    log("  (b) the main process's cache %s: %d artifacts, %d bytes; its "
        "phase-2 builds (cold, in parallel): %s, summed %.3f s"
        % (stats["dir"], stats["aot_artifacts"], stats["aot_bytes"],
           {p: round(s, 3) for p, s in sorted(cold.items())},
           sum(cold.values())))
    # one library per nvcc source; the cache may also hold phase 28's
    # runtime (program g++.native_rt), whose build still runs beside this
    # phase, so only the nvcc programs' artifacts are counted and copied
    aot = os.path.abspath(os.path.join(compile_cache.cache_dir() or "",
                                       "aot"))
    nvcc_keys = {k.cache_key() for k in build.KERNELS.values()}
    held = set(os.listdir(aot)) if os.path.isdir(aot) else set()
    check(stats["enabled"] and len(nvcc_keys) == len(programs)
          and nvcc_keys <= held,
          "25(b): the cache holds %d of the %d nvcc sources' artifacts"
          % (len(nvcc_keys & held), len(programs)))
    all_checks = ",".join(sorted({c for cs in SOURCE_CHECKS.values()
                                  for c in cs}))
    # the corrupt child reads a copy of the cache with one byte of the
    # fastest build's artifact flipped, so the two children run at once
    victim = min(cold, key=cold.get) if cold else "nvcc.paged_decode"
    kern = next(k for k in build.KERNELS.values() if k.program == victim)
    bad_cc = os.path.join(work, "cc_corrupt")
    shutil.copytree(compile_cache.cache_dir(), bad_cc,
                    ignore=lambda d, names: [
                        n for n in names if os.path.abspath(d) == aot
                        and n not in nvcc_keys])
    path = os.path.join(bad_cc, "aot", kern.cache_key())
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    log("  (b) corrupted one byte of %s's artifact (the fastest build) in "
        "a copy of the cache" % victim)
    jobs = {"warm": (all_checks, {}),
            "corrupt": (",".join(SOURCE_CHECKS[victim]),
                        {"MXNET_COMPILE_CACHE_DIR": bad_cc})}

    def run(label):
        checks, extra = jobs[label]
        dst = _fresh_copy(os.path.join(work, label))
        out = os.path.join(work, label + ".json")
        _child("warm_start_child",
               dict(extra, SMOKE_OUT=out, SMOKE_CHECKS=checks),
               "(b) %s child" % label, cwd=dst)
        with open(out) as f:
            return json.load(f)

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {label: pool.submit(run, label) for label in jobs}
        runs = {label: f.result() for label, f in futures.items()}
    warm, bad = runs["warm"], runs["corrupt"]
    log("  (b) warm child: %d nvcc runs; build() %.3f s; cache hits %s, "
        "misses %s, errors %d; summed nvcc.* seconds cold %.3f, warm %.3f; "
        "K1, K2a, K2b, K3, K4 and the wide route held against their plain "
        "versions (phase 3's checks)"
        % (warm["nvcc_runs"], warm["build_s"], warm["hits"], warm["misses"],
           warm["errors"], sum(cold.values()), warm["nvcc_seconds"]))
    check(warm["nvcc_runs"] == 0
          and all(warm["hits"][p] == 1 for p in programs)
          and not any(warm["misses"].values()) and warm["errors"] == 0,
          "25(b): the warm child was not served by the cache")
    log("  (b) corrupt-artifact child: %d nvcc runs; build() %.3f s; hits "
        "%s, misses %s, errors %d; %s held against its plain version"
        % (bad["nvcc_runs"], bad["build_s"], bad["hits"], bad["misses"],
           bad["errors"], victim))
    check(bad["nvcc_runs"] == 1 and bad["errors"] >= 1
          and bad["misses"][victim] == 1
          and sum(bad["hits"].values()) == len(programs) - 1,
          "25(b): the corrupt artifact was not counted and rebuilt")


def rtc_check(mx):
    """25(c): ``mx.rtc`` on the card against the same push on the CPU."""
    rng = np.random.default_rng(25)
    x_np = rng.standard_normal((64, 1000)).astype(np.float32)
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        x = mx.nd.array(x_np, ctx=ctx)
        y = mx.nd.zeros(x_np.shape, ctx=ctx)
        k = mx.rtc.Rtc("smoke_affine", [("x", x)], [("y", y)],
                       "y = x * 2 + 1")
        k.push([x], [y], grid_dims=(1, 1, 1), block_dims=(256, 1, 1))
        k.push([x], [y])
        check(torch.device(y.context) == torch.device(ctx),
              "25(c): the output left %s" % ctx)
        got[torch.device(ctx).type] = y.asnumpy()
    row = next(r for r in mx.compileobs.program_table()
               if r["program"] == "rtc.smoke_affine")
    same = np.array_equal(got["cuda"], got["cpu"])
    log("  (c) rtc 'y = x * 2 + 1' on cuda:0 against the CPU: %s; registry "
        "row: %d compiles, %d runs, %.6f s compile"
        % ("bitwise equal" if same else "differs", row["compile_count"],
           row["run_count"], row["compile_seconds"]))
    check(same, "25(c): rtc differs between the card and the CPU")
    check(row["compile_count"] == 2 and row["run_count"] == 2,
          "25(c): the registry row %s" % row)


def cluster_tools(c_run):
    """25(d): phase 24(c)'s run through ``mxtop --once`` (taken while it
    trained) and ``trace_merge``."""
    import os

    frame = c_run["mxtop"]
    check(frame is not None, "25(d): rank 0 never ran mxtop")
    for line in frame["out"].splitlines():
        log("  (d) mxtop | %s" % line)
    rows = {l.split()[0]: l.split() for l in frame["out"].splitlines()
            if l[:1].isdigit()}
    check(frame["rc"] == 0 and sorted(rows) == ["0", "1"]
          and all(float(rows[r][3]) > 0 for r in rows),
          "25(d): mxtop --once did not show both ranks' step times: %s %s"
          % (frame["out"], frame["err"]))
    trace_dir = c_run["trace_dir"]
    merged = os.path.join(os.path.dirname(trace_dir), "merged.json")
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m",
                          "mxnet_tpu_torch.tools.trace_merge", "-o", merged,
                          "--validate", trace_dir], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    for line in out.stdout.splitlines():
        log("  (d) trace_merge | %s" % line)
    check(out.returncode == 0, "25(d): trace_merge failed: %s"
          % out.stderr[-2000:])
    with open(merged) as f:
        trace = json.load(f)
    names = sorted(e["args"]["name"] for e in trace["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "process_name")
    offs = trace["otherData"]["clock_offsets"]
    one = offs.get("telemetry.1.jsonl") or {}
    wall = c_run["step_wall"]
    log("  (d) merged trace: lanes %s, %d events, %d bytes; rank 1's sink "
        "offset %s s, residual spread %s s over %s sync points; worker "
        "0's median host wall per step %.5f s"
        % (names, len(trace["traceEvents"]), os.path.getsize(merged),
           one.get("offset_s"), one.get("residual_s"),
           one.get("sync_points"), wall))
    check(names == ["cluster", "rank 0", "rank 1"],
          "25(d): the merged trace's lanes are %s" % names)
    check(one.get("sync_points", 0) >= DIST_EPOCHS * 4
          and one.get("residual_s") is not None
          and one["residual_s"] < wall,
          "25(d): the lanes are not aligned within a step: %s" % one)


def run_compiler_phase(mx, build, card, work, straggle):
    """Phase 25 (see the module docstring), with phase 24(c)'s cluster
    (``straggle``: the future of :func:`straggler_run`) running beside
    (a)-(c): nothing in one reads the other, and (d) reads (c)'s traces
    once it is done. Returns the K1/K2a/K2b launches of 25's fits and
    24(c)'s run."""
    t_phase = time.time()
    log("  (a) the graph passes in phase 5's fused fit, on and off")
    launches = graphpass_fits(mx, work)
    log("  (b) the compile cache's warm start")
    warm_start(mx, build, work)
    log("  (c) mx.rtc")
    rtc_check(mx)
    c_launches, c_run = straggle.result()
    log("  24(c), beside (a)-(c), launched %s" % c_launches)
    for k in FLASH:
        launches[k] += c_launches[k]
    log("  (d) the cluster tools on phase 24(c)'s run")
    cluster_tools(c_run)
    log("  phase 25: %.1f s; K1/K2a/K2b launches %s"
        % (time.time() - t_phase, launches))
    return launches


# ------------------------------------------- A8a: the C boundary (26)
CAPI_CLIENTS = "mxnet_tpu_torch/csrc/capi/clients"
CAPI_PRED_BATCH = 2        # the LM predicted at batch 2 x 128 (8.2M logits)
CAPI_PRED_BATCH2 = 3       # the second create, at a new batch
CAPI_PARTIAL = "lm_head_output"   # 26(a)'s internal output
CAPI_REPS = 20             # timed predict calls
CAPI_TRAIN_BATCH = 8       # the C trainer's fixed batch of 8 x 128 tokens
CAPI_STEPS = 20
# plain SGD on SoftmaxOutput's gradients, summed over the 1024 rows
CAPI_LR = 1e-4
CAPI_TIMEOUT = 300
CAPI_DEV = "gpu"           # the C++ trainer's Context("gpu", 0)


def capi_check(lib, rc, what):
    """A C entry point's return code: -1 stops the phase with
    ``MXGetLastError()``'s text."""
    if rc != 0:
        raise RuntimeError("chip_smoke: %s returned %d: %s" % (
            what, rc, lib.MXGetLastError().decode(errors="replace")))


def capi_compile(work):
    """Phase 26's builds, made beside phase 2's ``nvcc`` runs: the port's C
    library (``_capi.build``: a failure raises), the variant this process
    loads (the same one where this Python links libpython), and the
    phase's clients compiled against them in parallel: ``predict_client``
    and ``lm_trainer`` (executables) and ``lm_trainer.so`` linked to the
    loaded variant. Returns (paths, seconds)."""
    import os

    from mxnet_tpu_torch import _capi

    t0 = time.perf_counter()
    _capi.build()
    loaded = os.path.dirname(_capi.build(_capi._process_has_libpython()))
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, CAPI_CLIENTS)
    out = os.path.join(work, "capi")
    os.makedirs(out, exist_ok=True)
    paths = {"predict_client": os.path.join(out, "predict_client"),
             "lm_trainer": os.path.join(out, "lm_trainer"),
             "lm_trainer.so": os.path.join(out, "lm_trainer.so")}
    inproc = ["-I" + _capi.include_dir(), "-L" + loaded, "-lmxtpu_predict",
              "-Wl,-rpath," + loaded]
    cmds = [
        ["gcc", "-O2", os.path.join(src, "predict_client.c"), "-o",
         paths["predict_client"]] + _capi.client_flags(),
        ["g++", "-O2", "-std=c++17", os.path.join(src, "lm_trainer.cpp"),
         "-o", paths["lm_trainer"]] + _capi.client_flags(),
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         os.path.join(src, "lm_trainer.cpp"), "-o", paths["lm_trainer.so"]]
        + inproc]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    for cmd, p in zip(cmds, procs):
        text = p.communicate(timeout=CAPI_TIMEOUT)[0]
        check(p.returncode == 0, "compiling %s failed:\n%s"
              % (os.path.basename(cmd[-1] if cmd[0] == "gcc" else cmd[3]),
                 text[-3000:]))
    return paths, time.perf_counter() - t0


def capi_build(compiled):
    """The library :func:`capi_compile` built for this process, loaded,
    with the entry points this phase calls declared. Returns (loaded
    library, the clients' paths)."""
    import ctypes

    from mxnet_tpu_torch import _capi

    paths, seconds = compiled
    t0 = time.perf_counter()
    lib = _capi.load()
    c = ctypes
    lib.MXGetLastError.restype = c.c_char_p
    for name in ("MXPredCreate", "MXPredCreatePartialOut", "MXPredSetInput",
                 "MXPredForward", "MXPredGetOutputShape", "MXPredGetOutput",
                 "MXPredFree"):
        getattr(lib, name).restype = c.c_int
    log("  the port's C library %s (loaded here in %.2f s: %s; %s) and three "
        "clients built in phase 2 in %.2f s"
        % (_capi.build(), time.perf_counter() - t0, lib._name,
           "libpython linked" if lib._name == _capi.build()
           else "CPython from this process", seconds))
    return lib, paths


class CPredictor:
    """``MXPredCreate`` (or ``MXPredCreatePartialOut``) through ctypes
    in this process, with the input shapes ``shapes`` (name -> shape,
    "data" first: the input ``predict`` sets); every call is checked."""

    def __init__(self, lib, sym_json, params, shapes, outputs=()):
        import ctypes as c

        self.lib, self.h = lib, c.c_void_p()
        keys = (c.c_char_p * len(shapes))(*[k.encode() for k in shapes])
        bounds = np.cumsum([0] + [len(s) for s in shapes.values()])
        indptr = (c.c_uint * len(bounds))(*[int(b) for b in bounds])
        flat = [int(d) for s in shapes.values() for d in s]
        dims = (c.c_uint * len(flat))(*flat)
        common = (sym_json.encode(), params, len(params), 2, 0, len(shapes),
                  keys, indptr, dims)
        if outputs:
            okeys = (c.c_char_p * len(outputs))(*[o.encode() for o in outputs])
            capi_check(lib, lib.MXPredCreatePartialOut(
                *common, len(outputs), okeys, c.byref(self.h)),
                "MXPredCreatePartialOut")
        else:
            capi_check(lib, lib.MXPredCreate(*common, c.byref(self.h)),
                       "MXPredCreate")
        ptr, ndim = c.POINTER(c.c_uint)(), c.c_uint()
        capi_check(lib, lib.MXPredGetOutputShape(
            self.h, 0, c.byref(ptr), c.byref(ndim)), "MXPredGetOutputShape")
        self.out_shape = tuple(ptr[i] for i in range(ndim.value))

    def predictor(self):
        """The Python ``Predictor`` behind the handle (the shim's handle
        points at a struct whose first member is that object)."""
        import ctypes as c

        return c.cast(c.cast(self.h, c.POINTER(c.c_void_p))[0],
                      c.py_object).value

    def predict(self, x):
        """MXPredSetInput (float32), MXPredForward, MXPredGetOutput."""
        import ctypes as c

        x = np.ascontiguousarray(x, np.float32)
        capi_check(self.lib, self.lib.MXPredSetInput(
            self.h, b"data", x.ctypes.data_as(c.POINTER(c.c_float)),
            x.size), "MXPredSetInput")
        capi_check(self.lib, self.lib.MXPredForward(self.h), "MXPredForward")
        out = np.empty(self.out_shape, np.float32)
        capi_check(self.lib, self.lib.MXPredGetOutput(
            self.h, 0, out.ctypes.data_as(c.POINTER(c.c_float)), out.size),
            "MXPredGetOutput")
        return out

    def free(self):
        capi_check(self.lib, self.lib.MXPredFree(self.h), "MXPredFree")


def median_ms(fn, reps=CAPI_REPS):
    """Median host wall of ``fn()`` (which ends with a read to the host)
    over ``reps`` calls after one untimed call."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _save_checkpoint(mx, path, sym, arg_params, aux_params=None):
    """``path``-symbol.json and ``path``-0000.params; returns (json,
    params bytes)."""
    blob = {"arg:%s" % k: mx.nd.array(v, ctx=mx.cpu())
            for k, v in arg_params.items()}
    blob.update({"aux:%s" % k: mx.nd.array(v, ctx=mx.cpu())
                 for k, v in (aux_params or {}).items()})
    mx.nd.save(path + "-0000.params", blob)
    sym.save(path + "-symbol.json")
    with open(path + "-0000.params", "rb") as f:
        return sym.tojson(), f.read()


def capi_predict_in_process(mx, build, lib, ckpt, tokens):
    """26(a): the LM's checkpoint through MXPredCreate ... MXPredGetOutput
    in this process, against the Python Predictor on the card (bitwise)
    and on the CPU (OUT_REL_TOL); K1's launches per forward; the partial
    output and a second create at a new batch, each against the Python
    Predictor. Returns (logits, in-process ms, Python ms, K1 launches of
    the C calls)."""
    from mxnet_tpu_torch.predict import Predictor

    sym_json, params = ckpt
    L, T = TRAIN["num_layers"], TRAIN["seq_len"]
    shape = (CAPI_PRED_BATCH, T)
    # the label goes through a Reshape: its shape is given, not inferred
    shapes = {"data": shape, "softmax_label": shape}
    py = Predictor(sym_json, params, input_shapes=shapes)
    check(py.ctx.type == "cuda" and py._exe.arg_dict["data"].context.type
          == "cuda", "the Predictor with no context landed on %s" % py.ctx)
    want = py.forward(data=tokens).get_output(0)
    cp = CPredictor(lib, sym_json, params, shapes)
    ctx = cp.predictor()._exe.arg_dict["data"].context
    check(ctx.type == "cuda", "the C predictor landed on %s" % ctx)
    check(cp.out_shape == want.shape, "MXPredGetOutputShape before the first "
          "forward: %s, want %s" % (cp.out_shape, want.shape))
    _zero(build)
    got = cp.predict(tokens)
    k1 = k1_total = _counts(build)["flash_fwd"]
    check(k1 == L, "one MXPredForward launched K1 %d times, want %d" % (k1, L))
    check(np.isfinite(got).all(), "the C predictor's logits are not finite")
    check(np.array_equal(got, want), "the C predictor's logits differ from "
          "the Python Predictor's on the card: largest %.3e"
          % float(np.abs(got - want).max()))
    with mx.cpu():
        cpu = Predictor(sym_json, params, input_shapes=shapes)
    ref = cpu.forward(data=tokens).get_output(0)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(err <= OUT_REL_TOL, "the C predictor on the card against the "
          "Predictor on the CPU: %.3e of the largest (tol %.0e)"
          % (err, OUT_REL_TOL))
    _zero(build)
    c_ms = median_ms(lambda: cp.predict(tokens))
    k1 = _counts(build)["flash_fwd"]
    k1_total += k1
    check(k1 == L * (CAPI_REPS + 1), "%d MXPredForward calls launched K1 %d "
          "times" % (CAPI_REPS + 1, k1))
    py_ms = median_ms(lambda: py.forward(data=tokens).get_output(0))
    PHASE_NOTES["capi_predict_ms"] = c_ms
    log("  (a) MXPredCreate/SetInput/Forward/GetOutput in this process, the "
        "LM at batch %d x %d (output %s): bitwise equal to the Python "
        "Predictor on the card; %.3e of the largest against the CPU (tol "
        "%.0e); K1 %d launches in %d forwards (%d layers); predict call "
        "(set input, forward, read output) median %.3f ms through the C API, "
        "%.3f ms through the Python Predictor"
        % (shape[0], T, want.shape, err, OUT_REL_TOL, k1, CAPI_REPS + 1, L,
           c_ms, py_ms))
    cp.free()
    # the partial output: the logits before the softmax
    part = CPredictor(lib, sym_json, params, shapes, outputs=[CAPI_PARTIAL])
    pw = Predictor(sym_json, params, input_shapes=shapes,
                   output_names=[CAPI_PARTIAL]).forward(data=tokens)
    _zero(build)
    pg = part.predict(tokens)
    k1_total += _counts(build)["flash_fwd"]
    check(np.array_equal(pg, pw.get_output(0)), "MXPredCreatePartialOut(%s) "
          "differs from Predictor(output_names=...)" % CAPI_PARTIAL)
    part.free()
    # a second create at a new batch, against the Python Predictor reshaped
    tokens2 = np.concatenate([tokens, tokens[:1]])[:CAPI_PRED_BATCH2]
    shape2 = (CAPI_PRED_BATCH2, T)
    second = CPredictor(lib, sym_json, params,
                        {"data": shape2, "softmax_label": shape2})
    _zero(build)
    g2 = second.predict(tokens2)
    k1_total += _counts(build)["flash_fwd"]
    w2 = py.reshape({"data": shape2, "softmax_label": shape2}).forward(
        data=tokens2).get_output(0)
    check(np.array_equal(g2, w2), "the C predictor at batch %d differs from "
          "the reshaped Predictor" % CAPI_PRED_BATCH2)
    second.free()
    log("  (a) MXPredCreatePartialOut(%s) %s and a second MXPredCreate at "
        "batch %d %s: each bitwise equal to the Python Predictor (the "
        "second against Predictor.reshape)"
        % (CAPI_PARTIAL, pg.shape, CAPI_PRED_BATCH2, g2.shape))
    return got, c_ms, py_ms, k1_total


def capi_trainer_in_process(mx, build, paths, files, init):
    """26(c) in this process: the C++ trainer's lmt_* entry points through
    ctypes, step by step with the launch counters read after each; step
    1's gradients against the port's Python Executor on the card
    (bitwise); the loss falling. Returns the per-step launches and the
    mean step ms, with the Python Executor's."""
    import ctypes as c

    L, T, B = TRAIN["num_layers"], TRAIN["seq_len"], CAPI_TRAIN_BATCH
    so = c.CDLL(paths["lm_trainer.so"], mode=__import__("os").RTLD_LOCAL)
    so.lmt_step.argtypes = [c.c_float, c.c_int, c.POINTER(c.c_double)]
    rc = so.lmt_create(files["symbol"].encode(), files["init"].encode(),
                       files["data"].encode(), files["label"].encode(), B, T,
                       CAPI_DEV.encode())
    check(rc == 0, "lmt_create returned %d (its message is on stderr)" % rc)
    per_step, losses = [], {}
    loss = c.c_double()
    for s in range(1, CAPI_STEPS + 1):
        _zero(build)
        rc = so.lmt_step(CAPI_LR, int(s in (1, CAPI_STEPS)), c.byref(loss))
        check(rc == 0, "lmt_step %d returned %d" % (s, rc))
        per_step.append(_counts(build))
        if s in (1, CAPI_STEPS):
            losses[s] = loss.value
        if s == 1:
            check(so.lmt_save_grads(files["grads"].encode()) == 0,
                  "lmt_save_grads failed")
    check(so.lmt_sync() == 0, "lmt_sync failed")
    for s, n in enumerate(per_step, 1):
        check(all(n[k] == L for k in FLASH), "the C trainer's step %d "
              "launched %s, want %d of each of K1/K2a/K2b" % (s, n, L))
    check(losses[CAPI_STEPS] < losses[1] and all(
        math.isfinite(v) for v in losses.values()),
        "the C trainer's loss did not fall: %s" % losses)
    # the step timed as the subprocess times it: steps that read nothing
    # back, up to a read that waits for the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAPI_STEPS - 2):
        check(so.lmt_step(CAPI_LR, 0, c.byref(loss)) == 0, "lmt_step failed")
    check(so.lmt_sync() == 0, "lmt_sync failed")
    c_ms = (time.perf_counter() - t0) * 1e3 / (CAPI_STEPS - 2)
    so.lmt_free()
    # the same step through the port's Python Executor
    X = np.fromfile(files["data"], np.float32).reshape(B, T)
    Y = np.fromfile(files["label"], np.float32).reshape(B, T)
    sym = mx.sym.load(files["symbol"])
    ex = sym.simple_bind(mx.gpu(0), grad_req="write", data=(B, T),
                         softmax_label=(B, T))
    for k, v in init.items():
        ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = X
    ex.arg_dict["softmax_label"][:] = Y
    ex.forward(is_train=True)
    ex.backward()
    got = mx.nd.load(files["grads"])
    diff = {k: float(np.abs(got["grad:" + k].asnumpy()
                            - ex.grad_dict[k].asnumpy().ravel()).max())
            for k in init}
    worst = max(diff, key=diff.get)
    check(all(v == 0 and np.array_equal(
        got["grad:" + k].asnumpy(), ex.grad_dict[k].asnumpy().ravel())
        for k, v in diff.items()),
        "the C trainer's step-1 gradients differ from the Python Executor's: "
        "largest %.3e (%s)" % (diff[worst], worst))

    def py_step():
        ex.arg_dict["data"][:] = X
        ex.arg_dict["softmax_label"][:] = Y
        ex.forward(is_train=True)
        ex.backward()
        with torch.no_grad():
            for k in init:
                w = ex.arg_dict[k]
                w[:] = w.data - CAPI_LR * ex.grad_dict[k].data

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAPI_STEPS - 2):
        py_step()
    torch.cuda.synchronize()
    py_ms = (time.perf_counter() - t0) * 1e3 / (CAPI_STEPS - 2)
    del ex
    log("  (c) the C++ trainer (mxnet_cpp.hpp, Context(\"gpu\", 0)) in this "
        "process: %d steps of forward, backward, MXExecutorSGDUpdate (lr "
        "%g) at batch %d x %d; K1/K2a/K2b launches per step %s; step 1's "
        "gradients of %d parameters bitwise equal to the Python Executor's; "
        "loss %.6f -> %.6f; mean step %.3f ms (Python Executor, the same "
        "update: %.3f ms)"
        % (CAPI_STEPS, CAPI_LR, B, T,
           sorted({tuple(n[k] for k in FLASH) for n in per_step}),
           len(init), losses[1], losses[CAPI_STEPS], c_ms, py_ms))
    return per_step, losses, c_ms, py_ms


def _client_start(cmd):
    """A compiled client started in a process of its own: (the process,
    its start time); :func:`_client_wait` collects it."""
    from mxnet_tpu_torch import _capi

    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env=_capi.client_env()), time.perf_counter())


def _client_wait(started, what):
    """(stdout, wall seconds) of a :func:`_client_start` process; a
    failure stops the phase with its output."""
    proc, t0 = started
    out, err = proc.communicate(timeout=CAPI_TIMEOUT)
    check(proc.returncode == 0, "%s exited %d:\n%s\n%s"
          % (what, proc.returncode, out[-2000:], err[-4000:]))
    return out, time.perf_counter() - t0


def _resnet_checkpoint(mx, path):
    """ResNet-50 at bench.py's configuration, Xavier-initialized from a
    seed on the card, as a checkpoint; float32."""
    net = mx.models.resnet(**RESNET)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (CAPI_PRED_BATCH,) + RESNET_SHAPE)],
             label_shapes=[("softmax_label", (CAPI_PRED_BATCH,))],
             for_training=False)
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(26)))
    args, auxs = mod.get_params()
    return _save_checkpoint(mx, path, net,
                            {k: v.asnumpy() for k, v in args.items()},
                            {k: v.asnumpy() for k, v in auxs.items()})


def run_capi_phase(mx, build, card, t_params, work, compiled):
    """Phase 26 (see the module docstring; ``compiled``: phase 2's
    :func:`capi_compile`); returns the K1/K2a/K2b launches of its main
    paths."""
    import os

    from mxnet_tpu_torch.predict import Predictor

    t_phase = time.perf_counter()
    lib, paths = capi_build(compiled)
    d = os.path.join(work, "capi")
    L, T = TRAIN["num_layers"], TRAIN["seq_len"]
    total = {k: 0 for k in FLASH}

    # the inputs of every part first: (b)'s and (c)'s client processes run
    # beside (a) and (c)'s in-process run (no check holds a time)
    lm_sym = mx.models.transformer_lm(**TRAIN)
    ckpt = _save_checkpoint(mx, os.path.join(d, "lm"), lm_sym, t_params)
    X, _ = lm_stream(CAPI_PRED_BATCH, seed=26)
    X.tofile(os.path.join(d, "lm_tokens.f32"))
    rn_json, rn_params = _resnet_checkpoint(mx, os.path.join(d, "resnet"))
    imgs = np.random.RandomState(26).uniform(
        -1, 1, (RESNET_BATCH,) + RESNET_SHAPE).astype(np.float32)
    imgs.tofile(os.path.join(d, "images.f32"))
    init_mod = mx.mod.Module(lm_sym, context=mx.gpu(0))
    init_mod.bind(data_shapes=[("data", (CAPI_TRAIN_BATCH, T))],
                  label_shapes=[("softmax_label", (CAPI_TRAIN_BATCH, T))])
    init_mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(26)))
    init = {k: v.asnumpy() for k, v in init_mod.get_params()[0].items()}
    del init_mod
    _save_checkpoint(mx, os.path.join(d, "lm_init"), lm_sym, init)
    tx, ty = lm_stream(CAPI_TRAIN_BATCH, seed=27)
    files = {"symbol": os.path.join(d, "lm_init-symbol.json"),
             "init": os.path.join(d, "lm_init-0000.params"),
             "data": os.path.join(d, "train_data.f32"),
             "label": os.path.join(d, "train_label.f32"),
             "grads": os.path.join(d, "grads_in_process.params")}
    tx.tofile(files["data"])
    ty.tofile(files["label"])
    # (b) the compiled C client in a process of its own: the LM, then
    # ResNet-50 scoring for (d)
    predict_client = _client_start(
        [paths["predict_client"], str(CAPI_REPS),
         os.path.join(d, "lm-symbol.json"), os.path.join(d, "lm-0000.params"),
         os.path.join(d, "lm_tokens.f32"), os.path.join(d, "lm_out.f32"),
         "2", str(CAPI_PRED_BATCH), str(T),
         "+softmax_label", "2", str(CAPI_PRED_BATCH), str(T),
         os.path.join(d, "resnet-symbol.json"),
         os.path.join(d, "resnet-0000.params"),
         os.path.join(d, "images.f32"), os.path.join(d, "resnet_out.f32"),
         "4", str(RESNET_BATCH)] + [str(x) for x in RESNET_SHAPE])
    # (c)'s C++ trainer as a process of its own
    sub_grads = os.path.join(d, "grads_process.params")
    trainer_client = _client_start(
        [paths["lm_trainer"], files["symbol"], files["init"], files["data"],
         files["label"], str(CAPI_TRAIN_BATCH), str(T), str(CAPI_STEPS),
         repr(CAPI_LR), CAPI_DEV, sub_grads])

    # (a) phase 5's trained LM as a checkpoint, predicted in this process
    logits, c_ms, _, total["flash_fwd"] = capi_predict_in_process(
        mx, build, lib, ckpt, X)

    _zero(build)
    out, wall = _client_wait(predict_client, "the C predict client")
    check(sum(_counts(build).values()) == 0, "the subprocess counted here")
    lines = dict((tuple(l.split()[:3]), l.split()[3:])
                 for l in out.splitlines() if l.startswith("JOB "))
    sub_logits = np.fromfile(os.path.join(d, "lm_out.f32"), np.float32)
    check(sub_logits.size == logits.size and np.array_equal(
        sub_logits.reshape(logits.shape), logits),
        "the C client process's logits differ from the in-process C "
        "predictor's")
    sub_ms = float(lines[("JOB", "0", "MEDIAN_MS")][0])
    log("  (b) predict_client.c in its own process (%.1f s, no Python of its "
        "own; the port's interpreter embedded): the LM's logits bitwise "
        "equal to (a)'s; predict call median %.3f ms, against %.3f ms in "
        "this process through the C API (%s)" % (wall, sub_ms, c_ms, card))

    # (c) the C++ trainer: in process, and as the process started above
    per_step, losses, step_ms, py_step_ms = capi_trainer_in_process(
        mx, build, paths, files, init)
    for n in per_step:
        for k in FLASH:
            total[k] += n[k]
    out, wall = _client_wait(trainer_client, "the C++ trainer")
    # "LOSS <step> <value>" and "STEP_MS <value>" as LOSS<step>, STEP_MS
    sub = {"".join(l.split()[:-1]): float(l.split()[-1])
           for l in out.splitlines() if l.startswith(("LOSS", "STEP_MS"))}
    g_in, g_sub = mx.nd.load(files["grads"]), mx.nd.load(sub_grads)
    check(sorted(g_in) == sorted(g_sub) and all(
        np.array_equal(g_in[k].asnumpy(), g_sub[k].asnumpy()) for k in g_in),
        "the C++ trainer's process wrote other step-1 gradients than its "
        "in-process run")
    check(sub["LOSS%d" % CAPI_STEPS] < sub["LOSS1"],
          "the C++ trainer process's loss did not fall: %s" % sub)
    log("  (c) lm_trainer.cpp in its own process (%.1f s): step-1 gradients "
        "bitwise equal to the in-process run's; loss %.6f -> %.6f (in "
        "process %.6f -> %.6f); mean step %.3f ms (in process %.3f, Python "
        "Executor %.3f) (%s)"
        % (wall, sub["LOSS1"], sub["LOSS%d" % CAPI_STEPS], losses[1],
           losses[CAPI_STEPS], sub["STEP_MS"], step_ms, py_step_ms, card))

    # (d) ResNet-50 scoring through MXPredForward, float32, batch 32
    rn_sub = np.fromfile(os.path.join(d, "resnet_out.f32"), np.float32)
    rn_py = Predictor(rn_json, rn_params,
                      input_shapes={"data": (RESNET_BATCH,) + RESNET_SHAPE})
    want = rn_py.forward(data=imgs).get_output(0)
    check(np.isfinite(want).all() and rn_sub.size == want.size
          and np.array_equal(rn_sub.reshape(want.shape), want),
          "ResNet-50's scores from the C client differ from the Python "
          "Predictor's")
    py_rn = median_ms(lambda: rn_py.forward(data=imgs).get_output(0))
    del rn_py
    c_rn = CPredictor(lib, rn_json, rn_params,
                      {"data": (RESNET_BATCH,) + RESNET_SHAPE})
    in_rn = median_ms(lambda: c_rn.predict(imgs))
    c_rn.free()
    sub_rn = float(lines[("JOB", "1", "MEDIAN_MS")][0])
    log("  (d) ResNet-%d scoring, float32, batch %d x %s: the C client's "
        "scores bitwise equal to the Python Predictor's; predict call "
        "median %.3f ms = %.1f images/s (C client process), %.3f ms = %.1f "
        "images/s (C API in this process), %.3f ms = %.1f images/s (Python "
        "Predictor) (%s)"
        % (RESNET["num_layers"], RESNET_BATCH, RESNET_SHAPE, sub_rn,
           RESNET_BATCH * 1e3 / sub_rn,
           in_rn, RESNET_BATCH * 1e3 / in_rn, py_rn,
           RESNET_BATCH * 1e3 / py_rn, card))
    torch.cuda.empty_cache()
    log("  phase 26: %.1f s; K1/K2a/K2b launches on its main paths %s"
        % (time.perf_counter() - t_phase, total))
    return total


# -------------------------------- analysis/: sanitizer and witness (phase 27)
SANITIZER_COUNTERS = tuple("engine.sanitizer." + k for k in (
    "undeclared_mutation", "const_write", "use_after_free",
    "undeclared_read"))
SERVING_LOCK = "mxnet_tpu_torch.serving.engine.ServingEngine._lock"


def static_lock_edges():
    """The static lock graph's edges over this checkout's
    ``mxnet_tpu_torch/`` (``lockgraph.build``): the witness's seed."""
    import os

    from mxnet_tpu_torch.analysis import fwlint, lockgraph

    root = os.path.dirname(os.path.abspath(__file__))
    ctxs, errors = fwlint.load_contexts(["mxnet_tpu_torch"], root)
    check(not errors, "the package does not parse: %s" % errors)
    return lockgraph.build(ctxs).edge_set()


def sanitized_fit(build, card, static, dist_params, dist_step_s):
    """27(a): phase 21(b)'s fused dist_sync fit with the sanitizer and the
    witness strict in every process, each worker's witness seeded with
    ``static``; returns the kernels' launches."""
    import os
    import tempfile

    L = TRAIN["num_layers"]
    steps = DIST_EPOCHS * (DIST_SEQS // 2 // DIST_BATCH)
    recs, params = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        edges = os.path.join(tmp, "static_edges.json")
        with open(edges, "w") as f:
            json.dump(sorted(static), f)
        out, err = run_cluster(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.dist_lm_worker()"],
            {"SMOKE_OUT": tmp, "SMOKE_STATIC_EDGES": edges,
             "MXNET_ENGINE_SANITIZER": "strict",
             "MXNET_LOCK_WITNESS": "strict"}, "dist_sync sanitized")
        for r in (0, 1):
            with open(os.path.join(tmp, "sanitized-%d.json" % r)) as f:
                recs[r] = json.load(f)
            with np.load(os.path.join(tmp, "sanitized-%d.npz" % r)) as z:
                params[r] = {k: z[k] for k in z.files}
    for name in ("EngineSanitizerError", "LockWitnessError"):
        check(name not in out and name not in err,
              "27(a): %s in the cluster's logs: %s" % (name, err[-3000:]))
    launches = dict.fromkeys(build.KERNELS, 0)
    for r, rec in sorted(recs.items()):
        log("  [worker %d] modes (sanitizer, witness) %s; %d steps, host wall "
            "per step %.5f s (21(b)'s fused: %.5f s); counters %s; launches %s"
            % (r, rec["modes"], rec["steps"], rec["step_s"], dist_step_s,
               rec["counters"], {n: rec["launches"][n] for n in FLASH}))
        check(rec["modes"] == ["strict", "strict"],
              "27(a) worker %d ran without strict checkers" % r)
        check(rec["fused"] and rec["captures"] == 1
              and rec["replays"] == steps - 1 and rec["steps"] == steps,
              "27(a) worker %d did not replay one gradient graph" % r)
        bad = {n: v for n, v in rec["counters"].items()
               if n != "engine.pushes" and v != 0}
        check(not bad, "27(a) worker %d: violations %s" % (r, bad))
        check(rec["counters"]["engine.pushes"] > 0,
              "27(a) worker %d pushed nothing through the engine" % r)
        for name in FLASH:
            n = rec["launches"][name]
            check(n == L * steps, "27(a) worker %d: %s launched %d times in "
                  "%d steps" % (r, name, n, steps))
            launches[name] += n
    differ = [k for k in params[0]
              if not np.array_equal(params[0][k], params[1][k])]
    check(not differ, "27(a): the workers' parameters differ in %s" % differ)
    diff, tol = _params_close(params[0], dist_params, RESUME_TOL)
    log("  the two workers' final parameters bitwise equal; largest "
        "difference from 21(b)'s fused run %.3g of the largest parameter "
        "(bound %g)" % (diff, tol))
    check(diff <= tol, "27(a): the sanitized fit moved from 21(b)'s by %g"
          % diff)
    return launches


def witnessed_serving(S, M, build, static, serve_ref):
    """27(b): phase 4's engine and prompts with the witness strict and
    seeded in this process; returns the kernels' launches."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.analysis import witness

    ref_launches, ref_streams = serve_ref
    witness.configure("strict")
    witness.seed_static(static)
    witness.reset_observations()
    held = tel.histogram(witness.HELD_HISTOGRAM, lock=SERVING_LOCK)
    held0, viol0 = held.count, tel.counter(witness.COUNTER_ORDER).value
    try:
        cfg = S.ServingConfig(**SERVE)
        eng = S.ServingEngine(cfg, arg_params=M.random_params(cfg, seed=0),
                              device="cuda")
        check(type(eng._lock).__name__ == "_WitnessedLock",
              "27(b): the engine's lock is not witnessed")
        eng.warmup()
        for k in build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 16) for p in prompt_mix(cfg.vocab_size)]
        steps = 0
        while any(not r.finished() for r in reqs):
            eng.step()
            steps += 1
            check(steps < 10000, "27(b): serving did not finish")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in build.KERNELS.items()}
        observed = witness.observed_edges()
    finally:
        witness.configure(None)
        witness.seed_static(None)
        witness.reset_observations()
    viol = tel.counter(witness.COUNTER_ORDER).value - viol0
    log("  %d requests in %d steps, %.3f s; observed edges %s (all static: "
        "%s); %s held %d times; violations %d; launches %s"
        % (len(reqs), steps, wall, sorted(observed), observed <= static,
           SERVING_LOCK, held.count - held0, viol,
           {n: launches[n] for n in ("flash_fwd", "paged_decode")}))
    check([list(r.generated) for r in reqs] == ref_streams,
          "27(b): the token streams differ from phase 4's")
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] == ref_launches[name] > 0,
              "27(b): %s launched %d times, phase 4 %d"
              % (name, launches[name], ref_launches[name]))
    check(observed <= static, "27(b): edges outside the static graph: %s"
          % sorted(observed - static))
    check(held.count > held0, "27(b): no hold of the engine lock observed")
    check(viol == 0, "27(b): %d lock-order violations" % viol)
    return launches


def analysis_negatives(mx, static):
    """27(c): a const write under ThreadedEngine and an off-graph nesting
    must each raise its classified error."""
    import threading

    from mxnet_tpu_torch.analysis import sanitizer, witness

    eng = mx.engine.ThreadedEngine()
    a = mx.nd.ones((256, 256), ctx=mx.gpu(0))
    va = eng.new_variable()
    sanitizer.attach(a, va)
    sanitizer.configure("strict")
    try:
        eng.push(lambda: a._set_data(a.data + 1), const_vars=[va])
        try:
            eng.wait_for_var(va)
            kind = None
        except sanitizer.EngineSanitizerError as e:
            kind = e.kind
    finally:
        sanitizer.configure(None)
        eng.wait_all()
    log("  ThreadedEngine, a card NDArray written under a const declaration: "
        "EngineSanitizerError(%r) at wait_for_var" % kind)
    check(kind == "const_write", "27(c): the const write raised %r" % kind)
    outer = "mxnet_tpu_torch.kvstore_server.KVStoreServer._ha_lock"
    inner = SERVING_LOCK
    check((outer, inner) not in static and (inner, outer) not in static,
          "27(c): the static graph holds %s -> %s" % (outer, inner))
    witness.configure("strict")
    witness.seed_static(static)
    try:
        lo = witness.declare(outer, threading.Lock())
        li = witness.declare(inner, threading.RLock())
        try:
            with lo:
                with li:
                    kind = None
        except witness.LockWitnessError as e:
            kind = e.kind
        freed = lo.acquire(blocking=False) and li.acquire(blocking=False)
        if freed:
            li.release()
            lo.release()
    finally:
        witness.configure(None)
        witness.seed_static(None)
        witness.reset_observations()
    log("  %s nested under %s: LockWitnessError(%r); both locks free after: "
        "%s" % (inner, outer, kind, freed))
    check(kind == "unknown_edge", "27(c): the off-graph nesting raised %r"
          % kind)
    check(freed, "27(c): a lock stayed held after the violation")


def run_analysis_phase(mx, S, M, build, card, static, sanitized, serve_ref):
    """Phase 27 (``static``: :func:`static_lock_edges`; ``sanitized``: the
    future of (a)'s :func:`sanitized_fit`, started before phase 26 and
    running beside it); returns the kernels' launches of (a) and (b)."""
    log("  (a) the fused dist_sync fit, every process under "
        "MXNET_ENGINE_SANITIZER=strict and MXNET_LOCK_WITNESS=strict (its "
        "cluster ran beside phase 26)")
    t0 = time.perf_counter()
    launches = sanitized.result()
    log("  (a) waited %.1f s for it (%s)" % (time.perf_counter() - t0, card))
    log("  (b) the serving engine at phase 4's width, witness strict and "
        "seeded")
    t0 = time.perf_counter()
    for name, n in witnessed_serving(S, M, build, static, serve_ref).items():
        launches[name] += n
    log("  (b) took %.1f s (%s)" % (time.perf_counter() - t0, card))
    log("  (c) the negatives")
    analysis_negatives(mx, static)
    return launches


# ------------------------- A8b: the Python-free artifact (phase 28)
ART_PRED_BATCH = 4         # 28(a): the LM predicted from an artifact
ART_TRAIN_BATCH = 32       # 28(b): the LM trained from an artifact
ART_STEPS = 8
ART_BATCHES = 4            # 28(b) cycles phase 5's 4 batches: two epochs
ART_TIMED_STEPS = 5        # 28(b): C++ steps timed after the compared ones
ART_WIDE_BATCH = 2         # 28(d)
ART_TIMEOUT = 300
ART_NATIVE_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                      "flash_wide_fwd", "flash_wide_bwd_dkv",
                      "flash_wide_bwd_dq")
#: values an earlier phase leaves for a later one (26(a)'s call time)
PHASE_NOTES = {}


def native_rt_start():
    """Phase 28's runtime build (``_predict_native.build``: ``g++`` over
    ``csrc/native_rt/``), started when phase 2's kernels are built, in a
    process of its own at the lowest CPU priority: it takes the cores the
    later phases leave idle, not phase 2's. Returns the process."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    code = ("from mxnet_tpu_torch import _predict_native as P; "
            "print(P.build()); print(P.build_seconds)")
    nice = shutil.which("nice")
    return subprocess.Popen(
        ([nice, "-n", "19"] if nice else []) + [sys.executable, "-c", code],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def native_rt_compile(work, proc):
    """Waits for :func:`native_rt_start`'s build (a failure stops the run
    with the compiler's text) and compiles the JAX package's two C
    clients, unchanged, against the runtime. Returns (paths, the build's
    seconds)."""
    import os

    from mxnet_tpu_torch import _predict_native as P

    out, err = proc.communicate(timeout=ART_TIMEOUT * 4)
    check(proc.returncode == 0, "building the native runtime failed:\n%s"
          % err[-4000:])
    lib, seconds = out.split()[-2:]
    check(P.build() == lib, "the runtime built is not the one this process "
          "would load: %s" % lib)
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(work, "native_rt")
    os.makedirs(d, exist_ok=True)
    paths = {"lib": lib,
             "predict": os.path.join(d, "predict_native_client"),
             "train": os.path.join(d, "train_native_client")}
    procs = [subprocess.Popen(
        ["gcc", "-O2", os.path.join(root, "tests", "c", src), "-o", paths[k]]
        + P.client_flags(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k, src in (("predict", "predict_native_client.c"),
                                  ("train", "train_native_client.c"))]
    for p in procs:
        text = p.communicate(timeout=ART_TIMEOUT)[0]
        check(p.returncode == 0, "compiling a native client failed:\n%s"
              % text[-3000:])
    return paths, float(seconds)


def _native_counts(P, reset=False):
    return {k: P.kernel_launches(k, reset=reset) for k in ART_NATIVE_KERNELS}


def _native_launched(P, run, per_run, what):
    """``run()`` (which returns how many forwards or steps it made)
    between a reset of the runtime's counters and a read of them: each
    kernel of ``per_run`` must have launched ``per_run[k]`` times per
    forward or step, and no other kernel at all. Returns the reading."""
    _native_counts(P, reset=True)
    n = run()
    got = _native_counts(P)
    check(all(v == per_run.get(k, 0) * n for k, v in got.items()),
          "%s: %d runs launched %s, want %s per run" % (what, n, got, per_run))
    return got


def _watch_maps(cmd, env, what):
    """``cmd`` in a process of its own, its ``/proc/<pid>/maps`` read
    while it runs: (stdout, stderr, seconds, whether a read saw libtorch,
    the libpython mappings seen)."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    saw_torch, pythons = False, set()
    while proc.poll() is None:
        try:
            with open("/proc/%d/maps" % proc.pid) as f:
                maps = f.read()
        except OSError:
            break
        saw_torch = saw_torch or "libtorch" in maps
        pythons |= {line.split()[-1] for line in maps.splitlines()
                    if "libpython" in line}
        time.sleep(0.02)
    out, err = proc.communicate(timeout=ART_TIMEOUT)
    check(proc.returncode == 0, "%s exited %d:\n%s\n%s"
          % (what, proc.returncode, out[-2000:], err[-4000:]))
    return out, err, time.perf_counter() - t0, saw_torch, sorted(pythons)


class NativePredictor:
    """``MXPredCreateFromFile`` of the Python-free runtime on ``cuda:0``
    through ctypes in this process; every call is checked."""

    def __init__(self, lib, path):
        import ctypes as c

        self.lib, self.h = lib, c.c_void_p()
        capi_check(lib, lib.MXPredCreateFromFile(path.encode(), 2, 0,
                                                 c.byref(self.h)),
                   "MXPredCreateFromFile")
        ptr, ndim = c.POINTER(c.c_uint)(), c.c_uint()
        capi_check(lib, lib.MXPredGetOutputShape(
            self.h, 0, c.byref(ptr), c.byref(ndim)), "MXPredGetOutputShape")
        self.out_shape = tuple(ptr[i] for i in range(ndim.value))

    def predict(self, x):
        import ctypes as c

        x = np.ascontiguousarray(x, np.float32)
        capi_check(self.lib, self.lib.MXPredSetInput(
            self.h, b"data", x.ctypes.data_as(c.POINTER(c.c_float)), x.size),
            "MXPredSetInput")
        capi_check(self.lib, self.lib.MXPredForward(self.h), "MXPredForward")
        out = np.empty(self.out_shape, np.float32)
        capi_check(self.lib, self.lib.MXPredGetOutput(
            self.h, 0, out.ctypes.data_as(c.POINTER(c.c_float)), out.size),
            "MXPredGetOutput")
        return out

    def free(self):
        capi_check(self.lib, self.lib.MXPredFree(self.h), "MXPredFree")


def _predictor_of(mx, path, sym, args, auxs, shapes, ctx=None):
    """The Python ``Predictor`` over the checkpoint ``path`` of (sym,
    args, auxs)."""
    from mxnet_tpu_torch.predict import Predictor

    sym_json, params = _save_checkpoint(mx, path, sym, args, auxs)
    if ctx is None:
        return Predictor(sym_json, params, input_shapes=shapes)
    with ctx:
        return Predictor(sym_json, params, input_shapes=shapes)


def artifact_predict(mx, P, lib, paths, d, t_params):
    """28(a): phase 5's LM as a predict artifact, through the unchanged C
    client in a process of its own (no libpython mapped) and through
    ctypes here, against the Python Predictor on the card and on the
    CPU; K1 once per layer and forward; a forced kernel failure."""
    import os

    L, T = TRAIN["num_layers"], TRAIN["seq_len"]
    shape = (ART_PRED_BATCH, T)
    shapes = {"data": shape, "softmax_label": shape}
    sym = mx.models.transformer_lm(**TRAIN)
    art = os.path.join(d, "lm.mxa")
    m = mx.export_predict_artifact(sym, t_params, {}, shapes, art)
    check(m["platform"] == "cuda", "the export recorded %s" % m["platform"])
    X, _ = lm_stream(ART_PRED_BATCH, seed=28)
    X.tofile(os.path.join(d, "tokens.f32"))
    ldd = subprocess.run(["ldd", paths["lib"]], capture_output=True,
                         text=True, timeout=60).stdout
    names = [line.split()[0] for line in ldd.splitlines() if line.strip()]
    check(not [n for n in names if "python" in n.lower()],
          "the runtime links a Python library:\n%s" % ldd)
    from mxnet_tpu_torch import _predict_native

    _native_counts(P, reset=True)
    out, _, wall, saw_torch, pythons = _watch_maps(
        [paths["predict"], art, "data", os.path.join(d, "tokens.f32"),
         os.path.join(d, "probs.f32")], _predict_native.client_env(),
        "predict_native_client")
    check(saw_torch and not pythons, "the C client's process: libtorch "
          "mapped %s, libpython mappings %s" % (saw_torch, pythons))
    check(sum(_native_counts(P).values()) == 0, "the subprocess counted here")
    py = _predictor_of(mx, os.path.join(d, "lm_ckpt"), sym, t_params, {},
                       shapes)
    want = py.forward(data=X).get_output(0)
    sub = np.fromfile(os.path.join(d, "probs.f32"), np.float32)
    np_ = NativePredictor(lib, art)
    check(np_.out_shape == want.shape, "the artifact's output shape %s, "
          "want %s" % (np_.out_shape, want.shape))
    per_forward = {"flash_fwd": L}
    outs = []
    k1 = _native_launched(P, lambda: outs.append(np_.predict(X)) or 1,
                          per_forward, "one MXPredForward")
    got = outs[0]
    check(np.isfinite(got).all(), "the artifact's probabilities are not finite")
    err_card = float(np.abs(got - want).max())
    check(err_card <= 1e-6, "the artifact against the Predictor on the card: "
          "%.3e" % err_card)
    err_sub = float(np.abs(sub.reshape(got.shape) - got).max())
    check(err_sub <= 1e-6, "the C client's process against ctypes here: "
          "%.3e" % err_sub)
    cpu = _predictor_of(mx, os.path.join(d, "lm_ckpt"), sym, t_params, {},
                        shapes, ctx=mx.cpu())
    ref = cpu.forward(data=X).get_output(0)
    err_cpu = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(err_cpu <= OUT_REL_TOL, "the artifact on the card against the "
          "Predictor on the CPU: %.3e of the largest" % err_cpu)
    del cpu
    calls = [0]

    def native_predict():
        calls[0] += 1
        return np_.predict(X)

    def native_forward():
        calls[0] += 1
        capi_check(lib, lib.MXPredForward(np_.h), "MXPredForward")
        torch.cuda.synchronize()

    def py_forward():
        py._exe.forward(is_train=False)
        torch.cuda.synchronize()

    timed = {}

    def run_timed():
        timed["ms"] = median_ms(native_predict)
        timed["fwd_ms"] = median_ms(native_forward)
        return calls[0]

    k1_total = k1["flash_fwd"] + _native_launched(
        P, run_timed, per_forward, "the timed predict calls")["flash_fwd"]
    ms, fwd_ms = timed["ms"], timed["fwd_ms"]
    py_ms = median_ms(lambda: py.forward(data=X).get_output(0))
    py_fwd_ms = median_ms(py_forward)
    # a refused launch returns -1 with the kernel's own error text, and
    # is not counted
    refused = {}

    def run_refused():
        os.environ["MXTPU_NATIVE_FAIL_KERNEL"] = "flash_fwd"
        try:
            refused["rc"] = lib.MXPredForward(np_.h)
            refused["msg"] = lib.MXGetLastError().decode(errors="replace")
        finally:
            del os.environ["MXTPU_NATIVE_FAIL_KERNEL"]
        return 0

    _native_launched(P, run_refused, per_forward, "a refused forward")
    rc, msg = refused["rc"], refused["msg"]
    check(rc == -1 and "flash_fwd failed to launch" in msg,
          "a refused K1 launch returned %d: %s" % (rc, msg))
    outs = []
    k1_total += _native_launched(
        P, lambda: outs.append(np_.predict(X)) or 1, per_forward,
        "the forward after a refused launch")["flash_fwd"]
    check(np.array_equal(outs[0], got), "the predictor after a refused "
          "launch differs")
    np_.free()
    log("  (a) the LM (batch %d x %d) from a predict artifact: "
        "predict_native_client.c in its own process (%.1f s; libtorch "
        "mapped, no libpython; ldd of the runtime names no Python library) "
        "within %.3e of the in-process call; in this process through ctypes "
        "%.3e from the Python Predictor on the card (bitwise expected), "
        "%.3e of the largest from the Predictor on the CPU (tol %.0e); K1 "
        "%d launches per forward (%d layers), %d over the %d forwards read; "
        "predict call (set input, "
        "forward, read the %.1f MB output) median %.3f ms (Python Predictor "
        "%.3f ms; phase 26(a)'s C API at batch %d %s ms); the forward alone, "
        "synchronized, median %.3f ms (Python Executor %.3f ms); a refused "
        "K1 launch returned -1: %s"
        % (ART_PRED_BATCH, T, wall, err_sub, err_card, err_cpu, OUT_REL_TOL,
           k1["flash_fwd"], L, k1_total, k1_total // L, got.nbytes / 1e6,
           ms, py_ms, CAPI_PRED_BATCH,
           "%.3f" % PHASE_NOTES["capi_predict_ms"]
           if "capi_predict_ms" in PHASE_NOTES else "not run", fwd_ms,
           py_fwd_ms, msg))
    return k1_total, out


class NativeTrainer:
    """``MXTrainNativeCreateFromFile`` through ctypes in this process."""

    def __init__(self, lib, path):
        import ctypes as c

        self.lib, self.h = lib, c.c_void_p()
        capi_check(lib, lib.MXTrainNativeCreateFromFile(path.encode(),
                                                        c.byref(self.h)),
                   "MXTrainNativeCreateFromFile")

    def step(self, x, y, lr):
        import ctypes as c

        for name, v in ((b"data", x), (b"softmax_label", y)):
            v = np.ascontiguousarray(v, np.float32)
            capi_check(self.lib, self.lib.MXTrainNativeSetInput(
                self.h, name, v.ctypes.data_as(c.POINTER(c.c_float)), v.size),
                "MXTrainNativeSetInput")
        capi_check(self.lib, self.lib.MXTrainNativeStep(self.h, c.c_float(lr)),
                   "MXTrainNativeStep")

    def output(self, shape):
        import ctypes as c

        out = np.empty(shape, np.float32)
        capi_check(self.lib, self.lib.MXTrainNativeGetOutput(
            self.h, 0, out.ctypes.data_as(c.POINTER(c.c_float)), out.size),
            "MXTrainNativeGetOutput")
        return out

    def save(self, path):
        capi_check(self.lib, self.lib.MXTrainNativeSaveParams(
            self.h, path.encode()), "MXTrainNativeSaveParams")

    def free(self):
        capi_check(self.lib, self.lib.MXTrainNativeFree(self.h),
                   "MXTrainNativeFree")


def _fused_lm_steps(mx, sym, init, X, Y, lr, steps, optimizer="adam",
                    opt_params=None):
    """``steps`` of the port's fused step (captured from the second on) on
    ``cuda:0`` over the ``ART_BATCHES`` batches of (X, Y), cycled, under
    ``optimizer`` (Adam at ``lr`` by default): the parameters after each,
    and the mean host wall of the replays."""
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    B, T = ART_TRAIN_BATCH, TRAIN["seq_len"]
    pnames = [n for n in sym.list_arguments()
              if n not in ("data", "softmax_label")]
    opt = mx.optimizer.create(optimizer, sym=sym,
                              param_idx2name={n: n for n in pnames},
                              **dict(opt_params or {}, learning_rate=lr))
    tr = SPMDTrainer(sym, "cuda:0", [("data", (B, T))], opt,
                     label_shapes=[("softmax_label", (B, T))])
    params = {n: torch.tensor(init[n], device="cuda:0") for n in tr.param_names}
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    after, walls = [], []
    for s in range(steps):
        k = s % ART_BATCHES
        buf["data"].copy_(torch.tensor(X[k * B:(k + 1) * B]))
        buf["softmax_label"].copy_(torch.tensor(Y[k * B:(k + 1) * B]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step(params, {}, states)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after.append({n: v.cpu().numpy() for n, v in params.items()})
    return after, float(np.mean(walls[2:])) * 1e3 if len(walls) > 2 else None


def artifact_train(mx, P, lib, paths, d):
    """28(b): the LM as a train artifact (Adam, batch 32, phase 5's
    initial parameters): the unchanged C training client for 8 steps in
    a process of its own; the same 8 steps through ctypes here beside the
    port's fused step; K1, K2a and K2b once per layer and step."""
    import os

    L, T, B = TRAIN["num_layers"], TRAIN["seq_len"], ART_TRAIN_BATCH
    lr = float(np.float32(TRAIN_LR))
    sym = mx.models.transformer_lm(**TRAIN)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(0)))     # phase 5's initializer
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    del mod
    art = os.path.join(d, "lm_train.mxa")
    m = mx.export_train_artifact(sym, {"data": (B, T), "softmax_label": (B, T)},
                                 art, optimizer="adam",
                                 optimizer_params={"learning_rate": lr},
                                 arg_params=init)
    check(m["optimizer"] == "Adam" and m["nslot"] == 2, "the train manifest "
          "says %s with %d slots" % (m["optimizer"], m["nslot"]))
    # phase 5's stream and its 4 batches, cycled as its fit cycles them:
    # after 8 distinct batches the first batch's loss rises under the JAX
    # package's trainer as under the port's (Adam's early transient,
    # tests/lm_heldout_witness.py), so only a batch seen again can show
    # the loss falling within 8 steps
    X, Y = lm_stream(B * ART_BATCHES)
    X.tofile(os.path.join(d, "train_data.f32"))
    Y.tofile(os.path.join(d, "train_label.f32"))
    from mxnet_tpu_torch import _predict_native

    sub_params = os.path.join(d, "trained_process.params")
    out, _, wall, saw_torch, pythons = _watch_maps(
        [paths["train"], art, os.path.join(d, "train_data.f32"),
         os.path.join(d, "train_label.f32"), str(B), str(ART_STEPS), repr(lr),
         sub_params, os.path.join(d, "loss.txt")],
        _predict_native.client_env(), "train_native_client")
    check(saw_torch and not pythons, "the C trainer's process: libtorch "
          "mapped %s, libpython mappings %s" % (saw_torch, pythons))
    # the client reports the probabilities' mean for a label of several
    # ids per row: 1/V while they are finite
    reported = [float(line.split()[1])
                for line in open(os.path.join(d, "loss.txt"))]
    check(len(reported) >= 2 and all(math.isfinite(v) for v in reported),
          "the C trainer reported %s" % reported)
    fused, fused_ms = _fused_lm_steps(mx, sym, init, X, Y, lr, ART_STEPS)
    tr = NativeTrainer(lib, art)
    per_step, diffs, losses = [], [], []
    lab0 = Y[:B].reshape(-1).astype(np.int64)

    def batch0_loss():
        """The cross-entropy of the last step's forward, which ran on the
        first batch."""
        prob = tr.output((B * T, TRAIN["vocab_size"]))
        return float(-np.log(np.maximum(prob[np.arange(B * T), lab0],
                                        1e-8)).mean())

    scale = max(float(np.abs(v).max()) for v in init.values())
    per_step_want = {k: L for k in FLASH}

    def one_step(k):
        def run():
            tr.step(X[k * B:(k + 1) * B], Y[k * B:(k + 1) * B], lr)
            torch.cuda.synchronize()
            return 1
        return run

    for s in range(ART_STEPS):
        per_step.append(_native_launched(
            P, one_step(s % ART_BATCHES), per_step_want, "C++ step %d"
            % (s + 1)))
        if s == 0:
            losses.append(batch0_loss())
        tr.save(os.path.join(d, "step.params"))
        got = {k[4:]: v.asnumpy() for k, v in
               mx.nd.load(os.path.join(d, "step.params")).items()}
        diffs.append(max(float(np.abs(got[n] - fused[s][n]).max())
                         for n in init))
    # the first batch again (its third visit), its forward on the
    # parameters of the 8 steps
    per_step.append(_native_launched(P, one_step(0), per_step_want,
                                     "the loss step"))
    losses.append(batch0_loss())
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "the C++ steps' loss on the first batch did not fall: %s" % losses)
    check(diffs[0] <= 1e-6, "step 1's parameters against the fused step's: "
          "%.3e" % diffs[0])
    check(all(v <= RESUME_TOL * scale for v in diffs), "the C++ steps' "
          "parameters against the fused step's: %s" % diffs)
    saved = mx.nd.load(sub_params)
    check(sorted(saved) == sorted("arg:" + n for n in init) and all(
        np.array_equal(saved["arg:" + n].asnumpy(), got[n]) for n in init),
        "MXTrainNativeSaveParams' file from the C process differs from the "
        "in-process trainer's parameters")
    # the C++ step's wall: steps that read nothing back, synchronized
    torch.cuda.synchronize()
    timed = {}

    def timed_steps():
        t0 = time.perf_counter()
        for s in range(ART_TIMED_STEPS):
            tr.step(X[:B], Y[:B], lr)
        torch.cuda.synchronize()   # the runtime's work is on this card
        timed["ms"] = (time.perf_counter() - t0) * 1e3 / ART_TIMED_STEPS
        return ART_TIMED_STEPS

    per_step.append(_native_launched(P, timed_steps, per_step_want,
                                     "the timed C++ steps"))
    step_ms = timed["ms"]
    tr.free()
    # every reading: the compared steps, the loss step and the timed ones
    total = {k: sum(n[k] for n in per_step) for k in FLASH}
    log("  (b) the LM trained from a train artifact (Adam, lr %g, batch %d x "
        "%d, phase 5's initial parameters): train_native_client.c in its own "
        "process (%.1f s, no libpython mapped), its saved file bitwise the "
        "in-process trainer's; the first batch's loss %.6f at step 1, "
        "%.6f after %d steps; through "
        "ctypes K1/K2a/K2b %s per step, %s over the %d steps read (the "
        "compared, the loss step and the timed ones); the largest parameter "
        "difference from the port's fused step per step %s (step 1 tol "
        "1e-6, then %.0e of the largest parameter, %.3g); C++ step %.3f ms "
        "eager, the fused step %.3f ms (a CUDA graph's replays) (%s)"
        % (lr, B, T, wall, losses[0], losses[-1], ART_STEPS,
           sorted({tuple(n[k] for k in FLASH) for n in per_step[:ART_STEPS]}),
           [total[k] for k in FLASH], ART_STEPS + 1 + ART_TIMED_STEPS,
           ["%.3e" % v for v in diffs], RESUME_TOL, scale, step_ms, fused_ms,
           out.strip().splitlines()[-2] if out.strip() else ""))
    return total


# 28(f): the runtime's rules beyond SGD and Adam, each (optimizer, params)
ART_RULES = (
    ("nag", {"momentum": 0.9}, TRAIN_LR),
    ("adagrad", {}, 1e-2),
    ("rmsprop", {}, TRAIN_LR),
    ("rmsprop", {"centered": True, "clip_weights": 1.0}, TRAIN_LR),
    ("adadelta", {}, 1.0),
    ("ftrl", {"lamda1": 0.01}, 0.1),
)
ART_RULE_STEPS = 3


def artifact_rules(mx, P, lib, paths, d):
    """28(f): the LM's train artifact (batch 32, phase 5's initial
    parameters) under each of NAG, AdaGrad, RMSProp (plain and centered),
    AdaDelta and Ftrl for ``ART_RULE_STEPS`` steps: the unchanged C
    training client in a process of its own per rule (all at once), the
    same steps through ctypes here, against the port's fused step under
    the same rule; K1, K2a and K2b once per layer in every step read."""
    import os

    from mxnet_tpu_torch import _predict_native

    t0 = time.perf_counter()
    L, T, B = TRAIN["num_layers"], TRAIN["seq_len"], ART_TRAIN_BATCH
    sym = mx.models.transformer_lm(**TRAIN)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(0)))     # phase 5's initializer
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    del mod
    X, Y = lm_stream(B * ART_BATCHES)
    X.tofile(os.path.join(d, "rules_data.f32"))
    Y.tofile(os.path.join(d, "rules_label.f32"))
    scale = max(float(np.abs(v).max()) for v in init.values())
    per_step_want = {k: L for k in FLASH}
    total = {k: 0 for k in FLASH}
    procs, report = [], []
    for i, (opt, extra, lr) in enumerate(ART_RULES):
        lr = float(np.float32(lr))
        art = os.path.join(d, "lm_rule%d.mxa" % i)
        m = mx.export_train_artifact(
            sym, {"data": (B, T), "softmax_label": (B, T)}, art,
            optimizer=opt, optimizer_params=dict(extra, learning_rate=lr),
            arg_params=init)
        out = os.path.join(d, "rule%d_process.params" % i)
        procs.append((out, subprocess.Popen(
            [paths["train"], art, os.path.join(d, "rules_data.f32"),
             os.path.join(d, "rules_label.f32"), str(B), str(ART_RULE_STEPS),
             repr(lr), out, os.path.join(d, "rule%d_loss.txt" % i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_predict_native.client_env())))
        fused, _ = _fused_lm_steps(mx, sym, init, X, Y, lr, ART_RULE_STEPS,
                                   optimizer=opt, opt_params=extra)
        tr = NativeTrainer(lib, art)
        diffs, got = [], None
        for s in range(ART_RULE_STEPS):
            k = s % ART_BATCHES

            def run(k=k):
                tr.step(X[k * B:(k + 1) * B], Y[k * B:(k + 1) * B], lr)
                torch.cuda.synchronize()
                return 1

            for name, v in _native_launched(
                    P, run, per_step_want, "28(f) %s step %d"
                    % (m["optimizer"], s + 1)).items():
                if name in total:
                    total[name] += v
            tr.save(os.path.join(d, "rule.params"))
            got = {k[4:]: v.asnumpy() for k, v in
                   mx.nd.load(os.path.join(d, "rule.params")).items()}
            check(all(np.isfinite(v).all() for v in got.values()),
                  "28(f) %s: a parameter is not finite after step %d"
                  % (m["optimizer"], s + 1))
            diffs.append(max(float(np.abs(got[n] - fused[s][n]).max())
                             for n in init))
        tr.free()
        moved = max(float(np.abs(got[n] - init[n]).max()) for n in init)
        check(moved > 0, "28(f) %s: the parameters did not move"
              % m["optimizer"])
        check(diffs[0] <= 1e-6, "28(f) %s: step 1's parameters against the "
              "fused step's: %.3e" % (m["optimizer"], diffs[0]))
        check(all(v <= RESUME_TOL * scale for v in diffs), "28(f) %s: the "
              "C++ steps against the fused step's: %s" % (m["optimizer"], diffs))
        report.append((m["optimizer"] + ("(centered)" if extra.get("centered")
                                         else ""), m["nslot"], diffs, got))
    for (out, proc), (name, _, _, got) in zip(procs, report):
        _, err = proc.communicate(timeout=ART_TIMEOUT)
        check(proc.returncode == 0, "28(f) %s: train_native_client.c "
              "exited %d:\n%s" % (name, proc.returncode, err[-2000:]))
        saved = mx.nd.load(out)
        check(sorted(saved) == sorted("arg:" + n for n in init) and all(
            np.array_equal(saved["arg:" + n].asnumpy(), got[n]) for n in init),
            "28(f) %s: the C process's saved parameters differ from the "
            "in-process trainer's" % name)
    log("  (f) the LM's train artifact under each new rule, %d steps (batch "
        "%d, phase 5's initial parameters): the largest parameter difference "
        "from the port's fused step per step %s (step 1 tol 1e-6, then %.0e "
        "of the largest parameter, %.3g); train_native_client.c in a process "
        "per rule, its saved file bitwise the in-process trainer's; K1/K2a/K2b "
        "%d per step, %s over the %d steps read; %.1f s"
        % (ART_RULE_STEPS, B, ["%s/%d slots: %s" % (n, k, ["%.3e" % v
                                                           for v in dd])
                               for n, k, dd, _ in report],
           RESUME_TOL, scale, L, [total[k] for k in FLASH],
           ART_RULE_STEPS * len(ART_RULES), time.perf_counter() - t0))
    return total


def artifact_resnet(mx, P, lib, d):
    """28(c): ResNet-50 scoring in float32 at batch 32 from a predict
    artifact, against the Python Predictor; images/s of each."""
    import os

    rn_json, rn_params = _resnet_checkpoint(mx, os.path.join(d, "resnet"))
    blob = mx.nd.load(os.path.join(d, "resnet-0000.params"))
    args = {k[4:]: v.asnumpy() for k, v in blob.items() if k.startswith("arg:")}
    auxs = {k[4:]: v.asnumpy() for k, v in blob.items() if k.startswith("aux:")}
    shape = (RESNET_BATCH,) + RESNET_SHAPE
    art = os.path.join(d, "resnet.mxa")
    mx.export_predict_artifact(mx.sym.load_json(rn_json), args, auxs,
                               {"data": shape}, art)
    imgs = np.random.RandomState(28).uniform(-1, 1, shape).astype(np.float32)
    from mxnet_tpu_torch.predict import Predictor

    py = Predictor(rn_json, rn_params, input_shapes={"data": shape})
    want = py.forward(data=imgs).get_output(0)
    np_ = NativePredictor(lib, art)
    got = np_.predict(imgs)
    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= 1e-5, "ResNet-50's scores from "
          "the artifact against the Python Predictor: %.3e" % err)
    art_ms = median_ms(lambda: np_.predict(imgs), reps=10)
    py_ms = median_ms(lambda: py.forward(data=imgs).get_output(0), reps=10)
    np_.free()
    del py
    log("  (c) ResNet-%d scoring, float32, batch %d from a predict artifact: "
        "%.3e from the Python Predictor (tol 1e-5); predict call median %.3f "
        "ms = %.1f images/s from the artifact, %.3f ms = %.1f images/s "
        "through the Python Predictor"
        % (RESNET["num_layers"], RESNET_BATCH, err, art_ms,
           RESNET_BATCH * 1e3 / art_ms, py_ms, RESNET_BATCH * 1e3 / py_ms))


def artifact_wide(mx, P, lib, d, w_params):
    """28(d): one forward of phase 8's head_dim-512 LM from a predict
    artifact: K1's wide route, against the Python Predictor."""
    import os

    L, T = WIDE["num_layers"], WIDE["seq_len"]
    shape = (ART_WIDE_BATCH, T)
    shapes = {"data": shape, "softmax_label": shape}
    sym = mx.models.transformer_lm(**WIDE)
    art = os.path.join(d, "wide.mxa")
    mx.export_predict_artifact(sym, w_params, {}, shapes, art)
    X, _ = lm_stream(ART_WIDE_BATCH, seed=29, cfg=WIDE)
    py = _predictor_of(mx, os.path.join(d, "wide_ckpt"), sym, w_params, {},
                       shapes)
    want = py.forward(data=X).get_output(0)
    del py
    np_ = NativePredictor(lib, art)
    _native_counts(P, reset=True)
    got = np_.predict(X)
    n = _native_counts(P)
    np_.free()
    err = float(np.abs(got - want).max())
    check(n["flash_wide_fwd"] == L and sum(n.values()) == L,
          "the head_dim 512 forward launched %s, want flash_wide_fwd %d "
          "times" % (n, L))
    check(np.isfinite(got).all() and err <= 1e-6, "the wide artifact against "
          "the Predictor: %.3e" % err)
    log("  (d) phase 8's LM at head_dim 512 (batch %d x %d) from a predict "
        "artifact: flash_wide_fwd %d launches (%d layers), %.3e from the "
        "Python Predictor on the card"
        % (ART_WIDE_BATCH, T, n["flash_wide_fwd"], L, err))
    return n["flash_wide_fwd"]


def artifact_dropout(mx, lib, d):
    """28(e): a Dropout MLP's train artifact on the card, its masks drawn
    there from a generator seeded ``seed + t``: two trainers of one
    artifact step to the same parameters, an artifact of another seed to
    others."""
    import os

    B, D = 64, 256
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=D, name="fc1")
    net = mx.sym.Dropout(net, p=0.5, name="drop")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rs = np.random.RandomState(30)
    args = {n: (rs.randn(*s) * 0.05).astype(np.float32) for n, s in zip(
        net.list_arguments(), net.infer_shape(data=(B, D))[0])
        if n not in ("data", "softmax_label")}
    x = rs.randn(B, D).astype(np.float32)
    y = (np.arange(B) % 10).astype(np.float32)
    saved = []
    for run, seed in enumerate((4, 4, 5)):
        art = os.path.join(d, "dropout%d.mxa" % run)
        mx.export_train_artifact(net, {"data": (B, D)}, art, optimizer="sgd",
                                 optimizer_params={"learning_rate": 0.1},
                                 arg_params=args, seed=seed)
        tr = NativeTrainer(lib, art)
        for _ in range(3):
            tr.step(x, y, 0.1)
        tr.save(os.path.join(d, "dropout.params"))
        tr.free()
        saved.append({k: v.asnumpy() for k, v in mx.nd.load(
            os.path.join(d, "dropout.params")).items()})
    moved = max(float(np.abs(saved[0]["arg:" + n] - args[n]).max())
                for n in args)
    check(moved > 0 and all(np.isfinite(v).all() for v in saved[0].values()),
          "28(e): the Dropout MLP did not train")
    check(all(np.array_equal(saved[0][k], saved[1][k]) for k in saved[0]),
          "28(e): two trainers of one stochastic artifact differ")
    check(any(not np.array_equal(saved[0][k], saved[2][k])
              for k in saved[0]),
          "28(e): an artifact with another seed drew the same masks")
    log("  (e) a Dropout MLP's train artifact on the card, 3 steps: two "
        "trainers of one seed bitwise equal, another seed differs (its masks "
        "drawn on the card from seed + t)")


def run_artifact_phase(mx, build, card, t_params, w_params, work, compiled):
    """Phase 28 (see the module docstring; ``compiled``:
    :func:`native_rt_compile`'s); returns the runtime's launches of K1,
    K2a, K2b and K1 wide on its main paths."""
    import os

    from mxnet_tpu_torch import _predict_native as P

    t_phase = time.perf_counter()
    paths, seconds = compiled
    lib = P.load()
    for name in ("MXPredCreateFromFile", "MXPredSetInput", "MXPredForward",
                 "MXPredGetOutputShape", "MXPredGetOutput", "MXPredFree",
                 "MXTrainNativeCreateFromFile", "MXTrainNativeSetInput",
                 "MXTrainNativeStep", "MXTrainNativeGetOutput",
                 "MXTrainNativeSaveParams", "MXTrainNativeFree"):
        getattr(lib, name).restype = __import__("ctypes").c_int
    log("  the runtime %s (g++ %.2f s, at the lowest priority from phase 2 "
        "on) and the two C clients" % (paths["lib"], seconds))
    d = os.path.join(work, "native_rt")
    total = {k: 0 for k in FLASH}
    total["flash_wide_fwd"] = 0
    k1, _ = artifact_predict(mx, P, lib, paths, d, t_params)
    total["flash_fwd"] += k1
    for k, v in artifact_train(mx, P, lib, paths, d).items():
        total[k] += v
    artifact_resnet(mx, P, lib, d)
    total["flash_wide_fwd"] += artifact_wide(mx, P, lib, d, w_params)
    artifact_dropout(mx, lib, d)
    for k, v in artifact_rules(mx, P, lib, paths, d).items():
        total[k] += v
    torch.cuda.empty_cache()
    log("  phase 28: %.1f s; the runtime's launches on its main paths %s"
        % (time.perf_counter() - t_phase, total))
    return total


# phase 29: the repo tools on the card, each at its published widths and
# a cut depth
TOOLS_PIPE_ARGS = ["--n", "256", "--size", "224", "--reps", "3",
                   "--batches", "10"]
TOOLS_GAN_STEPS = 20
TOOLS_BW_ITERS = 5


def _tool_records(fn, argv):
    """``fn(argv)`` (a tool's ``main``) with its standard output caught:
    (its return code, its JSON records, its text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    text = buf.getvalue()
    recs = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    return rc, recs, text


def tools_pipeline(card):
    """29(a): ``bench_pipeline``'s whole ladder on the card."""
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.tools import bench_pipeline

    t0 = time.perf_counter()
    rc, recs, text = _tool_records(bench_pipeline.main, TOOLS_PIPE_ARGS)
    check(rc == 0, "29(a) bench_pipeline returned %s" % rc)
    by = {}
    for r in recs:
        by.setdefault(r["metric"], []).append(r)
    check(not [m for m in by if m.endswith("_unavailable")],
          "29(a): a rung was replaced by a flag: %s" % sorted(by))
    check(len(by.get("recorditer_imgs_per_sec", [])) == 5
          and len(by.get("rec_device_put_imgs_per_sec", [])) == 3
          and len(by.get("rec_training_imgs_per_sec", [])) == 4,
          "29(a): rungs missing: %s" % {m: len(v) for m, v in by.items()})
    native = [r for r in recs if r.get("backend") == "native"]
    decoder = _native.decoder()
    check(len(native) == 3 and all(r["decoder"] == decoder for r in native)
          and decoder in ("nvjpeg", "libjpeg"),
          "29(a): the native rungs ran on %s" % [r.get("decoder") for r in native])
    check(all(r["device"] == "cuda:0" and r.get("name") for r in recs),
          "29(a): a record names no card")
    check(all(r["fused"] for r in by["rec_training_imgs_per_sec"]),
          "29(a): a D rung's fit did not take the fused step")
    check(all(math.isfinite(r["value"]) and r["value"] > 0
              for m in ("recorditer_imgs_per_sec", "rec_device_put_imgs_per_sec",
                        "rec_training_imgs_per_sec", "decode_pil_imgs_per_sec",
                        "decode_cv2_imgs_per_sec") for r in by[m]),
          "29(a): a rate is not positive")
    table = text[text.index("| ladder rung"):].strip().splitlines()
    for line in table:
        log("    " + line)
    log("  (a) bench_pipeline %s on %s (native rungs on %s): the ladder above "
        "(images/s, median and band over 3 windows); %.1f s"
        % (" ".join(TOOLS_PIPE_ARGS), card, decoder, time.perf_counter() - t0))


def tools_bandwidth(card):
    """29(b): ``bandwidth`` over ResNet-50's gradients, ``local`` and
    ``device``, two positions on ``cuda:0``; every pulled value is the sum
    pushed (the tool checks it)."""
    from mxnet_tpu_torch.tools import bandwidth

    t0 = time.perf_counter()
    out = []
    for kv in ("local", "device"):
        rec = bandwidth.measure(kv, "resnet", 1000, 2, TOOLS_BW_ITERS,
                                device="cuda:0")
        check(rec["values_checked"] and rec["device"] == "cuda:0"
              and rec["grads"] == len(bandwidth.get_shapes("resnet", 1000)),
              "29(b) %s: %s" % (kv, rec))
        out.append(rec)
        log("  (b) kvstore=%s devices=2 grads=%d bytes=%.1f MB: %.3f ms per "
            "iteration, %.1f MB moved, %.2f GB/s (algo-bw %.2f GB/s), every "
            "pulled value the sum pushed" % (
                kv, rec["grads"], rec["bytes"] / 1e6, rec["time_per_iter_ms"],
                rec["bytes_moved_per_iter"] / 1e6, rec["gb_per_sec"],
                rec["algo_bw_gb_per_sec"]))
    log("  (b) %.1f s on %s" % (time.perf_counter() - t0, card))
    return out


def tools_gan(mx, card):
    """29(c): ``baseline_matrix`` dcgan and dcgan_fused, ``TOOLS_GAN_STEPS``
    steps each at the tool's widths (batch 64); then, with cuDNN's
    deterministic algorithms, the fused step's first replay against its
    eager step on the replay's z, bitwise, and two replays' z apart."""
    from mxnet_tpu_torch.tools import baseline_matrix as bm

    t0 = time.perf_counter()
    bm.set_device("cuda:0")
    with contextlib.redirect_stdout(sys.stderr):
        c_rate, c_d, c_g = bm.run_dcgan(steps=TOOLS_GAN_STEPS)
        f_rate, f_d, f_g, gan = bm.run_dcgan_fused(steps=TOOLS_GAN_STEPS)
    check(all(math.isfinite(v) for v in c_d + c_g + f_d + f_g),
          "29(c): a loss is not finite: %s %s %s %s" % (c_d, c_g, f_d, f_g))
    check(gan.captures == 1 and gan.replays == TOOLS_GAN_STEPS - 1,
          "29(c): the fused step captured %d and replayed %d times"
          % (gan.captures, gan.replays))
    del gan
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.RandomState(0)
        gan = bm.FusedGAN(bm.dcgan_initial(mx, 64, mx.gpu(0)),
                          bm.real_pool(rng, 64), 64, "cuda:0")
        gan.step(1)                       # eager, t = 1
        before, t = gan.state(), gan.t
        gan.step(2)                       # captured, then the first replay
        replay = gan.state()
        gan.load_state(before, t)
        gan.eager_step(2, z=replay["z"])  # the same step, eagerly
        eager = gan.state()
        diff = max(float((replay[k] - eager[k]).abs().max()) for k in replay)
        check(all(torch.equal(replay[k], eager[k]) for k in replay),
              "29(c): the first replay differs from its eager step on the "
              "same z by up to %.3e" % diff)
        gan.load_state(replay, t + 1)
        gan.step(3)
        check(not torch.equal(gan.z, replay["z"]),
              "29(c): two replays drew the same z")
        check(gan.captures == 1 and gan.replays == 2,
              "29(c): %d captures, %d replays" % (gan.captures, gan.replays))
    finally:
        torch.backends.cudnn.deterministic = saved
    del gan
    log("  (c) DCGAN (ngf = ndf = 32, nc 1, 64x64, z 100, batch 64), %d steps "
        "each: the classic two-Module loop %.1f images/s, the whole iteration "
        "as one CUDA graph %.1f images/s (%.2fx); losses finite (D %s / %s, G "
        "%s / %s, classic / fused); the first replay bitwise its eager step on "
        "the same z (cuDNN deterministic), two replays' z apart; %.1f s"
        % (TOOLS_GAN_STEPS, c_rate, f_rate, f_rate / c_rate,
           ["%.4f" % v for v in c_d], ["%.4f" % v for v in f_d],
           ["%.4f" % v for v in c_g], ["%.4f" % v for v in f_g],
           time.perf_counter() - t0))


def tools_ssd_lstm(card):
    """29(d): ``baseline_matrix ssd --quick`` and ``lstm --quick``."""
    from mxnet_tpu_torch.tools import baseline_matrix as bm

    t0 = time.perf_counter()
    bm.set_device("cuda:0")
    with contextlib.redirect_stdout(sys.stderr):
        rate, mean_ap, traj = bm.run_ssd(quick=True)
        ppl, tok = bm.run_lstm(quick=True)
    check(all(math.isfinite(v) for row in traj for v in row)
          and 0 <= mean_ap <= 1, "29(d): SSD's losses %s, mAP %s"
          % (traj[-1], mean_ap))
    check(all(math.isfinite(p) for p in ppl) and ppl[-1] < ppl[0],
          "29(d): the LSTM's perplexity did not fall: %s" % ppl)
    log("  (d) SSD-300 --quick (batch 8, 2 epochs): %.2f images/s, the "
        "MultiBox metric (ce, smoothl1) %s -> %s, training-set mAP %.4f; the "
        "LSTM LM --quick (2x128, vocab 5000): perplexity %s, %.0f tokens/s; "
        "%.1f s" % (rate, ["%.4f" % v for v in traj[0]],
                    ["%.4f" % v for v in traj[-1]], mean_ap,
                    ["%.1f" % p for p in ppl], tok[0] if tok else float("nan"),
                    time.perf_counter() - t0))


def tools_docs(work):
    """29(e): the operator index and the API reference generated on the
    card; the C API manifest checked against the libraries phases 2 and 28
    built."""
    import os

    from mxnet_tpu_torch.tools import c_api_coverage, gen_api_docs, gen_op_docs

    t0 = time.perf_counter()
    d = os.path.join(work, "docs")
    os.makedirs(d, exist_ok=True)
    rc, recs, _ = _tool_records(gen_op_docs.main,
                                ["--out", os.path.join(d, "operators.md")])
    check(rc == 0 and recs[-1]["names"] == 297, "29(e) gen_op_docs: %s" % recs)
    same_ops = (open(os.path.join(d, "operators.md")).read()
                == open(gen_op_docs.OUT).read())
    check(same_ops, "29(e): the operator index on the card differs from the "
          "committed one")
    rc, recs_api, _ = _tool_records(gen_api_docs.main,
                                    ["--out", os.path.join(d, "api.md")])
    check(rc == 0 and recs_api[-1]["modules"] == 39, "29(e) gen_api_docs: %s"
          % recs_api)
    same_api = (open(os.path.join(d, "api.md")).read()
                == open(gen_api_docs.OUT).read())
    check(same_api, "29(e): the API reference on the card differs from the "
          "committed one")
    rc, recs_c, _ = _tool_records(c_api_coverage.main, ["--check"])
    check(rc == 0 and recs_c[-1]["up_to_date"], "29(e) c_api_coverage "
          "--check against this card's libraries: %s" % recs_c)
    log("  (e) gen_op_docs: %d ops, %d names, equal to the committed index; "
        "gen_api_docs: %d modules, %d lines, equal to the committed file: %s; "
        "c_api_coverage --check: %d implemented / %d equivalent / %d descoped "
        "of %d, up to date; %.1f s"
        % (recs[-1]["ops"], recs[-1]["names"], recs_api[-1]["modules"],
           recs_api[-1]["lines"], same_api, recs_c[-1]["implemented"],
           recs_c[-1]["equivalent"], recs_c[-1]["descoped"],
           recs_c[-1]["declarations"], time.perf_counter() - t0))


def run_tools_phase(mx, card, work):
    """Phase 29 (see the module docstring)."""
    t0 = time.perf_counter()
    tools_pipeline(card)
    torch.cuda.empty_cache()
    tools_bandwidth(card)
    torch.cuda.empty_cache()
    tools_gan(mx, card)
    torch.cuda.empty_cache()
    tools_ssd_lstm(card)
    torch.cuda.empty_cache()
    tools_docs(work)
    log("  phase 29: %.1f s" % (time.perf_counter() - t0))


# ----------------------------- A6d: the data-parallel fused step (phase 30)
DP_LM_BATCH = 32
# a warm-up step, then 8 replays of one captured graph
DP_LM_STEPS = 9
# one fwd+bwd at dp 2 against dp 1: max |g2 - g1| / max |g1| per parameter.
# Each position multiplies half the rows, so cuBLAS may round the FFN's
# products otherwise and a ReLU input at its kink may take the other side
# (C22, phase 6's KINK_TOL): the bound is DP_GRAD_TOL or, where larger,
# UPDATE_SENSITIVITY_FACTOR times how far dp 1's own gradient moves when
# the parameters move by +-PERTURBATION (relative, seeded), measured in the
# same run
DP_GRAD_TOL = 1e-5
# the perplexities of the 8 replayed steps, dp 2 against dp 1 (relative)
DP_PPL_TOL = 1e-2
DP_RESNET_STEPS = 3
# ResNet-50 in bf16 at dp 2 against dp 1, after the first step and after
# the last: the largest difference over the largest move from the start
# (parameters, and apart the moving statistics) at most this many times
# the same measure of the dp 1 bf16 run against its float32 twin,
# measured in the same run. After one step the gap is rounding; after
# three at lr 0.05 the trajectories have spread at ReLU kinks, and chip
# run 2 of PR 25 read 0.86 against 1.13 there
DP_RESNET_FACTOR = 2.0
DP_TP_STEPS = 4
DP_TP_RULES = {r".*_ffn1_weight": ("tp", None)}


def _dp_init(mx, sym, shapes, aux=False):
    """A seeded Xavier draw of ``sym``'s parameters (and auxiliary states)
    through ``Module.init_params``, as whole tensors on the card."""
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind([("data", shapes["data"])], [("softmax_label", shapes["softmax_label"])])
    mod.init_params(mx.init.Xavier(rng=torch.Generator().manual_seed(0)))
    args, auxs = mod.get_params()
    out = ({n: a.data.clone() for n, a in args.items()},
           {n: a.data.clone() for n, a in auxs.items()})
    del mod
    return out


def _dp_trainer(mx, sym, mesh, shapes, opt, opt_params, **kw):
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    return SPMDTrainer(sym, mesh, [("data", shapes["data"])], opt,
                       dict(opt_params),
                       label_shapes=[("softmax_label", shapes["softmax_label"])],
                       **kw)


def _dp_steps(tr, w0, a0, inputs, steps, on_step=None):
    """``steps`` fused steps from ``w0``/``a0``: (params, auxs, states, host
    wall of each step, synchronized); ``on_step(outs, params, auxs)``
    after each."""
    params, auxs = tr.place(w0), tr.place(a0)
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    for n, v in inputs.items():
        buf[n].copy_(v)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = tr.step(params, auxs, states)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(outs, params, auxs)
    return params, auxs, states, walls


def _worst_rel(got, want):
    """(name, max |got - want| / max |want|) of the worst tensor."""
    rel = {n: float((got[n].float() - want[n].float()).abs().max())
           / max(float(want[n].float().abs().max()), 1e-30) for n in want}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def _dp_nll(label):
    """The mean negative log-likelihood of ``label`` under the LM's
    probabilities."""
    def nll(probs):
        return float(-probs.float().gather(1, label[:, None]).clamp_min(
            1e-30).log().mean())
    return nll


def dp_grad_check(mx, sym, meshes, shapes, opt, inputs, w0, a0, tag):
    """One fwd+bwd over ``meshes[n]`` (n > 1 positions) against
    ``meshes[1]`` from ``w0`` (the grad program's eager first run): the
    loss within ``DP_GRAD_TOL`` of dp 1's, every position holding the same
    summed gradient, and each gradient within ``DP_GRAD_TOL`` of its
    largest or, where larger, ``UPDATE_SENSITIVITY_FACTOR`` times how far
    dp 1's own gradient moves when the parameters move by
    +-``PERTURBATION`` (relative, seeded), measured here."""
    n = max(meshes)
    nll = _dp_nll(inputs["softmax_label"].reshape(-1).long())

    def grads_at(k, point):
        tr = _dp_trainer(mx, sym, meshes[k], shapes, *opt)
        params, auxs = tr.place(point), tr.place(a0)
        for name, v in inputs.items():
            tr.input_buffers()[name].copy_(v)
        outs = tr.grad_step(params, auxs)
        for dev in dict.fromkeys(meshes[k].device_list):
            torch.cuda.synchronize(dev)
        g = {name: v.clone() for name, v in tr.grad_buffers().items()}
        for p in range(1, k):
            for name in g:
                check(torch.equal(tr.grad_buffers(p)[name].to(g[name].device),
                                  g[name]),
                      "%s: position %d holds another summed gradient of %s"
                      % (tag, p, name))
        return nll(outs[0]), g

    loss1, g1 = grads_at(1, w0)
    loss2, g2 = grads_at(n, w0)
    worst, rel = _worst_rel({k: v.to(g1[k].device) for k, v in g2.items()}, g1)
    host = {k: v.cpu().numpy() for k, v in w0.items()}
    sens, sens_at = 0.0, None
    for sign in (1, -1):
        gp = grads_at(1, {k: torch.tensor(v) for k, v in moved(
            host, sign * PERTURBATION, 6).items()})[1]
        at, r = _worst_rel(gp, g1)
        if r > sens:
            sens, sens_at = r, at
    bound = max(DP_GRAD_TOL, UPDATE_SENSITIVITY_FACTOR * sens)
    log("  %s one fwd+bwd, dp %d against dp 1: loss %.7f / %.7f; worst "
        "gradient %s %.3e of its largest; dp 1's own gradient under a "
        "+-%.0e parameter move: worst %s %.3e; bound max(%.0e, %.1f x that) "
        "= %.3e" % (tag, n, loss2, loss1, worst, rel, PERTURBATION, sens_at,
                    sens, DP_GRAD_TOL, UPDATE_SENSITIVITY_FACTOR, bound))
    check(abs(loss2 - loss1) <= DP_GRAD_TOL * abs(loss1),
          "%s: the dp %d loss is not the dp 1 loss" % (tag, n))
    check(rel <= bound, "%s: dp %d gradients disagree with dp 1" % (tag, n))


def dp_lm(mx, build, card):
    """30(a): the LM at TRAIN's widths, dp 2 on cuda:0 against dp 1."""
    from mxnet_tpu_torch.parallel import build_mesh

    L = TRAIN["num_layers"]
    sym = mx.models.transformer_lm(**TRAIN)
    X, Y = lm_stream(DP_LM_BATCH, seed=30)
    inputs = {"data": torch.tensor(X, device="cuda"),
              "softmax_label": torch.tensor(Y, device="cuda")}
    shapes = {n: tuple(v.shape) for n, v in inputs.items()}
    w0, a0 = _dp_init(mx, sym, shapes)
    opt = ("adam", {"learning_rate": TRAIN_LR, "rescale_grad": 1.0 / DP_LM_BATCH})
    meshes = {1: build_mesh({"dp": 1}), 2: build_mesh({"dp": 2})}
    check([str(d) for d in meshes[2].device_list] == ["cuda:0", "cuda:0"],
          "build_mesh({'dp': 2}) is not two positions on cuda:0: %s" % meshes[2])
    nll = _dp_nll(inputs["softmax_label"].reshape(-1).long())
    dp_grad_check(mx, sym, meshes, shapes, opt, inputs, w0, a0, "(a)")
    # DP_LM_STEPS captured steps of each
    res, total = {}, {}
    for n, mesh in meshes.items():
        tr = _dp_trainer(mx, sym, mesh, shapes, *opt)
        ppl = []
        _zero(build)
        params, _, _, walls = _dp_steps(
            tr, w0, a0, inputs, DP_LM_STEPS,
            lambda outs, *_: ppl.append(math.exp(nll(outs[0]))))
        counts = _counts(build)
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        check(tr.captures == 1 and tr.replays == DP_LM_STEPS - 1,
              "30(a) dp %d: not one captured graph replayed %d times: %s"
              % (n, DP_LM_STEPS - 1, (tr.captures, tr.replays)))
        for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            check(counts[k] == n * L * DP_LM_STEPS,
                  "30(a) dp %d: %s launched %d times in %d steps"
                  % (n, k, counts[k], DP_LM_STEPS))
        step_ms = 1e3 * float(np.median(walls[2:]))
        res[n] = ({k: tr.gather(k, v) for k, v in params.items()}, ppl, step_ms)
        log("  (a) dp %d over %s: one graph, %d replays; launches per replay "
            "%s; copies between positions per replay %d (%d bytes); step "
            "%.3f ms (median of the replays after the first); perplexities %s"
            % (n, mesh, tr.replays, tr._per_replay,
               tr._graphs["step"].transfers[0],
               tr._graphs["step"].transfers[1], step_ms,
               ["%.3f" % p for p in ppl]))
        del tr, params
        torch.cuda.empty_cache()
    ppl1, ppl2 = res[1][1], res[2][1]
    check(all(b < a for a, b in zip(ppl2, ppl2[1:])),
          "30(a): the dp 2 perplexity did not fall every step")
    gap = max(abs(a - b) / b for a, b in zip(ppl2, ppl1))
    worst, prel = _worst_rel(res[2][0], res[1][0])
    log("  (a) dp 2 against dp 1 after %d steps: perplexity %.3e (tol %.0e), "
        "worst parameter %s %.3e of its largest; step %.3f ms against "
        "%.3f ms (%.2fx), %s"
        % (DP_LM_STEPS, gap, DP_PPL_TOL, worst, prel, res[2][2], res[1][2],
           res[2][2] / res[1][2], card))
    check(gap <= DP_PPL_TOL, "30(a): dp 2 perplexities part from dp 1's")
    return total


def _apart(got, want, start):
    """(worst name, its largest difference over the largest move of
    ``want`` from ``start``, that move)."""
    diff = {n: float((got[n].to(want[n].device) - want[n]).abs().max())
            for n in want}
    scale = max(float((want[n] - start[n].to(want[n].device)).abs().max())
                for n in want)
    worst = max(diff, key=diff.get)
    return worst, diff[worst] / max(scale, 1e-30), scale


def dp_resnet(mx, build, card):
    """30(b): ResNet-50 in bf16, dp 2 on cuda:0 against dp 1, held against
    the dp 1 run's own distance from float32."""
    from mxnet_tpu_torch.parallel import build_mesh

    sym = mx.models.resnet(**RESNET)
    rng = np.random.RandomState(30)
    inputs = {"data": torch.tensor(rng.rand(RESNET_BATCH, *RESNET_SHAPE).astype(
                  np.float32), device="cuda"),
              "softmax_label": torch.tensor(rng.randint(
                  0, RESNET["num_classes"], (RESNET_BATCH,)).astype(np.float32),
                  device="cuda")}
    shapes = {n: tuple(v.shape) for n, v in inputs.items()}
    w0, a0 = _dp_init(mx, sym, shapes)
    opt = ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                   "rescale_grad": 1.0 / RESNET_BATCH})
    runs, first, second = {}, {}, {}
    for tag, n, cd in (("dp 1", 1, "bfloat16"), ("dp 2", 2, "bfloat16"),
                       ("dp 1 float32", 1, None)):
        tr = _dp_trainer(mx, sym, build_mesh({"dp": n}), shapes, *opt,
                         compute_dtype=cd)

        def snap(outs, params, auxs, tag=tag, tr=tr):
            # after the first step, and after the second for 31(b)
            into = second if tag in first else first
            if tag not in into:
                into[tag] = ({k: tr.gather(k, v).clone()
                              for k, v in params.items()},
                             {k: tr.gather(k, v).clone()
                              for k, v in auxs.items()})

        params, auxs, _, walls = _dp_steps(tr, w0, a0, inputs,
                                           DP_RESNET_STEPS, snap)
        check(tr.captures == 1, "30(b) %s: %d captures" % (tag, tr.captures))
        runs[tag] = ({k: tr.gather(k, v) for k, v in params.items()},
                     {k: tr.gather(k, v) for k, v in auxs.items()},
                     1e3 * walls[-1])
        del tr, params, auxs
        torch.cuda.empty_cache()
    for steps, res in ((1, first), (DP_RESNET_STEPS, runs)):
        for k, what, start in ((0, "parameters", w0),
                               (1, "moving statistics", a0)):
            w2, r2, s2 = _apart(res["dp 2"][k], res["dp 1"][k], start)
            wf, rf, _ = _apart(res["dp 1"][k], res["dp 1 float32"][k], start)
            log("  (b) ResNet-50 bf16 after %d step(s), %s (largest move from "
                "the start %.4g): dp 2 against dp 1 worst %s %.3e of it; dp 1 "
                "bf16 against float32 worst %s %.3e (bound: %.1fx that)"
                % (steps, what, s2, w2, r2, wf, rf, DP_RESNET_FACTOR))
            check(s2 > 0, "30(b): the %s did not move" % what)
            check(r2 <= DP_RESNET_FACTOR * rf,
                  "30(b): dp 2 %s part from dp 1 beyond bf16's own distance "
                  "after %d step(s)" % (what, steps))
    log("  (b) last step %.3f ms at dp 2, %.3f ms at dp 1 (bf16), %s"
        % (runs["dp 2"][2], runs["dp 1"][2], card))
    PHASE_NOTES["resnet_dp"] = dict(w0=w0, a0=a0, inputs=inputs, opt=opt,
                                    second=second)


def dp_param_rules(mx, build, card):
    """30(c): the LM with its FFN input weights split over tp=2 (dp 1) on
    cuda:0 against the unsharded trainer: bitwise equal parameters, half
    of each matched weight and slot at each position."""
    from mxnet_tpu_torch.parallel import build_mesh

    L = TRAIN["num_layers"]
    sym = mx.models.transformer_lm(**TRAIN)
    X, Y = lm_stream(DP_LM_BATCH, seed=31)
    inputs = {"data": torch.tensor(X, device="cuda"),
              "softmax_label": torch.tensor(Y, device="cuda")}
    shapes = {n: tuple(v.shape) for n, v in inputs.items()}
    w0, a0 = _dp_init(mx, sym, shapes)
    opt = ("adam", {"learning_rate": TRAIN_LR, "rescale_grad": 1.0 / DP_LM_BATCH})
    want, _, _, _ = _dp_steps(_dp_trainer(mx, sym, build_mesh({"dp": 1}),
                                          shapes, *opt), w0, a0, inputs,
                              DP_TP_STEPS)
    tr = _dp_trainer(mx, sym, build_mesh({"dp": 1, "tp": 2}), shapes, *opt,
                     param_rules=DP_TP_RULES)
    _zero(build)
    params, _, states, _ = _dp_steps(tr, w0, a0, inputs, DP_TP_STEPS)
    counts = _counts(build)
    matched = sorted(n for n, sd in tr.shard_dims.items() if sd is not None)
    check(len(matched) == L, "30(c): the rules matched %s" % matched)
    for n in matched:
        full = tuple(tr.arg_shapes[n])
        for p in range(2):
            shapes_p = [tuple(params[n][p].shape)] + [
                tuple(s.shape) for s in states[n][p]]
            check(all(s == (full[0] // 2,) + full[1:] for s in shapes_p),
                  "30(c): position %d holds %s of %s %s" % (p, shapes_p, n, full))
    diff = [n for n in want if not torch.equal(tr.gather(n, params[n]), want[n])]
    log("  (c) param_rules %s over %s: %d weights split (%s of %s each, "
        "their 2 Adam slots too), %d steps; parameters bitwise equal to the "
        "unsharded trainer's: %s; launches %s"
        % (DP_TP_RULES, tr.mesh, len(matched), (tr.shard_shape(matched[0]),),
           tuple(tr.arg_shapes[matched[0]]), DP_TP_STEPS, not diff,
           {k: counts[k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}))
    check(not diff, "30(c): parameters differ from the unsharded step: %s" % diff[:4])
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts[k] == 2 * L * DP_TP_STEPS,
              "30(c): %s launched %d times" % (k, counts[k]))
    return counts


def dp_module_fit(mx, build, card):
    """30(d): ``Module.fit`` over every card's context, kvstore='device',
    against one card's fit; only where two or more cards are visible.
    Held to what 30(a) holds (C39): one fwd+bwd over the cards against dp
    1 at 30(a)'s bound, and the fits' perplexities batch by batch within
    ``DP_PPL_TOL``; the parameters' distance after the fits is logged (30(a)
    measured 0.334 of a tensor's largest after 9 steps at dp 2 on one card,
    from a ReLU kink, with the perplexities within 3.147e-05)."""
    from mxnet_tpu_torch.parallel import build_mesh

    n = torch.cuda.device_count()
    if n < 2:
        log("  30(d) not run: %d card visible" % n)
        return {}
    B = DP_LM_BATCH * n
    sym = mx.models.transformer_lm(**TRAIN)
    X, Y = lm_stream(4 * B, seed=32)
    inputs = {"data": torch.tensor(X[:B], device="cuda:0"),
              "softmax_label": torch.tensor(Y[:B], device="cuda:0")}
    shapes = {k: tuple(v.shape) for k, v in inputs.items()}
    w0, a0 = _dp_init(mx, sym, shapes)
    cards = ["cuda:%d" % i for i in range(n)]
    dp_grad_check(mx, sym, {1: build_mesh({"dp": 1}, cards[:1]),
                            n: build_mesh({"dp": n}, cards)}, shapes,
                  ("adam", {"learning_rate": TRAIN_LR, "rescale_grad": 1.0 / B}),
                  inputs, w0, a0, "30(d)")
    res, ppl = {}, {}
    _zero(build)
    for tag, ctx in (("one card", [mx.gpu(0)]),
                     ("%d cards" % n, [mx.gpu(i) for i in range(n)])):
        seen = ppl.setdefault(tag, [])

        def per_batch(param, seen=seen):
            seen.append(param.eval_metric.get()[1])
            param.eval_metric.reset()

        mod = mx.mod.Module(sym, context=ctx)
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="device", optimizer="adam",
                optimizer_params={"learning_rate": TRAIN_LR},
                eval_metric=mx.metric.Perplexity(None),
                batch_end_callback=per_batch,
                initializer=mx.init.Xavier(rng=torch.Generator().manual_seed(0)))
        check(mod._fused is not None and mod._fused.trainer.dp == len(ctx),
              "30(d) %s: not fused over %d positions" % (tag, len(ctx)))
        res[tag] = {k: v.data.to("cuda:0") for k, v in mod.get_params()[0].items()}
    one, many = ppl["one card"], ppl["%d cards" % n]
    gap = max(abs(a - b) / b for a, b in zip(many, one))
    worst, rel = _worst_rel(res["%d cards" % n], res["one card"])
    log("  30(d) %d cards against one: perplexities %s against %s, worst %.3e "
        "(tol %.0e); worst parameter %s %.3e of its largest (logged)"
        % (n, ["%.3f" % v for v in many], ["%.3f" % v for v in one], gap,
           DP_PPL_TOL, worst, rel))
    check(len(many) == len(one) == 4, "30(d): %d and %d batches"
          % (len(many), len(one)))
    check(gap <= DP_PPL_TOL, "30(d): the fit over %d cards parts from one "
          "card's perplexities" % n)
    return _counts(build)


def run_dp_phase(mx, build, card):
    """Phase 30 (see the module docstring): the kernel launches of its main
    paths."""
    t0 = time.perf_counter()
    total = {}
    for part in (dp_lm, dp_param_rules, dp_module_fit):
        for k, c in part(mx, build, card).items():
            total[k] = total.get(k, 0) + c
        torch.cuda.empty_cache()
    dp_resnet(mx, build, card)
    torch.cuda.empty_cache()
    log("  phase 30: %.1f s; K1/K2a/K2b launches on its main paths %s"
        % (time.perf_counter() - t0,
           {k: total.get(k, 0) for k in ("flash_fwd", "flash_bwd_dkv",
                                         "flash_bwd_dq")}))
    return total


# ------------- A6d's remainder: the data-parallel train artifact (phase 31)
DPA_BATCH = ART_TRAIN_BATCH   # 31(a): the LM's global batch of 32 x 128
DPA_STEPS = 8                 # 31(a): steps compared, cycling phase 5's 4
DPA_TIMED_STEPS = 5           # 31(a): runtime steps timed after them
DPA_RESNET_STEPS = 2          # 31(b): 30(b)'s inputs, SGD with momentum
DPA_MLP_DEVICES = 8           # 31(c): tests/test_train_native_spmd.py's run
DPA_MLP_STEPS = 300
# 31(a): each runtime step at dp 2 against SPMDTrainer's at dp 2, per
# parameter relative to its largest value: 28(f)'s yardstick for the
# runtime against the fused step (the same kernels in the same order;
# bitwise so far)
DPA_STEP_TOL = 1e-6
# 31(d): the LM executor bound at batch 32, reshaped to these
RESHAPE_BATCHES = (16, 8)


def _dp_artifact_steps(mx, P, lib, path, X, Y, lr, n, d):
    """The runtime's steps of the LM artifact at ``path`` (``n``
    positions) over the ``ART_BATCHES`` batches of (X, Y), cycled: the
    parameters, the perplexity and the runtime's K1/K2a/K2b launches of
    each step (read every step), and the mean ms of ``DPA_TIMED_STEPS``
    steps after them."""
    import os

    L, T, B, V = (TRAIN["num_layers"], TRAIN["seq_len"], DPA_BATCH,
                  TRAIN["vocab_size"])
    tr = NativeTrainer(lib, path)
    after, ppl, launches = [], [], []
    for s in range(DPA_STEPS):
        k = s % ART_BATCHES

        def run(k=k):
            tr.step(X[k * B:(k + 1) * B], Y[k * B:(k + 1) * B], lr)
            torch.cuda.synchronize()
            return 1

        launches.append(_native_launched(P, run, {f: n * L for f in FLASH},
                                         "31(a) dp %d step %d" % (n, s + 1)))
        prob = tr.output((B * T, V))
        lab = Y[k * B:(k + 1) * B].reshape(-1).astype(np.int64)
        ppl.append(math.exp(float(-np.log(np.maximum(
            prob[np.arange(B * T), lab], 1e-30)).mean())))
        tr.save(os.path.join(d, "dp%d_step.params" % n))
        after.append({key[4:]: v.asnumpy() for key, v in mx.nd.load(
            os.path.join(d, "dp%d_step.params" % n)).items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DPA_TIMED_STEPS):
        tr.step(X[:B], Y[:B], lr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DPA_TIMED_STEPS
    tr.free()
    return after, ppl, launches, ms


def _spmd_lm_per_step(mx, sym, mesh, init, X, Y, lr):
    """SPMDTrainer's steps over ``mesh`` (its first eager, the rest one
    captured graph) over the same cycled batches: the parameters after
    each."""
    B, T = DPA_BATCH, TRAIN["seq_len"]
    tr = _dp_trainer(mx, sym, mesh, {"data": (B, T), "softmax_label": (B, T)},
                     "adam", {"learning_rate": lr})
    params = tr.place({n: torch.tensor(init[n], device="cuda:0")
                       for n in tr.param_names})
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    after = []
    for s in range(DPA_STEPS):
        k = s % ART_BATCHES
        buf["data"].copy_(torch.tensor(X[k * B:(k + 1) * B]))
        buf["softmax_label"].copy_(torch.tensor(Y[k * B:(k + 1) * B]))
        tr.step(params, {}, states)
        after.append({n: tr.gather(n, v).cpu().numpy().copy()
                      for n, v in params.items()})
    return after


def dp_artifact_lm(mx, P, lib, d, card):
    """31(a): the LM at full width exported at dp 2 and at dp 1 and trained
    by the runtime in this process, each dp 2 step against SPMDTrainer's
    at dp 2 on the same mesh and batches."""
    import os

    from mxnet_tpu_torch.parallel import build_mesh

    L, T, B = TRAIN["num_layers"], TRAIN["seq_len"], DPA_BATCH
    lr = float(np.float32(TRAIN_LR))
    sym = mx.models.transformer_lm(**TRAIN)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(initializer=mx.init.Xavier(
        rng=torch.Generator().manual_seed(0)))     # phase 5's initializer
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    del mod
    X, Y = lm_stream(B * ART_BATCHES)
    arts, manifests = {}, {}
    for n in (2, 1):
        arts[n] = os.path.join(d, "lm_dp%d.mxa" % n)
        manifests[n] = mx.export_train_artifact(
            sym, {"data": (B, T), "softmax_label": (B, T)}, arts[n],
            optimizer="adam", optimizer_params={"learning_rate": lr},
            arg_params=init, num_devices=n)
    check(manifests[2]["num_devices"] == 2 and {a["role"]: a["sharding"] for a
          in manifests[2]["args"]}["data"] == "batch",
          "31(a): the dp 2 manifest: %s" % manifests[2]["args"][-4:])
    runs = {n: _dp_artifact_steps(mx, P, lib, arts[n], X, Y, lr, n, d)
            for n in (2, 1)}
    want = _spmd_lm_per_step(mx, sym, build_mesh({"dp": 2}), init, X, Y, lr)
    worst, bitwise = [], 0
    for s, (got, ref) in enumerate(zip(runs[2][0], want)):
        rel = {n: float(np.abs(got[n] - ref[n]).max())
               / max(float(np.abs(ref[n]).max()), 1e-30) for n in ref}
        name = max(rel, key=rel.get)
        worst.append((name, rel[name]))
        bitwise += all(np.array_equal(got[n], ref[n]) for n in ref)
        check(rel[name] <= DPA_STEP_TOL, "31(a) step %d: the runtime's dp 2 "
              "parameters part from SPMDTrainer's dp 2: %s %.3e of its largest"
              % (s + 1, name, rel[name]))
    ppl2, ppl1 = runs[2][1], runs[1][1]
    gap = max(abs(a - b) / b for a, b in zip(ppl2, ppl1))
    loss2, loss1 = math.log(ppl2[0]), math.log(ppl1[0])
    check(abs(loss2 - loss1) <= DP_GRAD_TOL * abs(loss1),
          "31(a): the first step's loss at dp 2 (%.7f) is not dp 1's (%.7f)"
          % (loss2, loss1))
    check(gap <= DP_PPL_TOL, "31(a): the dp 2 perplexities %s part from dp "
          "1's %s" % (ppl2, ppl1))
    per_step = sorted({tuple(r[k] for k in FLASH) for r in runs[2][2]})
    log("  (a) the LM (batch %d x %d, Adam lr %g, phase 5's initial "
        "parameters) exported at dp 2 and dp 1, %d runtime steps each: "
        "K1/K2a/K2b per dp 2 step %s from the runtime's counters (dp 1: %s); "
        "against SPMDTrainer at dp 2 per step worst %s (tol %.0e of the "
        "largest), %d of %d steps bitwise; the first step's loss %.7f / "
        "%.7f at dp 2 / dp 1 (bitwise: %s); perplexities %s against %s, "
        "worst %.3e (tol %.0e); runtime step %.3f ms at dp 2 against %.3f "
        "ms at dp 1 (%.2fx), eager, %s"
        % (B, T, lr, DPA_STEPS, per_step,
           sorted({tuple(r[k] for k in FLASH) for r in runs[1][2]}),
           ["%s %.3e" % w for w in worst], DPA_STEP_TOL, bitwise, DPA_STEPS,
           loss2, loss1, ppl2[0] == ppl1[0], ["%.3f" % v for v in ppl2],
           ["%.3f" % v for v in ppl1], gap, DP_PPL_TOL, runs[2][3], runs[1][3],
           runs[2][3] / runs[1][3], card))
    return {k: sum(r[k] for r in runs[2][2] + runs[1][2]) for k in FLASH}


def dp_artifact_resnet(mx, P, lib, d):
    """31(b): ResNet-50 in bf16 at batch 32 exported at dp 2 and trained by
    the runtime for 2 steps from 30(b)'s start on 30(b)'s inputs, against
    30(b)'s SPMDTrainer at dp 2 after its second step (BatchNorm's global
    statistics at full width)."""
    import os

    notes = PHASE_NOTES["resnet_dp"]
    sym = mx.models.resnet(**RESNET)
    inputs = {k: v.cpu().numpy() for k, v in notes["inputs"].items()}
    w0 = {k: v.cpu().numpy() for k, v in notes["w0"].items()}
    a0 = {k: v.cpu().numpy() for k, v in notes["a0"].items()}
    opt, opt_params = notes["opt"]
    art = os.path.join(d, "resnet_dp2.mxa")
    mx.export_train_artifact(
        sym, {k: v.shape for k, v in inputs.items()}, art, optimizer=opt,
        optimizer_params=opt_params, arg_params=w0, aux_params=a0,
        compute_dtype="bfloat16", num_devices=2)
    tr = NativeTrainer(lib, art)
    for _ in range(DPA_RESNET_STEPS):
        tr.step(inputs["data"], inputs["softmax_label"],
                opt_params["learning_rate"])
    tr.save(os.path.join(d, "resnet_dp2.params"))
    tr.free()
    saved = mx.nd.load(os.path.join(d, "resnet_dp2.params"))
    got = ({k[4:]: v.data for k, v in saved.items() if k.startswith("arg:")},
           {k[4:]: v.data for k, v in saved.items() if k.startswith("aux:")})
    second = notes["second"]
    for k, what, start in ((0, "parameters", notes["w0"]),
                           (1, "moving statistics", notes["a0"])):
        w2, r2, s2 = _apart(got[k], second["dp 2"][k], start)
        wf, rf, _ = _apart(second["dp 1"][k], second["dp 1 float32"][k], start)
        same = all(torch.equal(got[k][n].to(v.device), v)
                   for n, v in second["dp 2"][k].items())
        log("  (b) ResNet-50 bf16 at dp 2 through the runtime after %d steps, "
            "%s (largest move from the start %.4g): against 30(b)'s "
            "SPMDTrainer at dp 2 worst %s %.3e of it (bitwise: %s); 30(b)'s "
            "dp 1 bf16 against float32 %s %.3e (bound: %.1fx that)"
            % (DPA_RESNET_STEPS, what, s2, w2, r2, same, wf, rf,
               DP_RESNET_FACTOR))
        check(s2 > 0, "31(b): the %s did not move" % what)
        check(r2 <= DP_RESNET_FACTOR * rf, "31(b): the runtime's dp 2 %s part "
              "from SPMDTrainer's beyond bf16's own distance" % what)
    del PHASE_NOTES["resnet_dp"]


def dp_artifact_client_start(mx, paths, d):
    """31(c): the JAX package's C training client, unchanged, trains a dp 8
    MLP artifact with its positions on cuda:0 (C41), in a process of its
    own: started here, read by :func:`dp_artifact_client_wait`."""
    import os

    from mxnet_tpu_torch import _predict_native

    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    art = os.path.join(d, "mlp_dp%d.mxa" % DPA_MLP_DEVICES)
    rs = np.random.RandomState(5)
    init = {"fc1_weight": rs.randn(16, 8).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rs.randn(3, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}
    m = mx.export_train_artifact(
        net, {"data": (32, 8)}, art, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, seed=3,
        num_devices=DPA_MLP_DEVICES, arg_params=init)
    check(m["num_devices"] == DPA_MLP_DEVICES and m["platform"] == "cuda",
          "31(c): the manifest says %s devices on %s" % (m["num_devices"],
                                                         m["platform"]))
    rs = np.random.RandomState(11)
    cent = rs.randn(3, 8).astype(np.float32) * 3
    y = (np.arange(128) % 3).astype(np.float32)
    x = (cent[y.astype(int)] + rs.randn(128, 8)).astype(np.float32)
    x.tofile(os.path.join(d, "mlp_d.f32"))
    y.tofile(os.path.join(d, "mlp_l.f32"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [paths["train"], art, os.path.join(d, "mlp_d.f32"),
         os.path.join(d, "mlp_l.f32"), "32", str(DPA_MLP_STEPS), "0.05",
         os.path.join(d, "mlp_dp.params"), os.path.join(d, "mlp_loss.txt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_predict_native.client_env())
    return proc, t0


def dp_artifact_client_wait(mx, started, d):
    import os

    proc, t0 = started
    out, err = proc.communicate(timeout=ART_TIMEOUT)
    check(proc.returncode == 0, "31(c): train_native_client.c exited %d:\n%s"
          "\n%s" % (proc.returncode, out[-2000:], err[-2000:]))
    losses = [float(line.split()[1])
              for line in open(os.path.join(d, "mlp_loss.txt"))]
    check(losses[-1] < losses[0] * 0.5, "31(c): the dp %d MLP's loss did not "
          "halve: %s" % (DPA_MLP_DEVICES, losses[::50]))
    saved = mx.nd.load(os.path.join(d, "mlp_dp.params"))
    check(sorted(saved) == ["arg:fc1_bias", "arg:fc1_weight", "arg:fc2_bias",
                            "arg:fc2_weight"], "31(c): saved %s" % sorted(saved))
    log("  (c) train_native_client.c (unchanged) trained the dp %d MLP "
        "artifact with its %d positions on cuda:0 (%d card visible), %d "
        "steps: loss %.4f -> %.4f; %.1f s"
        % (DPA_MLP_DEVICES, DPA_MLP_DEVICES, torch.cuda.device_count(),
           DPA_MLP_STEPS, losses[0], losses[-1], time.perf_counter() - t0))


def executor_reshape(mx, build):
    """31(d): ``Executor.reshape`` of the LM executor bound at batch 32 on
    the card to batches 16 and 8: the parameters the same arrays (the same
    storage), each forward through K1 once per layer, the logits held to
    the CPU's at the same batch."""
    L, T = TRAIN["num_layers"], TRAIN["seq_len"]
    sym = mx.models.transformer_lm(**TRAIN)
    group = mx.sym.Group([sym, sym.get_internals()["lm_head_output"]])
    w0, _ = _dp_init(mx, sym, {"data": (DP_LM_BATCH, T),
                               "softmax_label": (DP_LM_BATCH, T)})
    ex = group.simple_bind(mx.gpu(0), grad_req="null",
                           data=(DP_LM_BATCH, T), softmax_label=(DP_LM_BATCH, T))
    for n, v in w0.items():
        ex.arg_dict[n][:] = v
    X, _ = lm_stream(DP_LM_BATCH, seed=33)
    cpu = group.simple_bind(mx.cpu(), grad_req="null", data=(8, T),
                            softmax_label=(8, T))
    report, launches = [], 0
    for b in RESHAPE_BATCHES:
        new = ex.reshape(data=(b, T), softmax_label=(b, T))
        shared = all(new.arg_dict[n] is ex.arg_dict[n]
                     and new.arg_dict[n].data.data_ptr()
                     == ex.arg_dict[n].data.data_ptr() for n in w0)
        check(shared, "31(d): batch %d does not share the parameters' storage"
              % b)
        check(tuple(new.arg_dict["data"].shape) == (b, T)
              and float(new.arg_dict["data"].data.abs().max()) == 0.0,
              "31(d): batch %d's data is not new zeros" % b)
        new.arg_dict["data"][:] = X[:b]
        _zero(build)
        logits = new.forward(is_train=False)[1].data
        torch.cuda.synchronize()
        counts = _counts(build)
        check(counts["flash_fwd"] == L and counts["flash_bwd_dkv"] == 0,
              "31(d): batch %d's forward launched %s" % (b, counts))
        launches += counts["flash_fwd"]
        cpu_b = cpu.reshape(data=(b, T), softmax_label=(b, T))
        for n, v in w0.items():
            cpu_b.arg_dict[n][:] = v.cpu()
        cpu_b.arg_dict["data"][:] = X[:b]
        want = cpu_b.forward(is_train=False)[1].data
        err = float((logits.cpu() - want).abs().max())
        check(err <= LOGIT_TOL, "31(d): batch %d's logits against the CPU: "
              "%.3e" % (b, err))
        report.append("batch %d: K1 %d, logits %.3e" % (b, counts["flash_fwd"],
                                                        err))
    log("  (d) Executor.reshape of the LM executor bound at batch %d to %s: "
        "the parameters the same arrays and storage, new zeros for data; %s "
        "(tol %.0e against the CPU)" % (DP_LM_BATCH, RESHAPE_BATCHES,
                                        "; ".join(report), LOGIT_TOL))
    return launches


def run_dp_artifact_phase(mx, build, card, work, compiled):
    """Phase 31 (see the module docstring): the launches of its main paths,
    the runtime's counters and the Python wrappers' (31(d))."""
    import os

    from mxnet_tpu_torch import _predict_native as P

    t0 = time.perf_counter()
    paths, _ = compiled
    lib = P.load()
    d = os.path.join(work, "native_rt")
    total = dp_artifact_lm(mx, P, lib, d, card)
    torch.cuda.empty_cache()
    client = dp_artifact_client_start(mx, paths, d)
    dp_artifact_resnet(mx, P, lib, d)
    torch.cuda.empty_cache()
    total["flash_fwd"] += executor_reshape(mx, build)
    dp_artifact_client_wait(mx, client, d)
    torch.cuda.empty_cache()
    log("  phase 31: %.1f s; K1/K2a/K2b launches on its main paths %s"
        % (time.perf_counter() - t0, [total[k] for k in FLASH]))
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs the port on the card only", file=sys.stderr)
        return 2
    import os
    import shutil
    import tempfile

    # the run's scratch: phase 2 fills a fresh compile cache here (25(b)),
    # and phase 24(c) leaves its traces here for 25(d)
    work = tempfile.mkdtemp(prefix="chip_smoke-")
    os.environ["MXNET_COMPILE_CACHE_DIR"] = os.path.join(work, "cc")
    try:
        return _main(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _main(work):
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
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    # the host's builds that phases 20 and 26 load start beside the nvcc
    # runs, which leave cores idle while the slowest source compiles
    with ThreadPoolExecutor(2) as pool:
        native_job = pool.submit(timed, _native._build)
        capi_job = pool.submit(capi_compile, work)
        build.build()
        log("  built %s in %.2f s" % (sorted(build.KERNELS),
                                      time.perf_counter() - t0))
        native_s = native_job.result()[1]
        capi_compiled = capi_job.result()
    log("  beside them: the native host stage in %.2f s, the C library and "
        "phase 26's clients in %.2f s" % (native_s, capi_compiled[1]))
    rt_proc = native_rt_start()
    log("  phase 28's runtime builds from here on in a process at the lowest "
        "CPU priority (pid %d)" % rt_proc.pid)
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
    for name, n in run_data_phase(mx, A, build, card, rn_fused,
                                  native_s).items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log("== 21. the example scripts and mx.kv: train_lm, dist_sync across "
        "two workers and a server (%s)" % card)
    d_launches, dist_params, dist_step_s = run_dist_phase(mx, build, card,
                                                          t_counts)
    for name, n in d_launches.items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log("== 22. model parallelism: ring and Ulysses attention, the sp/pp/ep "
        "LM trainers, group2ctx, two contexts (%s)" % card)
    for name, n in run_model_parallel_phase(mx, A, build, card).items():
        row = next((r for r in rows if r["name"] == name), None)
        if row is not None:
            row["launches"] += n

    log("== 23. A7's training half on the LM's fit: the health guard, the "
        "monitor, the profiler, compileobs, the mirror (%s)" % card)
    for name, n in run_observability_phase(mx, build, card).items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log("== 24. A6c: a server primary and a worker killed under "
        "tools/launch.py --elastic; cluster statistics (%s)" % card)
    e_launches = run_elastic_phase(mx, build, card, dist_params, work)
    for name, n in e_launches.items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    from concurrent.futures import ThreadPoolExecutor

    # two clusters run beside the phase after theirs, each of which times
    # nothing that a check holds: 24(c) beside 25(a)-(c), 27(a) beside 26
    with ThreadPoolExecutor(1) as pool:
        log("== 25. A7's compiler half on the LM's fit: the graph passes, the "
            "compile cache's warm start, mx.rtc, trace_merge and mxtop; "
            "beside it 24(c), cluster statistics (%s)" % card)
        straggle = pool.submit(straggler_run, work, dist_params)
        for name, n in run_compiler_phase(mx, build, card, work,
                                          straggle).items():
            next(r for r in rows if r["name"] == name)["launches"] += n

        t0 = time.perf_counter()
        static = static_lock_edges()
        log("  the static lock graph of mxnet_tpu_torch/ for 27: %d locks, %d "
            "edges (%.2f s)" % (len({n for e in static for n in e}),
                                len(static), time.perf_counter() - t0))
        log("== 26. A8a, the C boundary: the LM predicted and trained by "
            "compiled C/C++ clients; ResNet-50 scored through MXPredForward; "
            "beside it 27(a)'s sanitized cluster (%s)" % card)
        sanitized = pool.submit(sanitized_fit, build, card, static,
                                dist_params, dist_step_s)
        for name, n in run_capi_phase(mx, build, card, t_params, work,
                                      capi_compiled).items():
            next(r for r in rows if r["name"] == name)["launches"] += n

        log("== 27. A7's last part, analysis/: the engine sanitizer and the "
            "lock witness, strict, over the dist_sync fit and the serving "
            "engine (%s)" % card)
        for name, n in run_analysis_phase(
                mx, S, M, build, card, static, sanitized,
                (launches, counts["streams"])).items():
            next(r for r in rows if r["name"] == name)["launches"] += n

    log("== 28. A8b, the Python-free artifact: the LM predicted and trained "
        "by compiled C clients from .mxa artifacts through the port's "
        "kernels; ResNet-50 and the wide route (%s)" % card)
    art_compiled = native_rt_compile(work, rt_proc)
    for name, n in run_artifact_phase(mx, build, card, t_params, w_params,
                                      work, art_compiled).items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log("== 29. the repo tools on the card: bench_pipeline, bandwidth, "
        "baseline_matrix (DCGAN classic and as one CUDA graph, SSD, LSTM), "
        "gen_op_docs, gen_api_docs, c_api_coverage (%s)" % card)
    run_tools_phase(mx, card, work)

    log("== 30. A6d, the data-parallel fused step: the LM at dp 2 on one "
        "card against dp 1, ResNet-50's BatchNorm, param_rules, Module.fit "
        "over the cards (%s)" % card)
    for name, n in run_dp_phase(mx, build, card).items():
        row = next((r for r in rows if r["name"] == name), None)
        if row is not None:
            row["launches"] += n

    log("== 31. A6d's remainder: the data-parallel train artifact through the "
        "Python-free runtime (the LM at dp 2, ResNet-50's BatchNorm, the C "
        "client at dp 8); Executor.reshape (%s)" % card)
    for name, n in run_dp_artifact_phase(mx, build, card, work,
                                         art_compiled).items():
        next(r for r in rows if r["name"] == name)["launches"] += n

    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
