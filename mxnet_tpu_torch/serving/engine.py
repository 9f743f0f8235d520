"""ServingEngine — the standing inference engine's Python API (the port of
``mxnet_tpu/serving/engine.py``).

One engine owns: the weights (a trained checkpoint's ``arg_params`` or
deterministic ``random_params``) as torch tensors on its device, one
:class:`~.kv_cache.KVBlockPool`, one :class:`~.scheduler.Scheduler`, and
one :class:`~.graphs.BucketGraph` per program and padded shape bucket,
as the JAX package compiles one program per bucket and replays it:
``serving.prefill`` per prompt-length bucket, ``serving.decode`` per
batch bucket and, with ``spec_k > 0``, ``serving.draft`` (the draft's
prefill per length bucket and its decode per batch bucket) and
``serving.verify`` per batch bucket. On the card each is a CUDA graph
captured at the bucket's first call (:meth:`ServingEngine.warmup` calls
every one) and replayed after; on the CPU it runs eagerly. The padded
shapes keep the batch composition (and so every row's result)
independent of the other rows. A call that has to capture debits its
wall to the requests' ``compile_stall`` phase.

Each :meth:`step` runs the scheduler's plan: admitted prompts prefill into
the shared block pool (one call per request at its length bucket), then
every decoding stream advances one token through the fused paged decode
step at the batch bucket — or, with ``spec_k > 0``, up to ``spec_k + 1``
tokens through speculative decoding: a draft model proposes ``spec_k``
greedy tokens over its own pages, the target scores the whole window in
one :func:`.model.extend` pass (the multi-query paged kernel) and greedy
acceptance emits the target's tokens, so the stream equals target-only
decoding. The step inputs go up as one int32 buffer per
call; the ONLY device->host reads are the next-token vectors (``.cpu()``)
— that read IS the product (tokens leave for clients) — and the draft's
proposals between its inner steps. The pool pages are allocated once and
written in place call to call, so every graph keeps its addresses.

Thread model: ``submit()`` is safe from any thread; ``step()`` /
``run_loop()`` must run on one stepping thread. Per-request latency metrics
(TTFT, end-to-end, tokens/sec) flow through the telemetry registry.

``stats()["compiles"]`` counts each program's captures, their seconds and
the replays after them, keyed as the JAX package's ``compiles`` block;
each capture is also a ``compileobs`` compile of its program. CUDA graphs
do not outlive the process; ``stats()["compile_cache"]`` is the persistent
cache's snapshot (:func:`..compile_cache.stats`: it keeps the kernels'
nvcc libraries, ``ROADMAP.md`` C18), as in the JAX package.
"""
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import compile_cache, context, fault, telemetry
from ..analysis import witness
from ..base import env_bool, env_int, env_str, torch_dtype
from . import model as _model
from .graphs import BucketGraph
from .kv_cache import KVBlockPool
from .obs import ServingObs
from .resilience import ServingOverloadError, retry_after_s
from .scheduler import (CANCELLED, DECODING, FAILED, FINISHED, TIMED_OUT,
                        WAITING, Request, Scheduler)

_engine_ids = itertools.count()


class ServingConfig(_model.ModelConfig):
    """Model shape + engine knobs. Engine knobs default from the
    ``MXNET_SERVING_*`` environment, as in the JAX package."""

    __slots__ = ("block_size", "num_blocks", "max_batch",
                 "prefills_per_step", "kv_dtype", "prefix_cache",
                 "spec_k", "draft", "max_queue", "default_timeout_ms")

    def __init__(self, vocab_size=32000, num_layers=4, model_dim=256,
                 num_heads=4, ffn_dim=1024, max_len=128,
                 block_size=None, num_blocks=None, max_batch=None,
                 prefills_per_step=None, kv_dtype=np.float32,
                 prefix_cache=None, spec_k=None, draft=None,
                 max_queue=None, default_timeout_ms=None):
        super().__init__(vocab_size, num_layers, model_dim, num_heads,
                         ffn_dim, max_len)
        self.block_size = int(block_size if block_size is not None
                              else env_int("MXNET_SERVING_BLOCK_SIZE", 16))
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else env_int("MXNET_SERVING_NUM_BLOCKS", 257))
        self.max_batch = int(max_batch if max_batch is not None
                             else env_int("MXNET_SERVING_MAX_BATCH", 32))
        self.prefills_per_step = int(
            prefills_per_step if prefills_per_step is not None
            else env_int("MXNET_SERVING_PREFILLS_PER_STEP", 4))
        self.kv_dtype = torch_dtype(kv_dtype)
        # prefix sharing: content-hash full prefill blocks so same-prefix
        # admissions map cached blocks (refcounted, copy-on-write)
        self.prefix_cache = bool(
            prefix_cache if prefix_cache is not None
            else env_bool("MXNET_SERVING_PREFIX_CACHE", True))
        # speculative decoding: spec_k draft proposals per step (0 = off)
        # from the draft named by ``draft`` ("self" or a zoo preset)
        self.spec_k = int(spec_k if spec_k is not None
                          else env_int("MXNET_SERVING_SPEC_K", 0))
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables speculative "
                             "decoding)")
        self.draft = str(draft if draft is not None
                         else env_str("MXNET_SERVING_DRAFT", "self"))
        # resilience knobs: a bounded admission queue sheds load at submit,
        # and a default deadline bounds how long any request may live
        self.max_queue = int(max_queue if max_queue is not None
                             else env_int("MXNET_SERVING_MAX_QUEUE", 0))
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        self.default_timeout_ms = int(
            default_timeout_ms if default_timeout_ms is not None
            else env_int("MXNET_SERVING_DEFAULT_TIMEOUT_MS", 0))
        if self.default_timeout_ms < 0:
            raise ValueError("default_timeout_ms must be >= 0 (0 = no "
                             "default deadline)")
        if self.max_len % self.block_size:
            raise ValueError(
                "max_len (%d) must be a multiple of block_size (%d): "
                "prefill buckets and the decode block table are sized in "
                "whole blocks" % (self.max_len, self.block_size))

    def decode_buckets(self):
        """Padded decode batch sizes: powers of two up to max_batch."""
        out = []
        b = 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def prefill_buckets(self):
        """Padded prompt lengths: block_size doublings up to max_len."""
        out = []
        s = self.block_size
        while s < self.max_len:
            out.append(s)
            s *= 2
        out.append(self.max_len)
        return out


def _bucket_for(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError("no bucket holds %d (buckets %s)" % (n, buckets))


class ServingEngine:
    """Continuous-batching inference over the Transformer-LM zoo model.

    ``device`` None runs on the card (:func:`..context.default_device`,
    which raises without CUDA); pass ``device="cpu"`` for the plain
    PyTorch path."""

    def __init__(self, config, arg_params=None, seed=0, device=None,
                 enable_telemetry=True):
        cfg = config
        if enable_telemetry:
            telemetry.enable()
        self.config = cfg
        self.device = context.resolve(device)
        if arg_params is None:
            arg_params = _model.random_params(cfg, seed=seed)
        self.params = _model.as_device_params(arg_params, cfg,
                                              device=self.device)
        self.pool = KVBlockPool(cfg.num_layers, cfg.num_blocks,
                                cfg.block_size, cfg.num_heads,
                                cfg.model_dim // cfg.num_heads,
                                dtype=cfg.kv_dtype, device=self.device,
                                prefix_cache=cfg.prefix_cache)
        # speculative decoding writes spec_k+1 window slots per step, so
        # headroom lookahead covers the whole draft+verify window
        self._spec = cfg.spec_k > 0
        self.spec_k = cfg.spec_k
        self.scheduler = Scheduler(self.pool, max_batch=cfg.max_batch,
                                   prefills_per_step=cfg.prefills_per_step,
                                   lookahead=cfg.spec_k + 1,
                                   max_positions=cfg.max_len)
        self._nb_max = cfg.max_len // cfg.block_size
        self._lock = threading.RLock()
        self._lock = witness.declare(
            "mxnet_tpu_torch.serving.engine.ServingEngine._lock", self._lock)
        self._work = threading.Condition(self._lock)
        # retired requests awaiting pop_finished(), BOUNDED so a caller
        # that consumes done_events instead never leaks Requests
        self._finished = deque(maxlen=max(256, 8 * cfg.max_batch))
        self._aborted = None
        self._draining = False
        # supervisor contract (resilience.EngineSupervisor): when set,
        # abort() parks still-salvageable requests for a fresh engine
        self.salvage_on_abort = False
        self._salvaged = []
        self._steps = 0
        # per-engine tallies (the registry counters are process-global)
        self._n_completed = 0
        self._n_failed = 0
        self._n_timed_out = 0
        self._n_cancelled = 0
        self._n_shed = 0
        self._token_window = []   # one timestamp per token, for tokens/sec
        self._t_started = time.time()
        self._tokens_total = 0
        self.engine_id = next(_engine_ids)
        self.obs = ServingObs(self.engine_id)

        # ---- the programs: one graph per bucket over weights and pages --
        self._prefill_graphs = self._prefill_bucket_graphs(
            "serving.prefill", self.params, self.pool.k_pages,
            self.pool.v_pages, cfg)
        self._decode_graphs = self._decode_bucket_graphs(
            "serving.decode", self.params, self.pool.k_pages,
            self.pool.v_pages, cfg)

        # ---- speculative decoding: the draft model and its own pages ----
        self._draft_params = None
        self._draft_kp = self._draft_vp = None
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_draft_s = 0.0
        self._spec_verify_s = 0.0
        if self._spec:
            dcfg = _model.draft_config(cfg, cfg.draft)
            self.draft_config = dcfg
            if dcfg.key() == cfg.key():
                # self-drafting: the draft IS the target (shared weights),
                # so proposals match the verify pass
                self._draft_params = self.params
            else:
                self._draft_params = _model.as_device_params(
                    _model.random_params(dcfg, seed=seed), dcfg,
                    device=self.device)
            dshape = (dcfg.num_layers, cfg.num_blocks, cfg.block_size,
                      dcfg.num_heads, dcfg.model_dim // dcfg.num_heads)
            self._draft_kp = torch.zeros(dshape, dtype=cfg.kv_dtype,
                                         device=self.device)
            self._draft_vp = torch.zeros(dshape, dtype=cfg.kv_dtype,
                                         device=self.device)
            self._draft_prefill_graphs = self._prefill_bucket_graphs(
                "serving.draft", self._draft_params, self._draft_kp,
                self._draft_vp, dcfg)
            self._draft_decode_graphs = self._decode_bucket_graphs(
                "serving.draft", self._draft_params, self._draft_kp,
                self._draft_vp, dcfg)
            T = self.spec_k + 1
            self._verify_graphs = {
                B: BucketGraph(
                    "serving.verify", self._step_fn(
                        _model.extend, self.params, self.pool.k_pages,
                        self.pool.v_pages, cfg),
                    [(B, T), (B, T), (B, self._nb_max), (B, T)], self.device)
                for B in cfg.decode_buckets()}

    # a graph returns (next tokens, logits); the pages are written in place
    @staticmethod
    def _step_fn(step, params, k_pages, v_pages, cfg):
        def fn(*inputs):
            return step(params, *inputs, k_pages, v_pages, cfg)[:2]
        return fn

    def _prefill_bucket_graphs(self, program, params, k_pages, v_pages, cfg):
        bs = self.config.block_size
        fn = self._step_fn(_model.prefill, params, k_pages, v_pages, cfg)
        return {S: BucketGraph(program, fn, [(1, S), (1,), (S // bs,)],
                               self.device)
                for S in self.config.prefill_buckets()}

    def _decode_bucket_graphs(self, program, params, k_pages, v_pages, cfg):
        fn = self._step_fn(_model.decode, params, k_pages, v_pages, cfg)
        return {B: BucketGraph(program, fn,
                               [(B,), (B,), (B, self._nb_max), (B,)],
                               self.device)
                for B in self.config.decode_buckets()}

    def bucket_graphs(self):
        """Every bucket graph of this engine, program by program."""
        out = list(self._prefill_graphs.values()) \
            + list(self._decode_graphs.values())
        if self._spec:
            out += list(self._draft_prefill_graphs.values()) \
                + list(self._draft_decode_graphs.values()) \
                + list(self._verify_graphs.values())
        return out

    @staticmethod
    def _capture_totals(graphs):
        return (sum(g.captures for g in graphs),
                sum(g.capture_s for g in graphs))

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens, eos_id=None, request_id=None,
               timeout_s=None):
        """Enqueue a request; returns the :class:`Request` (its
        ``done_event`` is set when it finishes). ``timeout_s`` sets the
        request's deadline (default from ``MXNET_SERVING_DEFAULT_TIMEOUT_MS``;
        None/0 = none). Raises :class:`ServingOverloadError` when the
        engine is draining or the admission queue is at ``cfg.max_queue``."""
        if timeout_s is None and self.config.default_timeout_ms > 0:
            timeout_s = self.config.default_timeout_ms / 1000.0
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      request_id=request_id, timeout_s=timeout_s)
        total = len(req.prompt) + req.max_new_tokens
        if total > self.config.max_len:
            raise ValueError(
                "request needs %d total positions > max_len %d (the "
                "position-embedding table bounds every stream)"
                % (total, self.config.max_len))
        if self.pool.blocks_for(total) > self.pool.num_usable:
            raise ValueError(
                "request needs %d KV blocks > pool capacity %d"
                % (self.pool.blocks_for(total), self.pool.num_usable))
        req.done_event = threading.Event()
        with self._work:
            if self._aborted is not None:
                raise RuntimeError(self._aborted)
            if self._draining:
                telemetry.counter("serving.shed").inc()
                self._n_shed += 1
                raise ServingOverloadError(
                    "engine is draining (admission closed)",
                    reason="draining",
                    retry_after_s=retry_after_s(self))
            if (self.config.max_queue
                    and len(self.scheduler.waiting) >= self.config.max_queue):
                telemetry.counter("serving.shed").inc()
                self._n_shed += 1
                raise ServingOverloadError(
                    "admission queue full (%d waiting >= max_queue %d)"
                    % (len(self.scheduler.waiting), self.config.max_queue),
                    reason="queue_full",
                    retry_after_s=retry_after_s(self))
            self.obs.request_submitted(req)
            self.scheduler.add(req)
            self._work.notify_all()
        return req

    def cancel(self, req):
        """Mark ``req`` for cancellation (safe from any thread). The next
        step's sweep moves it to CANCELLED and frees its KV blocks."""
        with self._work:
            if not req.finished():
                req.cancelled = True
                self._work.notify_all()

    def cancel_all(self):
        """Cancel every non-terminal request. Returns the number marked."""
        with self._work:
            n = 0
            for req in (list(self.scheduler.running)
                        + list(self.scheduler.waiting)):
                if not req.finished():
                    req.cancelled = True
                    n += 1
            if n:
                self._work.notify_all()
            return n

    def start_drain(self):
        """Close admission: new submits are shed with ``reason="draining"``
        while inflight work keeps stepping to completion (idempotent)."""
        with self._work:
            if not self._draining:
                self._draining = True
                telemetry.counter("serving.drains").inc()
                telemetry.event("serving.drain", engine=self.engine_id,
                                waiting=len(self.scheduler.waiting),
                                active=len(self.scheduler.running))
                self._work.notify_all()

    @property
    def draining(self):
        with self._lock:
            return self._draining

    @property
    def aborted(self):
        """The abort cause message, or None while the engine is live."""
        with self._lock:
            return self._aborted

    def has_work(self):
        with self._lock:
            return self.scheduler.has_work()

    def step(self):
        """One engine iteration: schedule, prefill admissions, fused decode,
        retire finished requests. Returns the requests that finished.

        A failure escaping the step aborts the engine before re-raising —
        the pool pages may have been written by the failed call and
        cannot be trusted, so every caller gets the same contract: pending
        requests fail loudly, waiters wake, later submits refuse."""
        try:
            with self._lock, telemetry.span("serving.step"):
                # chaos: injected per-step latency
                # fwlint: disable=lock-order — the injected delay models a slow device dispatch, which blocks under the step lock by design
                fault.hit("slow_step")
                # deadline/cancellation sweep BEFORE scheduling
                self.scheduler.sweep()
                plan = self.scheduler.schedule()
                for req in plan.preempted:
                    self.obs.request_preempted(req)
                for req in plan.prefills:
                    self.obs.request_admitted(req)
                failed = self._drain_failed()
                if plan.empty():
                    return failed
                for req in plan.prefills:
                    # fwlint: disable=lock-order — fault.hit("dispatch_error") in the callee can inject a delay; real dispatch blocks under the step lock identically
                    self._run_prefill(req)
                n_preempted = len(plan.preempted)
                if plan.prefills:
                    # a prompt that exactly filled its blocks writes its
                    # first decode token at a fresh block boundary — back
                    # that slot with a real block NOW
                    late = self.scheduler.ensure_decode_headroom()
                    for req in late:
                        self.obs.request_preempted(req)
                    n_preempted += len(late)
                    failed += self._drain_failed()
                decodes = self.scheduler.decodable()
                if decodes:
                    # copy-on-write safety net: a write slot backed by a
                    # SHARED block gets a private bit-exact copy first
                    self._cow_guard(decodes)
                    if self._spec:
                        # fwlint: disable=lock-order — injected dispatch fault may stall; matches real device-dispatch blocking under the step lock
                        self._run_spec_decode(decodes)
                    else:
                        # fwlint: disable=lock-order — injected dispatch fault may stall; matches real device-dispatch blocking under the step lock
                        self._run_decode(decodes)
                finished = [r for r in list(self.scheduler.running)
                            if r.finished()]
                for req in finished:
                    self.scheduler.finish(req)
                    self._retire(req)
                self._steps += 1
                self._refresh_throughput()
                self.obs.step_timeline(
                    step=self._steps, occupancy=len(decodes),
                    admitted=len(plan.prefills), preempted=n_preempted,
                    finished=len(finished) + len(failed),
                    queue=len(self.scheduler.waiting),
                    running=len(self.scheduler.running),
                    kv_used=self.pool.used(), kv_free=self.pool.available(),
                    kv_frag_slots=self.scheduler.frag_slots())
                return finished + failed
        except Exception as exc:
            self.abort(exc)
            raise

    def run_loop(self, stop_event=None, idle_wait_s=0.05):
        """Drive :meth:`step` until ``stop_event`` is set, sleeping on the
        submit condition while idle. A step failure aborts the engine and
        re-raises here, so the stepping thread's death is observable."""
        while stop_event is None or not stop_event.is_set():
            with self._work:
                if not self.scheduler.has_work():
                    self._refresh_throughput()
                    self._work.wait(timeout=idle_wait_s)
                    if not self.scheduler.has_work():
                        continue
            self.step()

    def abort(self, exc):
        """Fail every queued and running request. After an abort the
        engine refuses new submits. Under a supervisor
        (``salvage_on_abort`` set), non-terminal requests are PARKED
        instead: blocks dropped, tokens-so-far kept, done_event unset —
        :meth:`pop_salvaged` hands them to the supervisor."""
        msg = "serving engine aborted: %r" % (exc,)
        with self._lock:
            self._aborted = msg
            self._drain_failed()   # scheduler failures the step never saw
            reqs = list(self.scheduler.running) + list(self.scheduler.waiting)
            self.scheduler.running.clear()
            self.scheduler.waiting.clear()
            if self.salvage_on_abort:
                now = time.time()
                for req in reqs:
                    if req.finished():
                        continue
                    was_running = req.state != WAITING
                    req.blocks = []   # pool accounting is moot post-abort
                    req.shared_blocks = 0
                    req.context_len = 0
                    req.state = WAITING
                    if was_running:
                        req.preemptions += 1
                        req.preempted_t = now
                        telemetry.counter("serving.preemptions").inc()
                        self.obs.request_preempted(req)
                    self._salvaged.append(req)
                return
            for req in reqs:
                req.blocks = []   # pool accounting is moot post-abort
                req.state = FAILED
                req.error = msg
                req.finish_t = time.time()
                telemetry.counter("serving.requests_failed").inc()
                self.obs.request_finished(req, failed=True)
                if req.done_event is not None:
                    req.done_event.set()
            self._finished.extend(reqs)
            self._n_failed += len(reqs)

    def pop_salvaged(self):
        """Drain the requests :meth:`abort` parked for the supervisor."""
        with self._lock:
            out, self._salvaged = self._salvaged, []
            return out

    def resubmit(self, req):
        """Re-admit a request salvaged from a dead engine: it keeps its
        identity, done_event, trace clock and generated-so-far tokens."""
        with self._work:
            if self._aborted is not None:
                raise RuntimeError(self._aborted)
            telemetry.event("serving.request", request_id=req.request_id,
                            engine=self.engine_id, state="resubmitted",
                            generated=len(req.generated),
                            preemptions=req.preemptions)
            self.scheduler.add(req)
            self._work.notify_all()
        return req

    def warmup(self):
        """Capture every program at every bucket in one pass (one call
        each, all-trash block tables, no requests involved): builds the
        CUDA kernels at first use and records each bucket's graph, so the
        first real traffic pays no build or capture wall and the capture
        counts in ``stats()["compiles"]`` stay flat from step one."""
        cfg = self.config
        nb = self._nb_max
        with self._lock:
            prefills = [self._prefill_graphs]
            decodes = [self._decode_graphs]
            if self._spec:
                prefills.append(self._draft_prefill_graphs)
                decodes.append(self._draft_decode_graphs)
            for graphs in prefills:
                for S, g in graphs.items():
                    g(np.zeros((1, S), np.int32), np.ones(1, np.int32),
                      np.zeros(S // cfg.block_size, np.int32))
            for graphs in decodes:
                for B, g in graphs.items():
                    g(np.zeros(B, np.int32), np.zeros(B, np.int32),
                      np.zeros((B, nb), np.int32), np.ones(B, np.int32))
            if self._spec:
                T = self.spec_k + 1
                for B, g in self._verify_graphs.items():
                    g(np.zeros((B, T), np.int32), np.zeros((B, T), np.int32),
                      np.zeros((B, nb), np.int32), np.ones((B, T), np.int32))
            if self.device.type == "cuda":
                # fwlint: disable=host-sync — warmup() returns once every bucket's graph is built
                torch.cuda.synchronize(self.device)

    def generate(self, prompts, max_new_tokens, eos_id=None, timeout_s=None):
        """Convenience batch API: submit every prompt, drive steps until
        all finish, return each request's generated tokens (in input
        order). Raises if any request failed."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        reqs = [self.submit(p, n, eos_id=eos_id, timeout_s=timeout_s)
                for p, n in zip(prompts, max_new_tokens)]
        while any(not r.finished() for r in reqs):
            msg = self.aborted
            if msg is not None:
                raise RuntimeError(msg)
            self.step()
        bad = [r for r in reqs if r.state != FINISHED]
        if bad:
            raise RuntimeError("requests failed: %s"
                               % [(r.rid, r.state, r.error) for r in bad])
        return [list(r.generated) for r in reqs]

    def pop_finished(self):
        """Drain every request retired since the last call — FINISHED and
        FAILED both (check ``req.state``/``req.error``)."""
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
            return out

    def _drain_failed(self):
        """Requests the scheduler terminated (FAILED, TIMED_OUT,
        CANCELLED) surface through the same channels as successes."""
        failed = self.scheduler.pop_failed()
        for req in failed:
            self.obs.request_finished(req)
            if req.state == TIMED_OUT:
                self._n_timed_out += 1
            elif req.state == CANCELLED:
                self._n_cancelled += 1
            else:
                self._n_failed += 1
        self._finished.extend(failed)
        return failed

    # ------------------------------------------------------------ internals
    def _table_row(self, req, width):
        # the admission grant includes the first decode slot's headroom
        # block, so a boundary-length replay holds one block more than its
        # prefill bucket's table width — clip; prefill never reads it
        row = np.zeros(width, np.int32)
        n = min(len(req.blocks), width)
        row[:n] = req.blocks[:n]
        return row

    def _run_prefill(self, req):
        cfg = self.config
        replay = req.replay_tokens()
        L = len(replay)
        S = _bucket_for(L, cfg.prefill_buckets())
        toks = np.zeros((1, S), np.int32)
        toks[0, :L] = replay
        # prefix sharing: blocks mapped from the index already hold this
        # prefix's K/V — route their WRITE entries to the trash block so
        # the scatter cannot touch a shared block (copy-on-write contract)
        write_table = self._table_row(req, S // cfg.block_size)
        write_table[:min(req.shared_blocks, len(write_table))] = 0
        length = np.array([L], np.int32)
        graphs = [self._prefill_graphs[S]]
        if self._spec:
            graphs.append(self._draft_prefill_graphs[S])
        # capture-tally delta around the call: a bump means THIS call sat
        # behind a cold bucket — that wall is the request's compile_stall
        c0, s0 = self._capture_totals(graphs)
        # chaos: injected dispatch failure — escapes step(), which aborts
        fault.hit("dispatch_error")
        t0 = time.time()
        tok, _logits = graphs[0](toks, length, write_table)
        if self._spec:
            # the draft caches the same replay through the same write table
            # into its OWN pages; shared blocks were draft-cached by the
            # prefix's original prefill, as the target pages were
            graphs[1](toks, length, write_table)
        # the per-request token egress: serving's output IS this transfer
        tok = int(tok.cpu()[0])  # fwlint: disable=host-sync — token egress to the client is the product, one scalar per prefill
        wall = time.time() - t0
        c1, s1 = self._capture_totals(graphs)
        stall = min(s1 - s0, wall) if c1 > c0 else 0.0
        telemetry.histogram("serving.prefill_seconds").observe(wall)
        telemetry.counter("serving.prefill_tokens").inc(L)
        # register this prefix's full blocks for later admissions
        self.pool.prefix_insert(replay, req.blocks)
        was_replay = req.pending_token is not None
        req.context_len = L
        req.state = DECODING
        if not was_replay:
            # fresh prompt: the prefill's greedy token is the first output
            self._note_token(req, tok)
        self.obs.prefill_done(req, stall, was_replay)

    def _run_decode(self, reqs):
        cfg = self.config
        B = _bucket_for(len(reqs), cfg.decode_buckets())
        toks = np.zeros(B, np.int32)
        poss = np.zeros(B, np.int32)
        tables = np.zeros((B, self._nb_max), np.int32)
        ctx = np.ones(B, np.int32)
        for i, req in enumerate(reqs):
            toks[i] = req.pending_token
            poss[i] = req.context_len
            tables[i] = self._table_row(req, self._nb_max)
            ctx[i] = req.context_len + 1
        g = self._decode_graphs[B]
        c0, s0 = g.captures, g.capture_s
        fault.hit("dispatch_error")
        t0 = time.time()
        nxt, _logits = g(toks, poss, tables, ctx)
        # the fused step's single device->host read: the next-token vector
        nxt = nxt.cpu().numpy()  # fwlint: disable=host-sync — token egress to clients is the product, B int32s per step
        if g.captures > c0:
            # a cold batch bucket stalls EVERY stream in the batch
            self.obs.decode_stall(reqs, min(g.capture_s - s0,
                                            time.time() - t0))
        telemetry.histogram("serving.decode_batch").observe(len(reqs))
        for i, req in enumerate(reqs):
            req.context_len += 1
            self._note_token(req, int(nxt[i]))

    def _cow_guard(self, reqs):
        """Give every write slot this step will touch (the whole window
        with speculative decoding) a PRIVATE block (structurally
        unreachable with the current admission flow, but the pool's
        copy-on-write contract must hold unconditionally)."""
        bs = self.config.block_size
        k = self.spec_k
        for req in reqs:
            first = req.context_len // bs
            last = min(req.context_len + k, self.config.max_len - 1) // bs
            for idx in range(first, min(last, len(req.blocks) - 1) + 1):
                b = req.blocks[idx]
                if self.pool.refcount(b) > 1:
                    nb = self.pool.cow(b)
                    if nb != b and self._draft_kp is not None:
                        # the draft pages share the block table, so the
                        # draft copy rides the same decision
                        self._draft_kp[:, nb] = self._draft_kp[:, b]
                        self._draft_vp[:, nb] = self._draft_vp[:, b]
                    req.blocks[idx] = nb

    def _run_spec_decode(self, reqs):
        """Speculative decode: the draft proposes ``spec_k`` greedy tokens
        (one-token steps over its OWN pages, same block tables), then the
        target scores all ``spec_k+1`` window positions in ONE
        :func:`.model.extend` pass and greedy acceptance emits the TARGET's
        tokens — the stream equals target-only decoding whatever the draft
        proposed.

        The draft runs k+1 inner steps: steps 0..k-1 yield proposals, the
        last only fills its cache — with all k proposals accepted the next
        step starts at position ctx+k+1, and the draft's attention there
        needs its K/V at ctx+k, which no proposal step wrote."""
        cfg = self.config
        k = self.spec_k
        B = _bucket_for(len(reqs), cfg.decode_buckets())
        n = len(reqs)
        nb = self._nb_max
        base_ctx = np.array([r.context_len for r in reqs], np.int32)
        tables = np.zeros((B, nb), np.int32)
        for i, req in enumerate(reqs):
            tables[i] = self._table_row(req, nb)
        cur = np.zeros(B, np.int32)
        cur[:n] = [r.pending_token for r in reqs]
        proposals = np.zeros((n, k), np.int32)
        dg = self._draft_decode_graphs[B]
        c0, s0 = dg.captures, dg.capture_s
        fault.hit("dispatch_error")
        t0 = time.time()
        for j in range(k + 1):
            poss = np.zeros(B, np.int32)
            ctx = np.ones(B, np.int32)
            poss[:n] = base_ctx + j
            ctx[:n] = base_ctx + j + 1
            dnxt, _dl = dg(cur, poss, tables, ctx)
            if j < k:
                # the proposal steers the next inner step's input token:
                # one device->host read of B int32s per draft step
                dnxt = dnxt.cpu().numpy()  # fwlint: disable=host-sync — the draft's proposals feed the host-side verify batch
                proposals[:, j] = dnxt[:n]
                cur[:n] = dnxt[:n]
        draft_wall = time.time() - t0
        draft_stall = min(dg.capture_s - s0, draft_wall) \
            if dg.captures > c0 else 0.0
        # verify: lane j consumes [pending, d_1..d_k][j] at position ctx+j;
        # its greedy argmax is what the stream emits if lane j is reached
        T = k + 1
        toks2 = np.zeros((B, T), np.int32)
        poss2 = np.zeros((B, T), np.int32)
        ctx2 = np.ones((B, T), np.int32)
        toks2[:n, 0] = [r.pending_token for r in reqs]
        toks2[:n, 1:] = proposals
        poss2[:n] = base_ctx[:, None] + np.arange(T)[None, :]
        ctx2[:n] = poss2[:n] + 1
        vg = self._verify_graphs[B]
        c0, s0 = vg.captures, vg.capture_s
        t0 = time.time()
        nxt2, _logits = vg(toks2, poss2, tables, ctx2)
        # token egress to clients: B x (k+1) int32s per step
        nxt2 = nxt2.cpu().numpy()  # fwlint: disable=host-sync — token egress to clients is the product, B x T int32s per step
        verify_wall = time.time() - t0
        verify_stall = min(vg.capture_s - s0, verify_wall) \
            if vg.captures > c0 else 0.0
        if draft_stall or verify_stall:
            self.obs.decode_stall(reqs, draft_stall + verify_stall)
        # greedy acceptance: emit the TARGET's token at every reached lane.
        # Lane j+1 is reached only if the draft's proposal d_{j+1} matched
        # the target's lane-j output (the window's K/V past a mismatch
        # encodes the draft's wrong token; the next step's lane 0
        # overwrites those slots)
        proposed = accepted = 0
        for i, req in enumerate(reqs):
            proposed += k
            for j in range(T):
                tok = int(nxt2[i, j])
                if tok < 0:
                    break   # overflow-poisoned lane (past max_len)
                req.context_len += 1
                self._note_token(req, tok)
                if req.state != DECODING or j >= k \
                        or int(proposals[i, j]) != tok:
                    break
                accepted += 1
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_draft_s += draft_wall
        self._spec_verify_s += verify_wall
        telemetry.histogram("serving.decode_batch").observe(len(reqs))
        self.obs.spec_step(reqs, draft_wall - draft_stall,
                           verify_wall - verify_stall, proposed, accepted)

    def _note_token(self, req, tok):
        now = time.time()
        if req.first_token_t is None:
            req.first_token_t = now
            telemetry.histogram("serving.ttft_seconds").observe(
                now - req.arrival_t)
        req.generated.append(tok)
        req.pending_token = tok
        self._tokens_total += 1
        self._token_window.append(now)
        telemetry.counter("serving.generated_tokens").inc()
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.state = FINISHED
            req.pending_token = None

    def _retire(self, req):
        req.finish_t = time.time()
        telemetry.histogram("serving.request_latency_seconds").observe(
            req.finish_t - req.arrival_t)
        telemetry.counter("serving.requests_completed").inc()
        self.obs.request_finished(req)
        self._n_completed += 1
        self._finished.append(req)
        if req.done_event is not None:
            req.done_event.set()

    def _refresh_throughput(self, window_s=10.0):
        now = time.time()
        cut = now - window_s
        w = self._token_window = [t for t in self._token_window if t >= cut]
        span = now - max(cut, self._t_started)
        telemetry.gauge("serving.tokens_per_sec").set(
            len(w) / span if span > 0 else 0.0)

    # ------------------------------------------------------------ stats
    def stats(self):
        """One dashboard snapshot. Everything here is THIS engine's: counts
        are per-engine tallies and the latency/TTFT percentiles read the
        ``engine=<id>``-labeled registry histograms."""
        with self._lock:
            self._refresh_throughput()   # a stale window must read as 0
            eid = str(self.engine_id)
            lat = telemetry.histogram("serving.request_latency_seconds",
                                      engine=eid)
            ttft = telemetry.histogram("serving.ttft_seconds", engine=eid)
            return {
                "engine": self.engine_id,
                "device": str(self.device),
                "steps": self._steps,
                "waiting": len(self.scheduler.waiting),
                "active": len(self.scheduler.running),
                "kv_blocks_total": self.pool.num_usable,
                "kv_blocks_used": self.pool.used(),
                "kv_blocks_frag_slots": self.scheduler.frag_slots(),
                "kv_pool_bytes": self.pool.nbytes(),
                "tokens_total": self._tokens_total,
                "tokens_per_sec":
                    telemetry.gauge("serving.tokens_per_sec").value,
                "latency_p50_s": lat.percentile(50),
                "latency_p99_s": lat.percentile(99),
                "ttft_p50_s": ttft.percentile(50),
                "ttft_p99_s": ttft.percentile(99),
                "preemptions": self.scheduler.preempt_count,
                "completed": self._n_completed,
                "failed": self._n_failed,
                "resilience": {
                    "draining": self._draining,
                    "aborted": self._aborted,
                    "max_queue": self.config.max_queue,
                    "default_timeout_ms": self.config.default_timeout_ms,
                    "shed": self._n_shed,
                    "timed_out": self._n_timed_out,
                    "cancelled": self._n_cancelled,
                },
                "prefix": self.pool.prefix_stats(),
                "spec": {
                    "enabled": self._spec,
                    "k": self.spec_k,
                    "draft": self.config.draft if self._spec else None,
                    "proposed_tokens": self._spec_proposed,
                    "accepted_tokens": self._spec_accepted,
                    "acceptance_rate":
                        (self._spec_accepted / self._spec_proposed)
                        if self._spec_proposed else 0.0,
                    "draft_seconds": round(self._spec_draft_s, 6),
                    "verify_seconds": round(self._spec_verify_s, 6),
                },
                "slo": self.obs.slo_snapshot(),
                "phases": self.obs.phase_snapshot(),
                "compiles": self._compiles(),
                "compile_cache": compile_cache.stats(),
            }

    def _compiles(self):
        """Per program: its bucket graphs' captures, capture seconds and
        replays (the JAX package's ``compiles`` block)."""
        out = {}
        for g in self.bucket_graphs():
            c = out.setdefault(g.program, {"count": 0, "seconds": 0.0,
                                           "runs": 0})
            c["count"] += g.captures
            c["seconds"] += g.capture_s
            c["runs"] += g.replays
        for c in out.values():
            c["seconds"] = round(c["seconds"], 3)
        return out
