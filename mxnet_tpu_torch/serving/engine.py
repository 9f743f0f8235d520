"""ServingEngine — the standing inference engine's Python API (the port of
``mxnet_tpu/serving/engine.py``).

One engine owns: the weights (a trained checkpoint's ``arg_params`` or
deterministic ``random_params``) as torch tensors on its device, one
:class:`~.kv_cache.KVBlockPool`, and one :class:`~.scheduler.Scheduler`.
PyTorch runs eagerly, so where the JAX package compiles one program per
padded shape bucket the port calls :func:`.model.prefill` /
:func:`.model.decode` directly at the same buckets: the hand-written
kernels of :mod:`..ops.attention` take any bucket, and the padded shapes
keep the batch composition (and so every row's result) independent of
the other rows.

Each :meth:`step` runs the scheduler's plan: admitted prompts prefill into
the shared block pool (one call per request at its length bucket), then
every decoding stream advances one token through the fused paged decode
step at the batch bucket. The step inputs go up as one int32 buffer per
call; the ONLY device->host reads are the next-token vectors (``.cpu()``)
— that read IS the product (tokens leave for clients). The pool pages are
written in place call to call.

Thread model: ``submit()`` is safe from any thread; ``step()`` /
``run_loop()`` must run on one stepping thread. Per-request latency metrics
(TTFT, end-to-end, tokens/sec) flow through the telemetry registry.

Not ported yet: speculative decoding (``spec_k > 0``; ROADMAP queue A,
"speculative decoding") and the compile plane (``compileobs`` /
``compile_cache``): nothing compiles here, so ``compile_stall`` is 0.
"""
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import context, fault, telemetry
from ..analysis import witness
from ..base import env_bool, env_int, env_str, torch_dtype
from . import model as _model
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
        # speculative decoding: parsed as in the JAX package so a config
        # written for it reads the same; the engine refuses spec_k > 0
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
        if cfg.spec_k > 0:
            raise NotImplementedError(
                "speculative decoding (spec_k=%d) is not ported yet: it "
                "needs the multi-query paged kernel _paged_pallas_multi "
                "(ROADMAP.md queue A, 'Speculative decoding'); use "
                "spec_k=0" % cfg.spec_k)
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
        self.scheduler = Scheduler(self.pool, max_batch=cfg.max_batch,
                                   prefills_per_step=cfg.prefills_per_step,
                                   lookahead=1, max_positions=cfg.max_len)
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
        """Run every prefill length bucket and decode batch bucket once
        (all-trash block tables, no requests involved): builds the CUDA
        kernels on first use and touches every shape the traffic will
        take, so the first real request pays no build or setup wall."""
        cfg = self.config
        with self._lock:
            for S in cfg.prefill_buckets():
                toks, table = self._upload(np.zeros((1, S), np.int32),
                                           np.zeros(S // cfg.block_size,
                                                    np.int32))
                _model.prefill(self.params, toks, 1, table,
                               self.pool.k_pages, self.pool.v_pages, cfg)
            for B in cfg.decode_buckets():
                args = self._upload(np.zeros(B, np.int32),
                                    np.zeros(B, np.int32),
                                    np.zeros((B, self._nb_max), np.int32),
                                    np.ones(B, np.int32))
                _model.decode(self.params, *args, self.pool.k_pages,
                              self.pool.v_pages, cfg)
            if self.device.type == "cuda":
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
    def _upload(self, *arrays):
        """Host int32 arrays -> device tensors of the same shapes, through
        ONE host->device copy of their concatenation (contiguous views).
        On the card the copy is staged in pinned memory and queued on the
        stream without waiting for it."""
        host = torch.from_numpy(np.concatenate([a.reshape(-1)
                                                for a in arrays]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf = host.to(self.device, non_blocking=True)
        out, off = [], 0
        for a in arrays:
            out.append(buf[off:off + a.size].view(a.shape))
            off += a.size
        return out

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
        # chaos: injected dispatch failure — escapes step(), which aborts
        fault.hit("dispatch_error")
        t0 = time.time()
        toks_d, table_d = self._upload(toks, write_table)
        tok, _logits, _kp, _vp = _model.prefill(
            self.params, toks_d, L, table_d, self.pool.k_pages,
            self.pool.v_pages, cfg)
        # the per-request token egress: serving's output IS this transfer
        tok = int(tok.cpu()[0])
        wall = time.time() - t0
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
        self.obs.prefill_done(req, 0.0, was_replay)

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
        fault.hit("dispatch_error")
        nxt, _logits, _kp, _vp = _model.decode(
            self.params, *self._upload(toks, poss, tables, ctx),
            self.pool.k_pages, self.pool.v_pages, cfg)
        # the fused step's single device->host read: the next-token vector
        nxt = nxt.cpu().numpy()
        telemetry.histogram("serving.decode_batch").observe(len(reqs))
        for i, req in enumerate(reqs):
            req.context_len += 1
            self._note_token(req, int(nxt[i]))

    def _cow_guard(self, reqs):
        """Give every write slot this step will touch a PRIVATE block
        (structurally unreachable with the current admission flow, but the
        pool's copy-on-write contract must hold unconditionally)."""
        bs = self.config.block_size
        for req in reqs:
            first = req.context_len // bs
            last = min(req.context_len, self.config.max_len - 1) // bs
            for idx in range(first, min(last, len(req.blocks) - 1) + 1):
                b = req.blocks[idx]
                if self.pool.refcount(b) > 1:
                    req.blocks[idx] = self.pool.cow(b)

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
                "slo": self.obs.slo_snapshot(),
                "phases": self.obs.phase_snapshot(),
            }
