"""Continuous-batching scheduler: admission queue, per-request state
machine, FCFS prefill/decode mixing, block-exhaustion preemption.

State machine (one :class:`Request` each)::

    WAITING --admit/alloc--> PREFILL --first token--> DECODING
       ^                                                 |
       |<------------- preempt (blocks exhausted) -------|
                                                         v
                FINISHED (len/eos) / FAILED / TIMED_OUT / CANCELLED

Terminal states:

* **FINISHED** — length cap or EOS; the only state SLO accounting judges.
* **FAILED** — engine/scheduler error (pool too small, dispatch abort).
* **TIMED_OUT** — the request's deadline (``timeout_s``) expired; swept
  at admission and per step so its blocks return to the pool promptly.
* **CANCELLED** — the consumer walked away (serve.py detects the dropped
  connection; direct drivers call ``engine.cancel``); blocks freed on
  the next sweep rather than decoding to ``max_new_tokens`` for nobody.

Each engine step the scheduler produces one :class:`StepPlan`:

* **ensure** — every DECODING request gets a pool block for its next slot;
  when the pool is dry the LATEST-admitted decoding request is preempted
  (its blocks freed, its tokens-so-far requeued at the HEAD of the waiting
  queue for deterministic re-prefill) until the older ones fit. FCFS both
  ways: oldest requests never starve behind younger ones.
* **admit** — waiting requests are admitted head-first while the batch cap,
  the per-step prefill budget, and the free list allow; the queue head
  blocks admission when its prompt doesn't fit (no skip-ahead — a short
  prompt can never overtake a long one, which is the fairness contract
  tests pin down).

Preemption is recompute-style (vLLM's recompute mode): a victim's
generated-so-far tokens become its new prompt; greedy decoding makes the
replay bit-deterministic, so preemption is invisible in the output stream.
"""
import itertools
import time
from collections import deque

from .. import telemetry
from .kv_cache import KVCacheOOM

WAITING = "waiting"
PREFILL = "prefill"
DECODING = "decoding"
FINISHED = "finished"
FAILED = "failed"
TIMED_OUT = "timed_out"
CANCELLED = "cancelled"

# every state a finished() request can be in; _terminate() routes each to
# its own counter so shed/expiry accounting never inflates requests_failed
TERMINAL_STATES = (FINISHED, FAILED, TIMED_OUT, CANCELLED)
_TERMINAL_COUNTERS = {
    FAILED: "serving.requests_failed",
    TIMED_OUT: "serving.timeouts",
    CANCELLED: "serving.cancelled",
}

_rid_counter = itertools.count()


class Request:
    """One generation request and its serving-side state."""

    __slots__ = ("rid", "request_id", "prompt", "max_new_tokens", "eos_id",
                 "state", "blocks", "shared_blocks", "context_len",
                 "generated", "pending_token", "arrival_t", "admitted_t",
                 "first_token_t", "preempted_t", "finish_t", "preemptions",
                 "error", "done_event", "trace", "deadline_t", "cancelled")

    def __init__(self, prompt, max_new_tokens, eos_id=None, rid=None,
                 request_id=None, timeout_s=None):
        self.rid = rid if rid is not None else next(_rid_counter)
        # wire identity: caller-supplied (X-Request-Id header) or derived
        # from the process-local rid — threads through every lifecycle
        # event, the /stats surface, and the per-request trace lanes
        self.request_id = (str(request_id) if request_id is not None
                           else "r%d" % self.rid)
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt (the decoder needs a seed token)")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_id = None if eos_id is None else int(eos_id)
        self.state = WAITING
        self.blocks = []          # pool block ids, position order
        self.shared_blocks = 0    # leading blocks mapped from the prefix
                                  # index (refcounted, copy-on-write; the
                                  # prefill write table routes them to
                                  # trash — their K/V is already cached)
        self.context_len = 0      # tokens currently cached in the pool
        self.generated = []       # tokens produced so far (output stream)
        self.pending_token = None  # last generated token, not yet cached
        self.arrival_t = time.time()
        self.admitted_t = None
        self.first_token_t = None
        self.preempted_t = None   # last preemption (obs replay clock)
        self.finish_t = None
        self.preemptions = 0
        self.error = None
        self.done_event = None    # engine attaches for blocking consumers
        self.trace = None         # obs.RequestTrace (engine submits only)
        if timeout_s is not None:
            timeout_s = float(timeout_s)
            if timeout_s <= 0:
                raise ValueError("timeout_s must be > 0")
            self.deadline_t = self.arrival_t + timeout_s
        else:
            self.deadline_t = None
        self.cancelled = False    # consumer walked away; swept next step

    def expired(self, now=None):
        if self.deadline_t is None:
            return False
        return (now if now is not None else time.time()) >= self.deadline_t

    # tokens that must be in the KV cache for the next decode step
    def replay_tokens(self):
        """Prompt + generated-but-cached tokens: re-prefilling exactly these
        reconstructs the preempted request's cache state."""
        gen_cached = self.generated[:-1] if self.pending_token is not None \
            else self.generated
        return self.prompt + gen_cached

    @property
    def num_new_tokens(self):
        return len(self.generated)

    def finished(self):
        return self.state in TERMINAL_STATES

    def __repr__(self):
        return ("Request(rid=%s, state=%s, prompt=%d, generated=%d, ctx=%d, "
                "blocks=%d)" % (self.rid, self.state, len(self.prompt),
                                len(self.generated), self.context_len,
                                len(self.blocks)))


class StepPlan:
    """One engine step's work: requests to prefill (newly admitted or
    preempt-replayed) and requests to run the fused decode over."""

    __slots__ = ("prefills", "decodes", "preempted")

    def __init__(self, prefills, decodes, preempted):
        self.prefills = prefills
        self.decodes = decodes
        self.preempted = preempted

    def empty(self):
        return not (self.prefills or self.decodes)


class Scheduler:
    """FCFS continuous-batching scheduler over one :class:`KVBlockPool`."""

    def __init__(self, pool, max_batch=32, prefills_per_step=4,
                 lookahead=1, max_positions=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.prefills_per_step = int(prefills_per_step)
        # write slots a decoding stream consumes per engine step: 1 for
        # plain decode, spec_k + 1 for speculative decoding (the draft +
        # verify window writes positions context_len .. context_len+k)
        self.lookahead = int(lookahead)
        # position cap (cfg.max_len): write slots at/past it route to the
        # trash block in-graph, so headroom past it is never allocated
        self.max_positions = (None if max_positions is None
                              else int(max_positions))
        self.waiting = deque()
        self.running = []          # admission order (oldest first)
        self.failed = []           # _fail victims awaiting engine drain
        self.preempt_count = 0     # this scheduler only (the registry
                                   # counter is process-global)

    # ---- intake ---------------------------------------------------------
    def add(self, req):
        """Enqueue a WAITING request (engine validates capacity first)."""
        self.waiting.append(req)
        self._refresh_gauges()

    def has_work(self):
        return bool(self.waiting or self.running)

    # ---- the per-step plan ---------------------------------------------
    def schedule(self):
        """Build this step's :class:`StepPlan`; mutates request states and
        the pool free list (alloc for admissions and next-slot headroom,
        free for preemption victims)."""
        preempted = self.ensure_decode_headroom()
        prefills = self._admit(preempted)
        self._refresh_gauges()
        return StepPlan(prefills, self.decodable(), preempted)

    def decodable(self):
        """Streams the fused decode step advances this iteration. The
        engine re-reads this AFTER running prefills (fresh admissions
        become decodable mid-step) — one definition, two call points."""
        return [r for r in self.running if r.state == DECODING
                and r.pending_token is not None]

    def ensure_decode_headroom(self):
        """Every DECODING request needs its next write slot backed by a
        block. Pool dry -> preempt youngest-admitted victims (never a
        request older than the one we are ensuring).

        Called twice per engine step: inside :meth:`schedule` for streams
        already decoding, and again by the engine after prefills — a
        prompt that exactly fills its blocks writes its FIRST decode
        token at a fresh block boundary, and without the second pass that
        write would land in the trash block and the position's K/V would
        be silently lost (outputs then drift from sequential decoding)."""
        preempted = []
        for req in list(self.running):
            # a victim preempted earlier this pass is WAITING now, so the
            # state check also skips members the loop snapshot still holds
            if req.state != DECODING or req.pending_token is None:
                continue
            last_pos = req.context_len + self.lookahead - 1
            if self.max_positions is not None:
                # slots at/past the cap route to trash in-graph; backing
                # them with real blocks would waste pool for nothing
                last_pos = min(last_pos, self.max_positions - 1)
            need_idx = last_pos // self.pool.block_size
            while need_idx >= len(req.blocks):
                try:
                    req.blocks.extend(self.pool.alloc(1))
                except KVCacheOOM:
                    # evict the YOUNGEST decoding stream — possibly req
                    # itself (a younger request never steals blocks from
                    # an older one: FCFS both ways)
                    victim = self._pick_victim(ensuring=req)
                    if victim is None or (victim is req
                                          and len(self.running) == 1):
                        # alone and still dry: the pool cannot hold this
                        # request at all — fail it, never wedge the engine
                        self._fail(req, "KV pool too small for request: "
                                        "%d blocks held, next slot needs "
                                        "one more and nothing is evictable"
                                   % len(req.blocks))
                        break
                    self._preempt(victim)
                    preempted.append(victim)
                    if victim is req:
                        break
        return preempted

    def _pick_victim(self, ensuring=None):
        """Youngest decoding stream whose eviction actually reclaims
        blocks. With refcounted prefix sharing the real reclaim gain is
        the count of blocks whose refcount would drop to ZERO — a stream
        holding only shared prefix blocks frees nothing, and preempting
        it would burn a replay for zero reclaimed headroom.

        Scanning stops at the stream being ensured: FCFS both ways means
        a younger request never steals blocks from an older one, so when
        every candidate at or after ``ensuring`` frees nothing the answer
        is None (the ensured stream fails, it does not reach upstream)."""
        for req in reversed(self.running):   # youngest admission first
            if (req.state == DECODING
                    and self.pool.reclaimable(req.blocks) > 0):
                return req
            if req is ensuring:
                break
        return None

    def _preempt(self, req):
        """Recompute-style preemption: free the blocks, requeue at the
        HEAD of the waiting queue with tokens-so-far as the new replay
        prompt (greedy decode makes the replay deterministic). Freeing
        decrements refcounts: shared prefix blocks survive for their
        other holders, only sole-owner blocks return to the pool."""
        self.running.remove(req)
        if req.blocks:
            self.pool.free(req.blocks)
            req.blocks = []
        req.shared_blocks = 0
        req.context_len = 0
        req.state = WAITING
        req.preemptions += 1
        req.preempted_t = time.time()
        self.preempt_count += 1
        telemetry.counter("serving.preemptions").inc()
        self.waiting.appendleft(req)

    def _fail(self, req, msg):
        self._terminate(req, FAILED, msg)

    def _terminate(self, req, state, msg):
        """Move ``req`` to a non-FINISHED terminal state: free its blocks
        promptly (refcount-decrement — shared prefix blocks survive for
        their other holders), route it into the ``failed`` drain channel
        so the engine's public completion paths surface it, and wake any
        blocked consumer. One exit door for FAILED/TIMED_OUT/CANCELLED —
        each bumps its own counter."""
        if req in self.running:   # admission-time failures never joined
            self.running.remove(req)
        if req.blocks:
            self.pool.free(req.blocks)
            req.blocks = []
        req.shared_blocks = 0
        req.state = state
        req.error = msg
        req.finish_t = time.time()
        telemetry.counter(_TERMINAL_COUNTERS[state]).inc()
        self.failed.append(req)
        if req.done_event is not None:
            req.done_event.set()

    def sweep(self, now=None):
        """Terminate expired / cancelled requests wherever they sit —
        WAITING (queue positions open up) or PREFILL/DECODING (their KV
        blocks return to the pool at once instead of decoding to
        ``max_new_tokens`` for a consumer that is gone). Called by the
        engine at the top of every step and safe to call directly.
        Returns the requests it terminated."""
        now = time.time() if now is None else now
        swept = []
        for req in list(self.running) + list(self.waiting):
            if req.finished():
                continue
            if req.cancelled:
                state, msg = CANCELLED, "cancelled by consumer"
            elif req.expired(now):
                state, msg = TIMED_OUT, (
                    "deadline expired after %.3fs (timeout_s=%.3f)"
                    % (now - req.arrival_t, req.deadline_t - req.arrival_t))
            else:
                continue
            if req in self.waiting:
                self.waiting.remove(req)
            self._terminate(req, state, msg)
            swept.append(req)
        if swept:
            self._refresh_gauges()
        return swept

    def _admit(self, preempted=()):
        """FCFS head-first admission into PREFILL, bounded by the batch
        cap, the per-step prefill budget, and the free list. The
        admission grant covers the replay tokens PLUS the first decode
        token's write slot — without that headroom a boundary-length
        prompt prefills, loses the decode-slot race to the next
        admission, and thrashes prefill->preempt every step on a tight
        pool. The head blocks the queue when it doesn't fit: no
        skip-ahead. A head the pool could never hold even when empty is
        failed outright (wedging the queue behind it forever serves no
        one). A request preempted THIS pass sits the step out —
        re-admitting it at once would re-grab the blocks the eviction
        just reclaimed."""
        prefills = []
        while (self.waiting and len(self.running) < self.max_batch
               and len(prefills) < self.prefills_per_step):
            req = self.waiting[0]
            if req in preempted:
                break
            replay = req.replay_tokens()
            need = self.pool.blocks_for(len(replay) + 1)
            if need > self.pool.num_usable:
                self.waiting.popleft()
                self._fail(req, "KV pool too small for request: needs %d "
                                "blocks (replay + first decode slot), pool "
                                "holds %d usable"
                           % (need, self.pool.num_usable))
                continue
            # prefix sharing: map the longest indexed block-aligned prefix
            # into the table (refcounted), allocate only the tail. The
            # match can never cover the first write slot — it spans full
            # blocks of the replay only, so decode writes always land in
            # this request's private tail blocks (COW stays a safety net,
            # not a hot path).
            shared = self.pool.prefix_match(replay)
            fresh = need - len(shared)
            if fresh > self.pool.available():
                if shared:   # drop our references; other holders keep them
                    self.pool.free(shared)
                break
            self.waiting.popleft()
            try:
                fresh_blocks = self.pool.alloc(fresh)
            except KVCacheOOM as e:
                # refused despite the available() check above (a
                # fault-injected kv_oom, or a racing allocator): no
                # dispatch happened and the pool is intact, so this is
                # the request's failure, not the engine's — fail it
                # through the classified exit door and keep admitting
                if shared:   # drop our references; other holders keep them
                    self.pool.free(shared)
                self._fail(req, "admission refused: %s" % e)
                continue
            req.blocks = shared + fresh_blocks
            req.shared_blocks = len(shared)
            req.state = PREFILL
            req.admitted_t = time.time()
            self.running.append(req)
            telemetry.counter("serving.requests_admitted").inc()
            prefills.append(req)
        return prefills

    def pop_failed(self):
        """Drain requests FAILED by the scheduler itself (pool too small,
        nothing evictable). The engine routes these through the same
        public completion channels as successes — ``step()``'s return and
        ``pop_finished()`` — so a polling caller can't miss a failure."""
        out, self.failed = self.failed, []
        return out

    # ---- completion (engine calls after a step's device work) ----------
    def finish(self, req):
        """Retire a FINISHED/FAILED request and release its blocks."""
        if req in self.running:
            self.running.remove(req)
        if req.blocks:
            self.pool.free(req.blocks)
            req.blocks = []
        req.shared_blocks = 0
        self._refresh_gauges()

    def frag_slots(self):
        """Internal fragmentation: allocated-but-unused tail-block slots.
        Per-scheduler (the gauge below is process-global; engine stats()
        and the step timeline read this directly)."""
        return sum(len(r.blocks) * self.pool.block_size - r.context_len
                   for r in self.running)

    def _refresh_gauges(self):
        telemetry.gauge("serving.queue_depth").set(len(self.waiting))
        telemetry.gauge("serving.active_requests").set(len(self.running))
        telemetry.gauge("serving.kv_blocks_frag_slots").set(
            self.frag_slots())
