"""Per-request serving observability: lifecycle tracing, phase
attribution, SLO accounting, and the step-level occupancy timeline.

The engine's aggregate histograms (``serving.ttft_seconds``,
``serving.request_latency_seconds``) say *how slow* — this module says
*why*. Every submitted request carries a ``request_id`` (caller-supplied
via the ``X-Request-Id`` HTTP header, auto-assigned otherwise) and a
:class:`RequestTrace` that attributes its whole wall clock to exactly one
phase at a time::

    submitted --> queue_wait --admit--> prefill --first token--> decode
                                                                  |
                       replay <------------ preempted ------------|
                         |--readmit--> (replay continues) --replayed--> decode
                                                                  |
                                                       finished / failed

Phases (``serving.phase_seconds{engine,phase}``):

* ``queue_wait``    submit -> admission (head-of-line blocking, pool dry)
* ``prefill``       admission -> first token (fresh prompts)
* ``decode``        steady-state token generation
* ``replay``        preemption -> replay-prefill done: the wall a
                    recompute-style preemption cost the request (its
                    KV cache is rebuilt from tokens-so-far)
* ``compile_stall`` time blocked behind a cold bucket compile, *debited*
                    from the enclosing phase. PyTorch runs eagerly, so
                    the port's engine reports 0 here; the phase stays so
                    the breakdown keeps the JAX package's shape

The debit keeps the invariant the report tools rely on: the five phases
sum EXACTLY to ``finish_t - arrival_t`` for every request (modulo float
rounding) — attribution closes, nothing is double-counted.

SLO accounting is always-on (rare-path counters): per-request TTFT and
TPOT are judged against ``MXNET_SERVING_SLO_TTFT_MS`` /
``MXNET_SERVING_SLO_TPOT_MS`` into ``serving.slo_good`` /
``serving.slo_total{engine,phase}``; ``serving.goodput{engine}`` gauges
the attainment over the last :data:`SLO_WINDOW` finished requests and a
``serving.slo_burn`` event fires on the transition below
:data:`BURN_THRESHOLD`.

Structured events (the telemetry event buffer):

* ``serving.request``        one per lifecycle transition (``state`` in
  submitted/admitted/decoding/preempted/readmitted/replayed/finished/
  failed); the terminal event carries the full phase breakdown
* ``serving.step_timeline``  one per non-empty engine step: batch
  occupancy, admitted/preempted/finished counts, queue depth, KV-pool
  used/free/frag — the occupancy time series
* ``serving.slo_burn``       attainment crossed below the burn threshold

Thread model: every hook runs under the engine lock (the stepping thread
owns all transitions); no locking of its own. With telemetry disabled the
per-step cost is O(changed requests): hooks fire only on lifecycle
transitions, ``telemetry.event`` is a no-op, and nothing here touches
device values (no host syncs).
"""
import time
from collections import deque

from .. import telemetry
from ..base import env_float

__all__ = ["PHASES", "SLO_WINDOW", "BURN_THRESHOLD", "RequestTrace",
           "ServingObs"]

#: Exhaustive phase set; every request's wall clock is partitioned over it.
PHASES = ("queue_wait", "prefill", "decode", "replay", "compile_stall")

#: Finished requests in the goodput sliding window.
SLO_WINDOW = 32

#: ``serving.slo_burn`` fires when windowed attainment crosses below this.
BURN_THRESHOLD = 0.9

#: Minimum finished requests before burn-rate judgment (a 1-request window
#: would fire on the first miss of the day).
_BURN_MIN_SAMPLES = 8


# thread-confined: a trace is mutated only by the thread stepping its
# request (stepping thread under the engine lock); handler threads read it
# only after finish() publishes the request under that same lock
class RequestTrace:
    """One request's phase clock: exactly one open phase at any moment.

    ``to_phase`` closes the open phase at ``now`` and opens the next;
    ``add_stall`` moves compile wall out of the open phase into
    ``compile_stall`` (debited at close so the five phases still sum to
    the request's end-to-end wall). All calls happen under the engine
    lock, in timestamp order.
    """

    __slots__ = ("phases", "cur", "t0", "stall_debit", "closed", "sub")

    def __init__(self, t0):
        self.phases = dict.fromkeys(PHASES, 0.0)
        self.cur = "queue_wait"
        self.t0 = float(t0)
        self.stall_debit = 0.0
        self.closed = False
        # SUB-attribution inside the decode phase (speculative decoding's
        # draft/verify split) — informational breakdown, NOT a phase:
        # the five phases alone still sum exactly to end-to-end wall
        self.sub = {"spec_draft": 0.0, "spec_verify": 0.0}

    def _settle(self, now):
        # stall_debit <= elapsed by construction (each stall is clipped to
        # its dispatch wall, dispatches are disjoint within the phase);
        # max() guards float noise only
        self.phases[self.cur] += max(0.0, (now - self.t0) - self.stall_debit)
        self.stall_debit = 0.0

    def to_phase(self, phase, now):
        """Close the open phase at ``now`` and open ``phase``."""
        if self.closed:
            return
        self._settle(now)
        self.cur = phase
        self.t0 = now

    def add_stall(self, seconds):
        """Attribute ``seconds`` of the open phase to ``compile_stall``."""
        if self.closed or seconds <= 0.0:
            return
        self.phases["compile_stall"] += seconds
        self.stall_debit += seconds

    def close(self, now):
        """Terminal transition: settle the open phase and freeze."""
        if self.closed:
            return
        self._settle(now)
        self.closed = True

    def total(self):
        """Sum over phases — equals end-to-end wall once closed."""
        return sum(self.phases.values())


class ServingObs:
    """One engine's observability plane (engine-lock-guarded, not
    thread-safe on its own). The engine calls one hook per request
    lifecycle transition plus one per step for the timeline."""

    __slots__ = ("engine_id", "slo_ttft_s", "slo_tpot_s", "_window",
                 "_burning", "_good", "_total")

    def __init__(self, engine_id, slo_ttft_ms=None, slo_tpot_ms=None):
        self.engine_id = str(engine_id)
        if slo_ttft_ms is None:
            slo_ttft_ms = env_float("MXNET_SERVING_SLO_TTFT_MS", 1000.0)
        if slo_tpot_ms is None:
            slo_tpot_ms = env_float("MXNET_SERVING_SLO_TPOT_MS", 100.0)
        self.slo_ttft_s = float(slo_ttft_ms) / 1000.0
        self.slo_tpot_s = float(slo_tpot_ms) / 1000.0
        self._window = deque(maxlen=SLO_WINDOW)   # True per SLO-good finish
        self._burning = False
        # per-engine tallies mirrored into the labeled registry counters:
        # stats() reads these so a second engine in the process never
        # inherits the first one's numbers
        self._good = {"ttft": 0, "tpot": 0}
        self._total = {"ttft": 0, "tpot": 0}

    # ---- lifecycle hooks (engine lock held) ----------------------------
    def request_submitted(self, req):
        """Attach the trace; the queue_wait clock starts at arrival."""
        req.trace = RequestTrace(req.arrival_t)
        telemetry.event("serving.request", request_id=req.request_id,
                        engine=self.engine_id, state="submitted",
                        prompt_tokens=len(req.prompt),
                        max_new_tokens=req.max_new_tokens)

    def request_admitted(self, req):
        """Admission: fresh prompts enter ``prefill``; a preemption
        victim re-admitted for replay stays on its ``replay`` clock (the
        re-prefill is part of what the preemption cost it)."""
        tr = req.trace
        if tr is None:
            return
        if tr.cur == "replay":
            telemetry.event("serving.request", request_id=req.request_id,
                            engine=self.engine_id, state="readmitted",
                            preemptions=req.preemptions)
            return
        tr.to_phase("prefill", req.admitted_t)
        telemetry.event("serving.request", request_id=req.request_id,
                        engine=self.engine_id, state="admitted",
                        queue_wait_s=round(tr.phases["queue_wait"], 6))

    def prefill_done(self, req, stall_s, replay):
        """Prefill dispatch returned: the request is decoding. Fresh
        prompts got their first token here (TTFT closes); replays just
        finished rebuilding their cache (replay overhead closes)."""
        tr = req.trace
        if tr is None:
            return
        tr.add_stall(stall_s)
        now = time.time()
        tr.to_phase("decode", now)
        if replay:
            telemetry.event("serving.request", request_id=req.request_id,
                            engine=self.engine_id, state="replayed",
                            replay_s=round(tr.phases["replay"], 6))
            return
        ttft = (req.first_token_t or now) - req.arrival_t
        telemetry.histogram("serving.ttft_seconds",
                            engine=self.engine_id).observe(ttft)
        telemetry.event("serving.request", request_id=req.request_id,
                        engine=self.engine_id, state="decoding",
                        ttft_s=round(ttft, 6))

    def decode_stall(self, reqs, stall_s):
        """A decode dispatch compiled (cold batch bucket): every stream
        in the batch was blocked behind it for the full stall."""
        if stall_s <= 0.0:
            return
        for req in reqs:
            if req.trace is not None:
                req.trace.add_stall(stall_s)

    def spec_step(self, reqs, draft_s, verify_s, proposed, accepted):
        """One speculative decode step landed: histogram the draft/verify
        walls (stall already subtracted by the caller), count the
        proposal/acceptance tokens, and sub-attribute each stream's share
        of the step inside its decode phase (``trace.sub`` — the
        waterfall's draft/verify split; never double-counted against the
        phase sum, which only partitions over :data:`PHASES`)."""
        telemetry.histogram("serving.spec_draft_seconds").observe(draft_s)
        telemetry.histogram("serving.spec_verify_seconds").observe(verify_s)
        telemetry.counter("serving.spec_proposed_tokens").inc(proposed)
        telemetry.counter("serving.spec_accepted_tokens").inc(accepted)
        for req in reqs:
            if req.trace is not None:
                req.trace.sub["spec_draft"] += draft_s
                req.trace.sub["spec_verify"] += verify_s

    def request_preempted(self, req):
        """Blocks evicted, tokens-so-far requeued: everything until the
        replay prefill lands is overhead the preemption caused."""
        tr = req.trace
        if tr is None:
            return
        tr.to_phase("replay", req.preempted_t or time.time())
        telemetry.event("serving.request", request_id=req.request_id,
                        engine=self.engine_id, state="preempted",
                        preemptions=req.preemptions)

    def request_finished(self, req, failed=False):
        """Terminal: close the trace, observe the labeled latency/phase
        histograms, judge the SLOs (always-on counters), refresh goodput
        and the burn state, emit the terminal event with the breakdown.

        The terminal state comes from ``req.state`` (finished / failed /
        timed_out / cancelled); the legacy ``failed`` flag forces the
        failed lane for callers predating the resilience states. Only
        FINISHED requests are judged against the SLOs — a shed, expired,
        or cancelled request is not a latency sample."""
        tr = req.trace
        if tr is None or tr.closed:
            return
        now = req.finish_t if req.finish_t is not None else time.time()
        tr.close(now)
        e2e = now - req.arrival_t
        phases = {ph: round(v, 6) for ph, v in tr.phases.items()}
        for ph in PHASES:
            telemetry.histogram("serving.phase_seconds", engine=self.engine_id,
                                phase=ph).observe(tr.phases[ph])
        state = "failed" if failed else req.state
        ok = state == "finished"
        slo = {}
        if ok:
            telemetry.histogram(
                "serving.request_latency_seconds",
                engine=self.engine_id).observe(e2e)
            slo = self._judge_slo(req)
        fields = dict(request_id=req.request_id, engine=self.engine_id,
                      state=state, e2e_s=round(e2e, 6), phases=phases,
                      tokens=len(req.generated),
                      preemptions=req.preemptions, **slo)
        if tr.sub["spec_draft"] or tr.sub["spec_verify"]:
            # decode-phase sub-split for serving_report.py's waterfall;
            # NOT part of the phase-sum contract
            fields["spec_draft_s"] = round(tr.sub["spec_draft"], 6)
            fields["spec_verify_s"] = round(tr.sub["spec_verify"], 6)
        if not ok:
            fields["error"] = req.error
        telemetry.event("serving.request", **fields)

    # ---- SLO ----------------------------------------------------------
    def _judge_slo(self, req):
        """Always-on good/total counters + windowed goodput + burn edge.
        TPOT is judged only for requests that decoded (>= 2 tokens)."""
        out = {}
        ok_all = True
        ttft = (req.first_token_t or req.finish_t) - req.arrival_t
        ok = ttft <= self.slo_ttft_s
        self._bump("ttft", ok)
        out["slo_ttft_ok"] = ok
        ok_all &= ok
        n = len(req.generated)
        if n >= 2 and req.first_token_t is not None:
            tpot = (req.finish_t - req.first_token_t) / (n - 1)
            ok = tpot <= self.slo_tpot_s
            self._bump("tpot", ok)
            out["slo_tpot_ok"] = ok
            out["tpot_s"] = round(tpot, 6)
            ok_all &= ok
            telemetry.histogram("serving.tpot_seconds",
                                engine=self.engine_id).observe(tpot)
        self._window.append(bool(ok_all))
        att = sum(self._window) / len(self._window)
        telemetry.gauge("serving.goodput", engine=self.engine_id).set(att)
        if len(self._window) >= _BURN_MIN_SAMPLES:
            if att < BURN_THRESHOLD and not self._burning:
                self._burning = True
                telemetry.event("serving.slo_burn", engine=self.engine_id,
                                attainment=round(att, 4),
                                threshold=BURN_THRESHOLD,
                                window=len(self._window))
            elif att >= BURN_THRESHOLD:
                self._burning = False
        return out

    def _bump(self, phase, good):
        self._total[phase] += 1
        telemetry.counter("serving.slo_total", engine=self.engine_id,
                          phase=phase).inc()
        if good:
            self._good[phase] += 1
            telemetry.counter("serving.slo_good", engine=self.engine_id,
                              phase=phase).inc()

    # ---- step timeline ------------------------------------------------
    def step_timeline(self, step, occupancy, admitted, preempted, finished,
                      queue, running, kv_used, kv_free, kv_frag_slots):
        """One occupancy sample per non-empty engine step (disabled
        telemetry short-circuits before any field is assembled)."""
        if not telemetry.enabled():
            return
        telemetry.event("serving.step_timeline", engine=self.engine_id,
                        step=step, occupancy=occupancy, admitted=admitted,
                        preempted=preempted, finished=finished, queue=queue,
                        running=running, kv_used=kv_used, kv_free=kv_free,
                        kv_frag_slots=kv_frag_slots)

    # ---- snapshots (stats() / serve.py / bench) -----------------------
    def slo_snapshot(self):
        """This engine's SLO block for ``stats()``/bench JSON."""
        att = {ph: (self._good[ph] / self._total[ph]
                    if self._total[ph] else None)
               for ph in ("ttft", "tpot")}
        return {
            "ttft_target_ms": round(self.slo_ttft_s * 1000.0, 3),
            "tpot_target_ms": round(self.slo_tpot_s * 1000.0, 3),
            "good": dict(self._good),
            "total": dict(self._total),
            "attainment": att,
            "goodput": (sum(self._window) / len(self._window)
                        if self._window else None),
            "burning": self._burning,
        }

    def phase_snapshot(self):
        """Per-phase p50/p99/total from THIS engine's labeled histograms."""
        out = {}
        for ph in PHASES:
            h = telemetry.histogram("serving.phase_seconds",
                                    engine=self.engine_id, phase=ph)
            out[ph] = {"count": h.count,
                       "total_s": round(h.sum, 6),
                       "p50_s": h.percentile(50),
                       "p99_s": h.percentile(99)}
        return out
