"""Merge per-worker traces into ONE cluster chrome trace, clocks aligned
(the port's own copy of ``tools/trace_merge.py``; standard library only).

A distributed run leaves N per-process files — chrome traces from the
port's profiler (``MXNET_PROFILER_AUTOSTART=1`` -> ``profile.<pid>.json``),
telemetry JSON-lines sinks (``MXNET_TELEMETRY_FILE=telemetry.{rank}.jsonl``)
and the servers' ``trace_to:`` tables written as such lines — with
unaligned wall clocks and no shared lane structure. This tool produces a
single chrome://tracing / Perfetto file with:

* **one lane (pid) per worker rank** — rank identity comes from the files
  themselves (the profiler's ``process_name`` metadata row, the telemetry
  records' ``rank`` field), never from filename guessing;
* **clocks aligned via cluster sync points**: the PS barrier releases every
  member simultaneously, and a BSP round's merged push commits to all
  workers at once — both are recorded per worker (``barrier`` events keyed
  by seq, ``bsp_sync`` events keyed by step id, ``kv.barrier`` spans). Each
  file's offset against the reference rank is the median pairwise gap over
  its matched sync points; the residual spread is reported so "aligned" is
  a quantified claim, not a hope;
* **annotations overlaid as instant events**: membership epochs
  (``mepoch_adopted`` / ``worker_lost`` / ``worker_rejoined`` /
  ``elastic_reconfigured``), guard rollbacks/stalls, resharding, straggler
  namings, epoch markers. Rank-less sources (a PS server hosting the
  membership registry) contribute annotations on a dedicated ``cluster``
  lane.

Usage::

    python -m mxnet_tpu_torch.tools.trace_merge -o merged.json \
        telemetry.0.jsonl telemetry.1.jsonl profile.1234.json profile.1240.json
    python -m mxnet_tpu_torch.tools.trace_merge -o merged.json /path/to/rundir
    python -m mxnet_tpu_torch.tools.trace_merge -o merged.json \
        --serving-lanes --validate serving_telemetry.jsonl

``--serving-lanes`` renders ``serving.request`` lifecycle events (from
``mxnet_tpu_torch/serving/obs.py``) as one lane per request — queue_wait /
prefill / decode / replay phase spans with preemption instants — plus a
per-engine occupancy counter lane from ``serving.step_timeline``.

``validate_trace`` is also a trace-event schema checker (required
ph/ts/pid/tid fields, per-tid start-time monotonicity, proper span
nesting).

Caveat: ``bsp_sync`` is a sync point only for *sync* BSP rounds
(``dist_sync``); on ``dist_async`` only barrier events align. Annotations
from rank-less files ride the reference clock unadjusted (their processes
expose no sync points) — same-host clusters are exact, cross-host registry
annotations carry that host's skew.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# events that become annotation instants in the merged trace
ANNOTATION_EVENTS = (
    "mepoch_adopted", "worker_lost", "worker_joined", "worker_rejoined",
    "elastic_reconfigured", "reshard", "kv.straggler",
    "guard_rollback", "guard_stall", "guard_bad_step",
    "epoch_start", "epoch_end",
    # compile observability (mxnet_tpu_torch/compileobs.py): a compile or
    # an attributed recompile landing mid-timeline explains a step-time
    # spike on that worker's lane; an oom marks where forensics were
    # dumped. (Chrome-trace files additionally carry the per-process
    # "compile" lane spans the profiler records — those merge as ordinary
    # events.)
    "compile", "compile.recompile", "oom",
    # serving SLO attainment crossing below the burn threshold
    # (mxnet_tpu_torch/serving/obs.py)
    "serving.slo_burn",
)
# annotation events whose `rank` field names the SUBJECT worker's lane
RANKED_ANNOTATIONS = ("worker_lost", "worker_joined", "worker_rejoined")


# ---------------------------------------------------------------------------
# input loading
# ---------------------------------------------------------------------------


def _barrier_key(fields):
    """Sync-point key for a barrier record/span. Includes the step id when
    present: barrier seq restarts in a RELAUNCHED elastic worker, so bare
    seq numbers would falsely match its first barriers against the
    survivors' run-start ones (tens of seconds apart) and corrupt that
    lane's median offset — (seq, step) pairs from different incarnations
    never collide."""
    if "step_id" in fields:
        return ("barrier", int(fields["seq"]), int(fields["step_id"]))
    return ("barrier", int(fields["seq"]))


def load_input(path):
    """Parse one per-worker file (chrome trace or telemetry JSON lines) into
    ``{"path", "kind", "rank", "events", "sync", "annotations"}`` — ``sync``
    maps hashable sync-point keys to wall seconds; ``rank`` is None when the
    file carries no identity (annotation-only source)."""
    with open(path) as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None  # multi-line JSONL (or a torn tail): the line parser's job
    if isinstance(obj, dict) and "traceEvents" in obj:
        return _load_trace(path, obj)
    return _load_jsonl(path, text.splitlines())


def _load_trace(path, obj):
    events = obj.get("traceEvents", [])
    rank = None
    sync = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("ph") == "M" and "rank" in args:
            rank = int(args["rank"])
        if ev.get("ph") == "X" and ev.get("name") == "kv.barrier" \
                and "seq" in args:
            # span END = the barrier release instant (the wait inside is
            # per-worker; the release is simultaneous across the group)
            sync[_barrier_key(args)] = (
                float(ev["ts"]) + float(ev.get("dur", 0))) / 1e6
    return {"path": path, "kind": "trace", "rank": rank,
            "events": [e for e in events if e.get("ph") != "M"],
            "sync": sync, "annotations": [], "serving": [],
            "serving_steps": []}


def _load_jsonl(path, f):
    rank = None
    sync = {}
    annotations = []
    serving = []
    serving_steps = []
    for line in f:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn final line of a killed worker: keep the rest
        if rank is None and isinstance(rec.get("rank"), int):
            rank = int(rec["rank"])
        if rec.get("type") != "event":
            continue
        name = rec.get("event")
        ts = rec.get("ts")
        if ts is None:
            continue
        if name == "barrier" and "seq" in rec:
            sync[_barrier_key(rec)] = float(ts)
        elif name == "bsp_sync" and "step_id" in rec:
            sync[("bsp_sync", int(rec["step_id"]))] = float(ts)
        if name == "serving.request" and "request_id" in rec:
            serving.append(rec)
        elif name == "serving.step_timeline":
            serving_steps.append(rec)
        if name in ANNOTATION_EVENTS:
            annotations.append(rec)
    return {"path": path, "kind": "jsonl", "rank": rank, "events": [],
            "sync": sync, "annotations": annotations, "serving": serving,
            "serving_steps": serving_steps}


# ---------------------------------------------------------------------------
# clock-offset estimation
# ---------------------------------------------------------------------------


def estimate_offsets(inputs):
    """Per-file clock offsets against the reference (the lowest identified
    rank): ``{path: {"offset_s", "residual_s", "sync_points"}}``. Offset is
    the median of ``ts_ref - ts_file`` over matched sync points — robust to
    the per-point jitter (socket latency, scheduling) that a mean would
    absorb; residual is the median absolute deviation around it, i.e. the
    error bar the merged timeline should be read with."""
    ranked = [i for i in inputs if i["rank"] is not None]
    if not ranked:
        return {i["path"]: {"offset_s": 0.0, "residual_s": 0.0,
                            "sync_points": 0} for i in inputs}
    ref = min(ranked, key=lambda i: i["rank"])
    # the reference CLOCK is the union of sync points from every file of
    # the reference rank (its jsonl and its chrome trace share one clock)
    ref_sync = {}
    for i in ranked:
        if i["rank"] == ref["rank"]:
            ref_sync.update(i["sync"])
    out = {}
    for i in inputs:
        if i["rank"] == ref["rank"]:
            out[i["path"]] = {"offset_s": 0.0, "residual_s": 0.0,
                              "sync_points": len(i["sync"])}
            continue
        deltas = sorted(ref_sync[k] - ts for k, ts in i["sync"].items()
                        if k in ref_sync)
        if not deltas:
            out[i["path"]] = {"offset_s": 0.0, "residual_s": None,
                              "sync_points": 0}
            continue
        off = deltas[len(deltas) // 2]
        resid = sorted(abs(d - off) for d in deltas)[len(deltas) // 2]
        out[i["path"]] = {"offset_s": off, "residual_s": resid,
                          "sync_points": len(deltas)}
    return out


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

_CLUSTER_PID = 1 << 20  # lane for rank-less annotation sources
_SERVING_PID_BASE = 1 << 21  # per-request serving lanes start here


def request_segments(events):
    """Phase segments for ONE request from its ``serving.request``
    lifecycle events: ``[(phase, start_s, end_s)]``, contiguous and
    non-overlapping. ``end_s`` is None for a phase still open at the end
    of the stream (request in flight when the sink closed). The walker
    mirrors serving/obs.py's clock: readmission after a preemption stays
    on the replay clock until the replay prefill lands (``replayed``)."""
    segs = []
    cur = None   # (phase, start_s)
    for rec in sorted(events, key=lambda r: float(r["ts"])):
        state = rec.get("state")
        ts = float(rec["ts"])
        if state == "submitted":
            cur = ("queue_wait", ts)
            continue
        if state == "readmitted":
            continue   # replay continues through the re-prefill
        if cur is not None and state in ("admitted", "decoding", "replayed",
                                         "preempted", "finished", "failed"):
            segs.append((cur[0], cur[1], ts))
        if state == "admitted":
            cur = ("prefill", ts)
        elif state in ("decoding", "replayed"):
            cur = ("decode", ts)
        elif state == "preempted":
            cur = ("replay", ts)
        elif state in ("finished", "failed"):
            cur = None
    if cur is not None:
        segs.append((cur[0], cur[1], None))
    return segs


def _serving_lane_events(inp, off_us, pid_alloc):
    """One chrome-trace lane per request (phase spans + preemption
    instants) plus one counter lane per engine (occupancy / queue /
    KV-pool time series) from an input's serving telemetry events."""
    out = []
    meta = []
    by_req = {}
    for rec in inp["serving"]:
        key = (str(rec.get("engine", "")), str(rec["request_id"]))
        by_req.setdefault(key, []).append(rec)
    # lane order = first-submission order, so the trace reads top-down in
    # arrival order
    for key in sorted(by_req, key=lambda k: float(by_req[k][0]["ts"])):
        engine, request_id = key
        pid = pid_alloc(("request",) + key)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "req %s" % request_id}})
        events = by_req[key]
        end_default = max(float(r["ts"]) for r in events)
        terminal = next((r for r in events
                         if r.get("state") in ("finished", "failed")), None)
        spans = [{
            "name": phase, "cat": "serving", "ph": "X",
            "ts": start * 1e6 + off_us,
            "dur": ((end if end is not None else end_default) - start) * 1e6,
            "pid": pid, "tid": 0,
            "args": {"request_id": request_id, "engine": engine},
        } for phase, start, end in request_segments(events)]
        if spans and terminal is not None and "phases" in terminal:
            # the terminal record's exact attribution rides on the lane's
            # closing span args (hover in Perfetto for the breakdown)
            spans[-1]["args"]["phases"] = terminal["phases"]
        out.extend(spans)
        for rec in events:
            if rec.get("state") == "preempted":
                out.append({
                    "name": "preempted", "cat": "serving", "ph": "i",
                    "s": "t", "ts": float(rec["ts"]) * 1e6 + off_us,
                    "pid": pid, "tid": 0,
                    "args": {"request_id": request_id,
                             "preemptions": rec.get("preemptions")},
                })
    by_engine = {}
    for rec in inp["serving_steps"]:
        by_engine.setdefault(str(rec.get("engine", "")), []).append(rec)
    for engine in sorted(by_engine):
        pid = pid_alloc(("engine", engine))
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0,
                     "args": {"name": "serving engine %s" % engine}})
        for rec in sorted(by_engine[engine], key=lambda r: float(r["ts"])):
            out.append({
                "name": "serving.occupancy", "cat": "serving", "ph": "C",
                "ts": float(rec["ts"]) * 1e6 + off_us, "pid": pid, "tid": 0,
                "args": {"occupancy": rec.get("occupancy", 0),
                         "queue": rec.get("queue", 0),
                         "kv_used": rec.get("kv_used", 0),
                         "kv_frag_slots": rec.get("kv_frag_slots", 0)},
            })
    return meta, out


def merge(inputs, offsets=None, serving_lanes=False):
    """One chrome trace from N per-worker inputs: pid = rank (one lane per
    rank; multiple files of one rank — e.g. a killed incarnation's jsonl
    plus its replacement's — share the lane on distinct tids), spans
    shifted by each file's clock offset, annotations as instant events.

    ``serving_lanes=True`` additionally renders the serving telemetry a
    file carries as one lane per request (phase spans: queue_wait /
    prefill / decode / replay, preemption instants) plus a per-engine
    occupancy counter lane — the chrome-trace view of
    serving report."""
    offsets = offsets if offsets is not None else estimate_offsets(inputs)
    merged = []
    lanes = set()
    serving_meta = []
    _serving_pids = {}

    def _pid_alloc(key):
        # one lane per (request|engine) identity, shared across input
        # files that carry events for the same request
        if key not in _serving_pids:
            _serving_pids[key] = _SERVING_PID_BASE + len(_serving_pids)
        return _serving_pids[key]

    for idx, inp in enumerate(inputs):
        off_us = offsets[inp["path"]]["offset_s"] * 1e6
        if serving_lanes and (inp.get("serving") or inp.get("serving_steps")):
            s_meta, s_events = _serving_lane_events(inp, off_us, _pid_alloc)
            serving_meta.extend(s_meta)
            merged.extend(s_events)
        rank = inp["rank"]
        pid = rank if rank is not None else _CLUSTER_PID
        lanes.add(pid)
        tid_base = (idx + 1) * 100000  # distinct tids per source file
        for ev in inp["events"]:
            ev = dict(ev)
            ev["pid"] = pid
            ev["tid"] = tid_base + int(ev.get("tid", 0)) % 100000
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + off_us
            merged.append(ev)
        for rec in inp["annotations"]:
            name = rec["event"]
            target = pid
            if name in RANKED_ANNOTATIONS and isinstance(rec.get("rank"),
                                                         int):
                target = rec["rank"]
                lanes.add(target)
            args = {k: v for k, v in rec.items()
                    if k not in ("ts", "type", "event")}
            if name in ("mepoch_adopted", "worker_lost", "worker_rejoined",
                        "elastic_reconfigured") and "epoch" in args:
                label = "%s mepoch=%s" % (name, args["epoch"])
            elif name == "mepoch_adopted":
                label = "mepoch=%s" % args.get("epoch")
            else:
                label = name
            merged.append({
                "name": label, "cat": "annotation", "ph": "i", "s": "p",
                "ts": float(rec["ts"]) * 1e6 + off_us,
                "pid": target, "tid": tid_base, "args": args,
            })
    meta = []
    for pid in sorted(lanes):
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": ("cluster" if pid == _CLUSTER_PID
                              else "rank %d" % pid)},
        })
    meta.extend(serving_meta)
    merged.sort(key=lambda e: (e.get("pid", 0), e.get("tid", 0),
                               e.get("ts", 0)))
    return {
        "traceEvents": meta + merged,
        "displayTimeUnit": "ms",
        "otherData": {"clock_offsets": {
            os.path.basename(p): v for p, v in offsets.items()}},
    }


# ---------------------------------------------------------------------------
# trace-event schema validation
# ---------------------------------------------------------------------------


def validate_trace(trace, _eps_us=0.5):
    """Schema check for chrome trace-event JSON: returns a list of problem
    strings (empty = valid). Checks: ``traceEvents`` is a list of dicts;
    complete ('X') and instant ('i') events carry numeric ts/pid/tid (plus
    non-negative dur for spans); per (pid, tid) the FILE ORDER of events is
    non-decreasing in ts (our emitters sort at dump time — regression
    guard); and per tid, 'X' spans nest properly (an overlap that is not a
    containment means two spans claim the same thread time)."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = {}
    spans = {}
    for n, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append("event %d: not an object" % n)
            continue
        ph = ev.get("ph")
        if ph is None:
            problems.append("event %d: missing ph" % n)
            continue
        if ph == "M":
            if "pid" not in ev:
                problems.append("event %d: metadata without pid" % n)
            continue
        if ph not in ("X", "i", "I", "C"):
            continue  # other phases: out of scope for our emitters
        for field in ("ts", "pid", "tid"):
            if not isinstance(ev.get(field), (int, float)):
                problems.append("event %d (%s): missing/non-numeric %s"
                                % (n, ev.get("name"), field))
                break
        else:
            key = (ev["pid"], ev["tid"])
            if ev["ts"] < last_ts.get(key, float("-inf")) - _eps_us:
                problems.append(
                    "event %d (%s): ts regresses on pid=%s tid=%s"
                    % (n, ev.get("name"), ev["pid"], ev["tid"]))
            last_ts[key] = max(ev["ts"], last_ts.get(key, float("-inf")))
            if ph == "X":
                dur = ev.get("dur")
                if not isinstance(dur, (int, float)) or dur < 0:
                    problems.append("event %d (%s): span without dur"
                                    % (n, ev.get("name")))
                else:
                    spans.setdefault(key, []).append(
                        (float(ev["ts"]), float(ev["ts"]) + float(dur),
                         ev.get("name")))
    for key, sp in spans.items():
        stack = []
        # same-start spans: the LONGER one is the container — visit it first
        for start, end, name in sorted(sp, key=lambda x: (x[0], -x[1])):
            while stack and start >= stack[-1][0] - _eps_us:
                stack.pop()
            if stack and end > stack[-1][0] + _eps_us:
                problems.append(
                    "span %r on pid=%s tid=%s overlaps %r without nesting"
                    % (name, key[0], key[1], stack[-1][1]))
            stack.append((end, name))
    return problems


def lane_pids(trace):
    """The worker-lane pids of a merged trace (annotation + serving lanes
    excluded)."""
    return sorted({ev["pid"] for ev in trace.get("traceEvents", [])
                   if isinstance(ev.get("pid"), int)
                   and ev["pid"] < _CLUSTER_PID})


def serving_request_lanes(trace):
    """The per-request serving lanes of a merged trace:
    ``{pid: request_label}`` for every ``req <request_id>`` lane (the
    per-engine occupancy counter lanes are excluded)."""
    return {ev["pid"]: ev["args"]["name"]
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "process_name"
            and isinstance(ev.get("pid"), int)
            and ev["pid"] >= _SERVING_PID_BASE
            and str((ev.get("args") or {}).get("name", "")
                    ).startswith("req ")}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _expand_paths(paths):
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.endswith((".json", ".jsonl")):
                    out.append(os.path.join(p, name))
        else:
            out.append(p)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Merge per-worker chrome traces + telemetry JSONL into "
                    "one clock-aligned cluster trace (one lane per rank)")
    ap.add_argument("inputs", nargs="+",
                    help="trace/jsonl files, or directories to scan")
    ap.add_argument("-o", "--out", default="merged_trace.json")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the merged trace and fail on problems")
    ap.add_argument("--serving-lanes", action="store_true",
                    help="render serving telemetry as one lane per request "
                         "(lifecycle phase spans + preemption instants) "
                         "plus a per-engine occupancy counter lane")
    args = ap.parse_args(argv)
    inputs = []
    for path in _expand_paths(args.inputs):
        try:
            inputs.append(load_input(path))
        except (OSError, ValueError) as exc:
            print("trace_merge: skipping %s (%s)" % (path, exc),
                  file=sys.stderr)
    if not inputs:
        print("trace_merge: no readable inputs", file=sys.stderr)
        return 2
    offsets = estimate_offsets(inputs)
    trace = merge(inputs, offsets, serving_lanes=args.serving_lanes)
    with open(args.out, "w") as f:
        json.dump(trace, f)
    for inp in inputs:
        o = offsets[inp["path"]]
        print("  %-40s rank=%-4s offset=%s residual=%s (%d sync points)"
              % (os.path.basename(inp["path"]),
                 inp["rank"] if inp["rank"] is not None else "-",
                 "%+.6fs" % o["offset_s"],
                 ("%.6fs" % o["residual_s"]) if o["residual_s"] is not None
                 else "n/a",
                 o["sync_points"]))
    suffix = ""
    if args.serving_lanes:
        suffix = " (+%d request lanes)" % len(serving_request_lanes(trace))
    print("trace_merge: %d lanes%s -> %s"
          % (len(lane_pids(trace)), suffix, args.out))
    if args.validate:
        problems = validate_trace(trace)
        if problems:
            for p in problems[:20]:
                print("trace_merge: INVALID: %s" % p, file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
