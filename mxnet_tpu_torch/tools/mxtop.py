"""mxtop — live terminal dashboard for a distributed training cluster
(the port's own copy of ``tools/mxtop.py``).

Attaches to the PS tier as a read-only OBSERVER: every worker publishes a
compact telemetry snapshot into its persistent reserved key on the
registry's server (``kvstore.telemetry_slot``), so this tool needs
nothing from the workers themselves — point it at server 0 and it
renders, per rank:

* training position (epoch/batch decoded from the stamped step id),
  imgs/sec, and step time;
* the per-step split (data-wait / compute / kv-sync / guard percent);
* queue depths (engine, device feed), membership-rejection and RPC-failure
  counters, compile seconds, recompiles and compile-cache hits, and
  snapshot age (a stale row = a dead or wedged worker);

plus the cluster header: membership epoch + table (elastic runs), and the
straggler attribution computed from the same published windows the rank-0
detector uses (``kvstore._pick_straggler`` — one code path, two
consumers). The observer opens plain clients of the port's native
``ps.cc``: it never registers with the membership registry and never sets
a rank, so its pulls stay out of the per-rank trace attribution.

Usage::

    python -m mxnet_tpu_torch.tools.mxtop --host 127.0.0.1 --port 9091 -n 4
    python -m mxnet_tpu_torch.tools.mxtop --once   # one frame, no screen control
    python -m mxnet_tpu_torch.tools.mxtop --trace  # also per-server rank traces
    python -m mxnet_tpu_torch.tools.mxtop --serving http://127.0.0.1:8090

Defaults come from the launcher's DMLC_* env when present, so running it
on a cluster host needs no flags.

``--serving URL`` switches to the serving panel: polls a
``python -m mxnet_tpu_torch.tools.serve`` instance's ``/stats`` endpoint
and renders occupancy, KV-pool pressure, latency/TTFT percentiles, the
per-phase attribution (queue_wait/prefill/decode/replay/compile_stall)
and SLO attainment.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import threading
import time

import numpy as np

from mxnet_tpu_torch._native import load as _load_native
from mxnet_tpu_torch.kvstore import _pick_straggler, telemetry_slot
from mxnet_tpu_torch.kvstore_server import decode_bytes_vec

# observer-side single-shot reserved keys (mb_get / trace_to publishes):
# far below the workers' small-negative stats keys, far above the
# persistent telemetry range, erased by the server after one pull
_OBS_KEY_BASE = -(1 << 19)


class Observer:
    """Read-only PS-tier client: pulls snapshot slots and registry tables."""

    def __init__(self, host, port, num_servers=1, timeout_ms=2000):
        self._lib = _load_native()
        self._timeout_ms = int(timeout_ms)
        self._seq = 0
        self._clients = []
        for s in range(num_servers):
            c = self._lib.mxt_ps_client_create(host.encode(), port + s)
            if not c and s == 0:
                raise RuntimeError("cannot reach PS server %s:%d"
                                   % (host, port))
            self._clients.append(c)
        # identity deliberately NOT set: an observer's pulls must stay
        # rank -1 so they never pollute per-rank trace attribution

    def _bounded_pull(self, client, key, cap):
        buf = np.zeros(cap, np.float32)
        result = [None]

        def pull():
            result[0] = self._lib.mxt_ps_client_pull(
                client, key,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)

        t = threading.Thread(target=pull, daemon=True, name="mxtop-pull")
        t.start()
        t.join(self._timeout_ms / 1000.0)
        if t.is_alive():
            return None, buf
        return result[0], buf

    def _fetch_json(self, client, cmd_prefix):
        """Command-then-pull fetch of a JSON payload a server publishes on
        demand (mb_get / trace_to), or None when it does not answer. The
        key sequence wraps before reaching the persistent telemetry range
        at -(1<<20) — a long-attached observer must never alias a worker's
        snapshot slot (reuse is safe: negative-key pushes always take the
        server's overwrite path, csrc/native/ps.cc)."""
        self._seq = self._seq % ((1 << 19) - 1) + 1
        key = _OBS_KEY_BASE - self._seq
        cmd = ("%s:%d" % (cmd_prefix, key)).encode()
        if self._lib.mxt_ps_client_probe(client, cmd, self._timeout_ms) != 0:
            return None
        cap = 65536
        got, buf = self._bounded_pull(client, key, cap)
        if got is None or got <= 0 or got > cap:
            return None
        raw = decode_bytes_vec(buf[:got])
        if not raw:
            return None
        try:
            return json.loads(raw.decode())
        except ValueError:
            return None

    def snapshot(self, rank):
        """Rank ``rank``'s last published telemetry snapshot, or None."""
        cap = 65536
        got, buf = self._bounded_pull(self._clients[0],
                                      telemetry_slot(rank), cap)
        if got is None or got <= 0 or got > cap:
            return None
        raw = decode_bytes_vec(buf[:got])
        if not raw:
            return None
        try:
            return json.loads(raw.decode())
        except ValueError:
            return None

    def membership(self):
        """The membership registry's table (elastic runs), or None."""
        return self._fetch_json(self._clients[0], "mb_get")

    def server_traces(self):
        """Per-server per-rank RPC attribution tables."""
        out = {}
        for i, c in enumerate(self._clients):
            out[i] = self._fetch_json(c, "trace_to") if c else None
        return out


def _decode_step(step_id):
    if not step_id:
        return "-"
    return "e%d/b%d" % (int(step_id) >> 32, int(step_id) & 0xFFFFFFFF)


def _pct(part, whole):
    return "%3.0f" % (100.0 * part / whole) if whole > 0 else "  -"


def render(snaps, membership=None, straggler_factor=2.0, now=None):
    """One dashboard frame as a string (pure: unit-testable)."""
    now = now if now is not None else time.time()
    lines = []
    mep = max([s.get("mepoch", 0) for s in snaps.values() if s] or [0])
    head = "mxtop  mepoch=%d  workers=%d/%d" % (
        mep, sum(1 for s in snaps.values() if s), len(snaps))
    if membership:
        head += "  registry=%s%s" % (
            membership.get("workers"),
            " DONE" if membership.get("done") else "")
    straggler = _pick_straggler(snaps, straggler_factor, max_age_s=30.0,
                                now=now)
    if straggler:
        head += "  STRAGGLER: rank %d (%s, %.1fx)" % (
            straggler["rank"], straggler["stage"], straggler["ratio"])
    lines.append(head)
    lines.append("%-5s %-12s %9s %9s %6s %6s %6s %6s %7s %5s %5s %5s %7s "
                 "%5s %6s %6s"
                 % ("rank", "step", "imgs/s", "step_ms", "data%", "comp%",
                    "kv%", "ovl%", "guard%", "engq", "feedq", "rej",
                    "cmpl_s", "rcmp", "hit", "age"))
    for rank in sorted(snaps):
        s = snaps[rank]
        if not s:
            lines.append("%-5d %-12s %s" % (rank, "-", "(no snapshot)"))
            continue
        w = s.get("window") or {}
        steps = w.get("steps") or 0
        wall = w.get("step_time", 0.0)
        q = s.get("queues") or {}
        c = s.get("counters") or {}
        # compile observability (compileobs summary published per rank): a
        # rank whose recompile count keeps climbing is paying an XLA
        # compile wall inside its steps — the classic silent-retrace bug
        comp = s.get("compile") or {}
        age = now - float(s.get("ts", now))
        # persistent-cache split per rank: "7/9" = 7 of 9 classified
        # compiles were warm disk hits (a relaunched worker starting cold
        # shows 0/N here while its peers ran warm)
        hits = comp.get("cache_hits")
        if hits is None:
            hit_col = "-"
        else:
            hit_col = "%d/%d" % (int(hits),
                                 int(hits) + int(comp.get("cache_misses",
                                                          0)))
        lines.append(
            "%-5d %-12s %9.1f %9.1f %6s %6s %6s %6s %7s %5d %5d %5d %7.1f "
            "%5d %6s %5.1fs"
            % (rank, _decode_step(s.get("step_id")),
               float(s.get("imgs_per_sec", 0.0)),
               (wall / steps * 1000.0) if steps else 0.0,
               _pct(w.get("data_wait", 0.0), wall),
               _pct(w.get("compute", 0.0), wall),
               _pct(w.get("kv_sync", 0.0), wall),
               # RPC wall the bucketed sync hid behind compute (can exceed
               # the step wall on many-bucket plans; shown vs wall anyway —
               # the interesting signal is kv% shrinking while ovl% carries
               # the traffic)
               _pct(w.get("kv_overlap", 0.0), wall),
               _pct(w.get("guard", 0.0), wall),
               int(q.get("engine", 0)), int(q.get("feed", 0)),
               int(c.get("rejected", 0)),
               float(comp.get("seconds", 0.0)),
               int(comp.get("recompiles", 0)), hit_col, age))
        last = (comp.get("last_recompile") or {}) \
            if comp.get("recompiles") else {}
        if last:
            lines.append(
                "      last recompile: %s (%s)"
                % (last.get("program"), last.get("cause")))
    return "\n".join(lines)


def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024.0 or unit == "GiB":
            return "%.0f%s" % (n, unit) if unit == "B" \
                else "%.1f%s" % (n, unit)
        n /= 1024.0


def render_serving(stats, now=None):
    """One serving-panel frame from a serve.py ``/stats`` snapshot
    (pure: unit-testable)."""
    def ms(v):
        return "--" if v is None else "%.0f" % (float(v) * 1000.0)

    lines = []
    slo = stats.get("slo") or {}
    goodput = slo.get("goodput")
    lines.append(
        "mxtop serving  engine=%s  steps=%d  completed=%d  failed=%d  "
        "preemptions=%d"
        % (stats.get("engine", "?"), stats.get("steps", 0),
           stats.get("completed", 0), stats.get("failed", 0),
           stats.get("preemptions", 0)))
    lines.append(
        "  act %3d wait %3d | kv %4d/%-4d frag %5d | %7.1f tok/s | "
        "ttft %s/%s ms | lat %s/%s ms"
        % (stats.get("active", 0), stats.get("waiting", 0),
           stats.get("kv_blocks_used", 0), stats.get("kv_blocks_total", 0),
           int(stats.get("kv_blocks_frag_slots", 0)),
           float(stats.get("tokens_per_sec", 0.0)),
           ms(stats.get("ttft_p50_s")), ms(stats.get("ttft_p99_s")),
           ms(stats.get("latency_p50_s")), ms(stats.get("latency_p99_s"))))
    att = slo.get("attainment") or {}

    def pct(v):
        return "--" if v is None else "%.0f%%" % (float(v) * 100.0)

    lines.append(
        "  slo: ttft<=%sms %s | tpot<=%sms %s | goodput %s%s"
        % (slo.get("ttft_target_ms", "?"), pct(att.get("ttft")),
           slo.get("tpot_target_ms", "?"), pct(att.get("tpot")),
           pct(goodput), "  BURNING" if slo.get("burning") else ""))
    prefix = stats.get("prefix") or {}
    spec = stats.get("spec") or {}
    if prefix.get("enabled") or spec.get("enabled"):
        bits = []
        if prefix.get("enabled"):
            bits.append(
                "prefix: hit %s (%d/%d lkups, %d blk) shared %d blk "
                "saved %s"
                % (pct(prefix.get("hit_rate", 0.0)
                       if prefix.get("lookups") else None),
                   prefix.get("hits", 0), prefix.get("lookups", 0),
                   prefix.get("hit_blocks", 0),
                   prefix.get("shared_blocks", 0),
                   _fmt_bytes(prefix.get("kv_bytes_saved", 0))))
        if spec.get("enabled"):
            bits.append(
                "spec k=%s/%s: accept %s (%d/%d)"
                % (spec.get("k", "?"), spec.get("draft", "?"),
                   pct(spec.get("acceptance_rate", 0.0)
                       if spec.get("proposed_tokens") else None),
                   spec.get("accepted_tokens", 0),
                   spec.get("proposed_tokens", 0)))
        lines.append("  " + " | ".join(bits))
    res = stats.get("resilience") or {}
    sup = stats.get("supervisor") or {}
    if res or sup:
        bits = ["shed %d to %d cx %d"
                % (res.get("shed", 0), res.get("timed_out", 0),
                   res.get("cancelled", 0))]
        if sup:
            bits.append("restarts %d/%s%s"
                        % (sup.get("restarts", 0),
                           sup.get("max_restarts", "?"),
                           " RESTARTING" if sup.get("restarting") else ""))
        state = None
        if sup.get("failed") or res.get("aborted"):
            state = "FAILED"
        elif res.get("draining") or sup.get("draining"):
            state = "DRAINING"
        if state:
            bits.append(state)
        lines.append("  " + " | ".join(bits))
    phases = stats.get("phases") or {}
    if phases:
        lines.append("  %-14s %10s %10s %10s"
                     % ("phase", "p50_ms", "p99_ms", "total_s"))
        for ph in ("queue_wait", "prefill", "decode", "replay",
                   "compile_stall"):
            row = phases.get(ph) or {}
            lines.append("  %-14s %10s %10s %10.3f"
                         % (ph, ms(row.get("p50_s")), ms(row.get("p99_s")),
                            float(row.get("total_s", 0.0))))
    return "\n".join(lines)


def _fetch_stats(url, timeout_s=2.0):
    """GET ``<url>/stats`` from a serve.py instance, or None."""
    from urllib.request import urlopen

    try:
        with urlopen(url.rstrip("/") + "/stats", timeout=timeout_s) as r:
            return json.loads(r.read().decode())
    except (OSError, ValueError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description="live cluster dashboard over "
                                             "the PS telemetry plane")
    ap.add_argument("--host",
                    default=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"))
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")))
    ap.add_argument("-n", "--num-workers", type=int,
                    default=int(os.environ.get("DMLC_NUM_WORKER", "1")))
    ap.add_argument("-s", "--num-servers", type=int,
                    default=int(os.environ.get("DMLC_NUM_SERVER", "1")))
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen control)")
    ap.add_argument("--trace", action="store_true",
                    help="also print per-server per-rank RPC attribution")
    ap.add_argument("--factor", type=float, default=2.0,
                    help="straggler threshold vs cluster-median self time")
    ap.add_argument("--serving", default=None, metavar="URL",
                    help="render the serving panel from a serve.py "
                         "instance's /stats instead of the PS plane "
                         "(e.g. http://127.0.0.1:8090)")
    args = ap.parse_args(argv)
    if args.serving:
        while True:
            stats = _fetch_stats(args.serving)
            frame = (render_serving(stats) if stats
                     else "mxtop serving: no /stats from %s" % args.serving)
            if args.once:
                print(frame)
                return 0 if stats else 1
            sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    obs = Observer(args.host, args.port, args.num_servers)
    while True:
        snaps = {r: obs.snapshot(r) for r in range(args.num_workers)}
        frame = render(snaps, obs.membership(), args.factor)
        if args.trace:
            frame += "\nserver traces: %s" % json.dumps(obs.server_traces())
        if args.once:
            print(frame)
            return 0
        sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
