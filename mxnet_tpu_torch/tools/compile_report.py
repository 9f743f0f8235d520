"""compile_report — the program registry as a report (the port's counterpart
of ``tools/compile_report.py``).

Two sources, one report:

* live, in the process that ran: :func:`from_registry` reads
  ``compileobs.summary()`` and ``compileobs.program_table()`` (every CUDA
  graph capture, nvcc build and first run at a new signature, and every
  attributed recompile);
* offline, from telemetry JSON lines (``MXNET_TELEMETRY_FILE=run.jsonl``):
  :func:`analyze` reads the ``compile``, ``compile.recompile`` and ``oom``
  events and the last registry snapshot of each writer.

Three views: the compile timeline, recompile causes ranked by the seconds
they cost, and programs by compile seconds against run seconds — with the
persistent compile cache's hit rate per program when it was on (from the
``cached`` field of the compile events, or the ``compile.cache_hits`` /
``compile.cache_misses`` counters of the snapshots). :func:`compare` puts
a warm restart beside the cold run it followed.

Usage::

    python -m mxnet_tpu_torch.tools.compile_report run.jsonl [more.jsonl ...]
    python -m mxnet_tpu_torch.tools.compile_report --json run.jsonl
    python -m mxnet_tpu_torch.tools.compile_report --compare cold.jsonl warm.jsonl

and in a process, ``print(render(from_registry()))``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

_KEY_RE = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$")


def _parse_key(key):
    """'compile.seconds{program=x}' -> ('compile.seconds', {'program': 'x'})."""
    m = _KEY_RE.match(key)
    if not m:
        return key, {}
    labels = {}
    for part in m.group("labels").split(","):
        k, _, v = part.partition("=")
        if k:
            labels[k.strip()] = v.strip()
    return m.group("name"), labels


def load_records(paths):
    """Every parseable JSON line of ``paths`` (a torn last line is
    skipped), each tagged with its file's index (``_src``)."""
    records = []
    for i, path in enumerate(paths):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    rec.setdefault("_src", i)
                    records.append(rec)
    return records


def _causes(recompiles):
    by_cause = {}
    for r in recompiles:
        key = (r.get("program", "?"), r.get("cause", "?"))
        slot = by_cause.setdefault(
            key, {"program": key[0], "cause": key[1], "count": 0,
                  "seconds": 0.0, "example": None})
        slot["count"] += 1
        slot["seconds"] += float(r.get("seconds", 0.0))
        if slot["example"] is None and r.get("arg"):
            slot["example"] = "%s %s->%s" % (
                r.get("arg"), r.get("old_shape"), r.get("new_shape"))
    return sorted(by_cause.values(), key=lambda s: -s["seconds"])


def analyze(records):
    """Telemetry records -> the report dict."""
    compiles, recompiles, ooms = [], [], []
    last_snapshots = {}  # the latest snapshot of each writer (rank or file)
    for rec in records:
        kind = rec.get("type")
        if kind == "snapshot":
            writer = rec.get("rank", "_src:%s" % rec.get("_src"))
            prev = last_snapshots.get(writer)
            if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
                last_snapshots[writer] = rec
        elif kind == "event":
            ev = rec.get("event")
            if ev == "compile":
                compiles.append(rec)
            elif ev == "compile.recompile":
                recompiles.append(rec)
            elif ev == "oom":
                ooms.append(rec)
    programs = {}

    def _slot(name):
        return programs.setdefault(name, {"program": name, "compile_count": 0,
                                          "compile_seconds": 0.0,
                                          "run_seconds": 0.0,
                                          "cache_hits": 0, "cache_misses": 0})

    for snapshot in last_snapshots.values():
        for key, snap in (snapshot.get("histograms") or {}).items():
            name, labels = _parse_key(key)
            if name == "compile.seconds" and "program" in labels:
                slot = _slot(labels["program"])
                slot["compile_count"] += int(snap.get("count", 0))
                slot["compile_seconds"] += float(snap.get("sum", 0.0))
        for key, val in (snapshot.get("gauges") or {}).items():
            name, labels = _parse_key(key)
            if name == "compile.run_seconds" and "program" in labels:
                _slot(labels["program"])["run_seconds"] += float(val)
        for key, val in (snapshot.get("counters") or {}).items():
            name, labels = _parse_key(key)
            if name == "compile.cache_hits" and "program" in labels:
                _slot(labels["program"])["cache_hits"] += int(val)
            elif name == "compile.cache_misses" and "program" in labels:
                _slot(labels["program"])["cache_misses"] += int(val)
    if not programs:
        for r in compiles:
            slot = _slot(r.get("program", "?"))
            slot["compile_count"] += 1
            slot["compile_seconds"] += float(r.get("seconds", 0.0))
            if r.get("cached") is True:
                slot["cache_hits"] += 1
            elif r.get("cached") is False:
                slot["cache_misses"] += 1
    compiles.sort(key=lambda r: r.get("ts", 0))
    prog_rows = sorted(programs.values(), key=lambda p: -p["compile_seconds"])
    totals = {
        "compiles": len(compiles),
        "compile_seconds": round(
            sum(float(r.get("seconds", 0.0)) for r in compiles), 3),
        "recompiles": len(recompiles),
        "cache_hits": sum(p["cache_hits"] for p in prog_rows),
        "cache_misses": sum(p["cache_misses"] for p in prog_rows),
    }
    if not compiles and prog_rows:
        totals["compiles"] = sum(p["compile_count"] for p in prog_rows)
        totals["compile_seconds"] = round(
            sum(p["compile_seconds"] for p in prog_rows), 3)
    _hit_rate(totals)
    return {"timeline": compiles, "recompile_causes": _causes(recompiles),
            "programs": prog_rows, "ooms": ooms, "totals": totals}


def _hit_rate(totals):
    classified = totals["cache_hits"] + totals["cache_misses"]
    totals["cache_hit_rate"] = round(
        totals["cache_hits"] / classified, 4) if classified else None


def from_registry():
    """This process's ``compileobs`` registry -> the report dict (the
    timeline from each program's first and last compile)."""
    from .. import compileobs, telemetry

    summary = compileobs.summary()
    table = compileobs.program_table()
    timeline = sorted(
        ({"ts": r["last_compile_ts"], "program": r["program"],
          "seconds": r["compile_seconds"], "site": r["site"]}
         for r in table if r["last_compile_ts"] is not None),
        key=lambda r: r["ts"])
    programs = []
    for r in table:
        row = {k: r[k] for k in ("program", "compile_count",
                                 "compile_seconds", "run_seconds")}
        row["cache_hits"] = int(telemetry.counter(
            "compile.cache_hits", program=r["program"]).value)
        row["cache_misses"] = int(telemetry.counter(
            "compile.cache_misses", program=r["program"]).value)
        programs.append(row)
    totals = {"compiles": summary["compile_count"],
              "compile_seconds": summary["compile_seconds"],
              "recompiles": summary["recompile_count"],
              "cache_hits": sum(p["cache_hits"] for p in programs),
              "cache_misses": sum(p["cache_misses"] for p in programs)}
    _hit_rate(totals)
    return {
        "timeline": timeline,
        "recompile_causes": _causes(summary["recompiles"]),
        "programs": programs,
        "ooms": [],
        "totals": totals,
    }


def render(report):
    """The report dict as text."""
    t = report["totals"]
    head = ("compile report: %d compiles, %.2fs compile wall, %d recompiles"
            % (t["compiles"], t["compile_seconds"], t["recompiles"]))
    if t.get("cache_hit_rate") is not None:
        head += ", cache %d/%d hit (%.0f%%)" % (
            t["cache_hits"], t["cache_hits"] + t["cache_misses"],
            t["cache_hit_rate"] * 100.0)
    lines = [head]
    tl = report["timeline"]
    if tl:
        t0 = tl[0].get("ts", 0)
        lines += ["", "## compile timeline",
                  "%8s  %-28s %8s  %s" % ("t+s", "program", "seconds", "site")]
        for r in tl:
            lines.append("%8.2f  %-28s %8.3f  %s"
                         % (r.get("ts", 0) - t0, r.get("program", "?"),
                            float(r.get("seconds", 0.0)), r.get("site", "")))
    if report["recompile_causes"]:
        lines += ["", "## recompile causes (ranked by cost)",
                  "%-28s %-10s %6s %9s  %s"
                  % ("program", "cause", "count", "seconds", "example")]
        for c in report["recompile_causes"]:
            lines.append("%-28s %-10s %6d %9.3f  %s"
                         % (c["program"], c["cause"], c["count"],
                            c["seconds"], c["example"] or ""))
    if report["programs"]:
        show_cache = any(p.get("cache_hits") or p.get("cache_misses")
                         for p in report["programs"])
        lines += ["", "## programs (compile wall vs steady-state run)",
                  "%-28s %9s %12s %12s%s"
                  % ("program", "compiles", "compile_s", "run_s",
                     "  %8s" % "hit-rate" if show_cache else "")]
        for p in report["programs"]:
            row = "%-28s %9d %12.3f %12.3f" % (
                p["program"], p["compile_count"], p["compile_seconds"],
                p["run_seconds"])
            if show_cache:
                n = p["cache_hits"] + p["cache_misses"]
                row += "  %8s" % ("%d/%d" % (p["cache_hits"], n) if n else "-")
            lines.append(row)
    for oom in report["ooms"]:
        lines += ["", "## OOM at program %r" % oom.get("program"),
                  "error: %s" % oom.get("error"),
                  "device memory: %s" % json.dumps(oom.get("device_memory", {}))]
        for a in oom.get("top_allocations", []):
            lines.append("  %12d bytes  %-20s %-10s %s"
                         % (a.get("bytes", 0), a.get("shape"), a.get("dtype"),
                            a.get("device", a.get("context"))))
    return "\n".join(lines)


def compare(cold_report, warm_report):
    """Warm-vs-cold comparison (the compile-cache acceptance number as one
    command): per-program compile seconds of run B against run A, the
    summed reduction, and B's cache hit rate. ``reduction_pct`` is the
    headline — ">= 70" is the bar a warm restart must clear."""
    a_progs = {p["program"]: p for p in cold_report["programs"]}
    b_progs = {p["program"]: p for p in warm_report["programs"]}
    rows = []
    for name in sorted(set(a_progs) | set(b_progs)):
        a = a_progs.get(name)
        b = b_progs.get(name)
        a_s = a["compile_seconds"] if a else 0.0
        b_s = b["compile_seconds"] if b else 0.0
        rows.append({
            "program": name,
            "cold_seconds": round(a_s, 3),
            "warm_seconds": round(b_s, 3),
            "reduction_pct": round((1.0 - b_s / a_s) * 100.0, 1)
            if a_s > 0 else None,
            "warm_cache_hits": b["cache_hits"] if b else 0,
            "warm_cold_compiles": b["cache_misses"] if b else 0,
        })
    rows.sort(key=lambda r: -r["cold_seconds"])
    a_t, b_t = cold_report["totals"], warm_report["totals"]
    a_sum, b_sum = a_t["compile_seconds"], b_t["compile_seconds"]
    return {
        "programs": rows,
        "totals": {
            "cold_seconds": round(a_sum, 3),
            "warm_seconds": round(b_sum, 3),
            "reduction_pct": round((1.0 - b_sum / a_sum) * 100.0, 1)
            if a_sum > 0 else None,
            "warm_cache_hit_rate": b_t.get("cache_hit_rate"),
            "warm_cold_compiles": b_t.get("cache_misses", 0),
        },
    }


def render_compare(cmp_report):
    lines = []
    t = cmp_report["totals"]
    red = ("%.1f%%" % t["reduction_pct"]
           if t["reduction_pct"] is not None else "n/a")
    rate = ("%.0f%%" % (t["warm_cache_hit_rate"] * 100.0)
            if t["warm_cache_hit_rate"] is not None else "n/a")
    lines.append("warm vs cold: %.2fs -> %.2fs compile wall (%s reduction), "
                 "warm hit rate %s, %d cold compiles in the warm run"
                 % (t["cold_seconds"], t["warm_seconds"], red, rate,
                    t["warm_cold_compiles"]))
    lines.append("")
    lines.append("%-28s %10s %10s %10s %10s"
                 % ("program", "cold_s", "warm_s", "reduction",
                    "warm hits"))
    for r in cmp_report["programs"]:
        lines.append("%-28s %10.3f %10.3f %10s %10s"
                     % (r["program"], r["cold_seconds"], r["warm_seconds"],
                        "%.1f%%" % r["reduction_pct"]
                        if r["reduction_pct"] is not None else "n/a",
                        "%d/%d" % (r["warm_cache_hits"],
                                   r["warm_cache_hits"]
                                   + r["warm_cold_compiles"])))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render the compile report from telemetry JSONL sinks")
    ap.add_argument("paths", nargs="*", help="telemetry JSONL file(s)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--compare", nargs=2, metavar=("COLD", "WARM"),
                    help="compare two runs' compile walls (cold process vs "
                         "warm restart over the persistent compile cache)")
    args = ap.parse_args(argv)
    if args.compare:
        if args.paths:
            ap.error("--compare takes exactly its two files")
        cmp_report = compare(analyze(load_records([args.compare[0]])),
                             analyze(load_records([args.compare[1]])))
        print(json.dumps(cmp_report, indent=1) if args.as_json
              else render_compare(cmp_report))
        return 0
    if not args.paths:
        ap.error("give telemetry JSONL file(s) or --compare COLD WARM")
    report = analyze(load_records(args.paths))
    print(json.dumps(report, indent=1) if args.as_json else render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
