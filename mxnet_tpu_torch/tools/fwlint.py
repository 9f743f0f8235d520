"""fwlint CLI — the port's framework-invariant analyzer (the twin of the
JAX package's ``tools/fwlint.py``).

Lints ``mxnet_tpu_torch/`` + ``chip_smoke.py`` against the checkers in
``mxnet_tpu_torch/analysis/checkers.py`` and ratchets on a committed
baseline: existing debt is frozen in
``mxnet_tpu_torch/analysis/fwlint_baseline.json`` and the run fails only
when a NEW violation appears. Paying debt down shrinks the baseline via
``--update-baseline`` (the file must only ever shrink).

    python -m mxnet_tpu_torch.tools.fwlint \
        --baseline mxnet_tpu_torch/analysis/fwlint_baseline.json   # gate
    python -m mxnet_tpu_torch.tools.fwlint mxnet_tpu_torch/engine.py
    python -m mxnet_tpu_torch.tools.fwlint --list-rules

Loads the analysis package standalone (stdlib-only), so linting never pays
the torch/numpy import cost of the framework proper (the package's
``__init__`` imports nothing while this module is located with ``-m``).
"""
import argparse
import importlib.util
import json
import os
import sys
from collections import Counter

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_PATHS = ("mxnet_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = os.path.join("mxnet_tpu_torch", "analysis",
                                "fwlint_baseline.json")


def _load_analysis():
    """Import mxnet_tpu_torch.analysis WITHOUT importing the rest of
    mxnet_tpu_torch (whose __init__ pulls torch and the whole runtime)."""
    if "mxnet_tpu_torch.analysis" in sys.modules:
        return sys.modules["mxnet_tpu_torch.analysis"]
    pkgdir = os.path.join(ROOT, "mxnet_tpu_torch", "analysis")
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_torch.analysis", os.path.join(pkgdir, "__init__.py"),
        submodule_search_locations=[pkgdir])
    mod = importlib.util.module_from_spec(spec)
    # parent entry so the package's relative imports resolve; a later real
    # `import mxnet_tpu_torch` wins because it replaces the sys.modules entry
    sys.modules.setdefault("mxnet_tpu_torch.analysis", mod)
    spec.loader.exec_module(mod)
    return sys.modules["mxnet_tpu_torch.analysis"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fwlint", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs relative to the repo root "
                         "(default: %s)" % " ".join(DEFAULT_PATHS))
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON; findings it carries are frozen "
                         "debt, only new ones fail the run")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings "
                         "(requires --baseline) and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="ALSO write the machine-readable report to PATH "
                         "(the CI artifact) while printing the normal "
                         "table")
    ap.add_argument("--dump-lock-graph", action="store_true",
                    help="print the whole-repo lock-acquisition graph as "
                         "DOT (cycle nodes/edges in red) and exit")
    ap.add_argument("--dump-thread-roots", action="store_true",
                    help="print the inferred thread roots and the function "
                         "set reachable from each, then exit")
    ap.add_argument("--explain", default=None, metavar="FINGERPRINT",
                    help="print the dataflow chain behind one finding "
                         "(fingerprint prefix accepted; lints the default "
                         "scope to locate it)")
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    analysis = _load_analysis()
    if args.list_rules:
        for r in analysis.RULES:
            print(r)
        return 0

    if args.dump_lock_graph:
        import importlib

        lockgraph = importlib.import_module(
            "mxnet_tpu_torch.analysis.lockgraph")
        paths = args.paths or list(DEFAULT_PATHS)
        try:
            ctxs, _errs = analysis.fwlint.load_contexts(paths, args.root)
        except FileNotFoundError as err:
            print(err, file=sys.stderr)
            return 2
        graph = lockgraph.build(ctxs)
        print(graph.to_dot())
        cycles = graph.cycles()
        if cycles:
            print("// %d cycle(s): %s" % (len(cycles), cycles),
                  file=sys.stderr)
            return 1
        return 0

    if args.dump_thread_roots:
        import importlib

        concurrency = importlib.import_module(
            "mxnet_tpu_torch.analysis.concurrency")
        paths = args.paths or list(DEFAULT_PATHS)
        try:
            ctxs, _errs = analysis.fwlint.load_contexts(paths, args.root)
        except FileNotFoundError as err:
            print(err, file=sys.stderr)
            return 2
        print(concurrency.build_model(ctxs).dump_roots())
        return 0

    select = ([r.strip() for r in args.select.split(",") if r.strip()]
              if args.select else None)
    if select:
        unknown = [r for r in select if r not in analysis.RULES]
        if unknown:
            print("fwlint: unknown rule(s): %s" % ", ".join(unknown),
                  file=sys.stderr)
            return 2
    paths = args.paths or list(DEFAULT_PATHS)
    try:
        new, known, stale = analysis.run_lint(
            paths, root=args.root, select=select, baseline_path=args.baseline)
    except FileNotFoundError as err:
        print(err, file=sys.stderr)
        return 2

    # the artifact is written for EVERY successful lint, including the
    # --explain and --update-baseline paths (their early returns must not
    # silently drop a CI step's --json-out)
    report = {"new": [f.as_dict() for f in new],
              "baselined": [f.as_dict() for f in known],
              "stale": stale}
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")

    if args.explain:
        want = args.explain.strip()
        hits = [f for f in new + known
                if f.fingerprint and f.fingerprint.startswith(want)]
        if not hits:
            print("fwlint: no current finding matches fingerprint %r "
                  "(suppressed findings carry no fingerprint)" % want,
                  file=sys.stderr)
            return 2
        for f in hits:
            print("%s:%d: [%s] %s" % (f.path, f.line, f.rule, f.message))
            print("  fingerprint: %s%s"
                  % (f.fingerprint,
                     "  (baselined)" if f in known else "  (NEW)"))
            if f.chain:
                print("  taint chain:")
                for stepline in f.chain:
                    print("    %s" % stepline)
            else:
                print("  no dataflow chain (syntactic finding)")
        return 0

    if args.update_baseline:
        if not args.baseline:
            print("fwlint: --update-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        if select or args.paths:
            # a partial run (--select / explicit paths) sees only a subset
            # of the findings — rewriting from it would silently drop every
            # frozen entry outside the subset and turn the next full CI run
            # red repo-wide
            print("fwlint: refusing --update-baseline for a partial run "
                  "(drop --select and path arguments so the baseline is "
                  "rebuilt from the full default scope)", file=sys.stderr)
            return 2
        # importlib, not `from mxnet_tpu_torch.analysis.baseline import
        # ...`: the absolute from-import would resolve through the REAL
        # package (torch and all) whenever the submodule is not cached
        import importlib

        _baseline = importlib.import_module(
            "mxnet_tpu_torch.analysis.baseline")
        _baseline.save(args.baseline if os.path.isabs(args.baseline)
                       else os.path.join(args.root, args.baseline),
                       new + known)
        print("fwlint: baseline %s <- %d findings"
              % (args.baseline, len(new) + len(known)))
        return 0

    if args.as_json:
        print(json.dumps(report, indent=1))
        return 1 if new else 0

    # per-rule counts: the at-a-glance debt table CI prints on every run
    totals = Counter(f.rule for f in new + known)
    news = Counter(f.rule for f in new)
    if totals:
        width = max(len(r) for r in totals)
        print("%-*s  %5s  %9s  %3s" % (width, "rule", "total", "baselined",
                                       "new"))
        for rule in sorted(totals):
            print("%-*s  %5d  %9d  %3d"
                  % (width, rule, totals[rule],
                     totals[rule] - news[rule], news[rule]))
    for f in sorted(new, key=lambda f: (f.path, f.line)):
        print("NEW %s:%d: [%s] %s" % (f.path, f.line, f.rule, f.message))
    if stale:
        print("fwlint: %d baseline entr%s no longer fire — shrink with "
              "--update-baseline" % (len(stale),
                                     "y" if len(stale) == 1 else "ies"))
    if new:
        print("fwlint: %d new violation%s (baseline froze %d)"
              % (len(new), "" if len(new) == 1 else "s", len(known)))
        return 1
    print("fwlint: ok — 0 new violations (%d baselined, %d files scanned "
          "under %s)" % (len(known),
                         sum(1 for _ in analysis.fwlint.iter_python_files(
                             paths, args.root)),
                         " ".join(paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
