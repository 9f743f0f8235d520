"""Baseline ratchet — freeze existing debt, fail only on new findings (the
port's copy of ``mxnet_tpu/analysis/baseline.py``).

The committed baseline (``mxnet_tpu_torch/analysis/fwlint_baseline.json``,
the same JSON shape as the JAX package's) maps each finding's
drift-stable fingerprint to a human-readable record. CI re-lints and fails
iff a fingerprint appears that the baseline does not carry; paying debt
down only ever shrinks the file (``python -m mxnet_tpu_torch.tools.fwlint --update-baseline``).
"""
from __future__ import annotations

import json

__all__ = ["load", "save", "diff"]

_VERSION = 1


def load(path):
    """Read a baseline file into ``{fingerprint: record}`` (missing file →
    empty baseline, so bootstrapping is just running with ``--update``)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {}
    if doc.get("version") != _VERSION:
        raise ValueError("unsupported fwlint baseline version %r in %s"
                         % (doc.get("version"), path))
    return doc.get("findings", {})


def save(path, findings):
    """Write ``findings`` as the new baseline (sorted keys → stable diffs)."""
    recs = {}
    for f in findings:
        recs[f.fingerprint] = {"rule": f.rule, "path": f.path,
                               "line": f.line, "context": f.context,
                               "text": f.text}
    doc = {"version": _VERSION,
           "comment": "fwlint debt freeze — regenerate with "
                      "`python -m mxnet_tpu_torch.tools.fwlint "
                      "--baseline <this file> --update-baseline`; "
                      "this file must only ever shrink",
           "findings": {k: recs[k] for k in sorted(recs)}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def diff(findings, baseline):
    """Split ``findings`` against ``baseline`` → ``(new, known, stale)``."""
    new, known = [], []
    live = set()
    for f in findings:
        live.add(f.fingerprint)
        (known if f.fingerprint in baseline else new).append(f)
    stale = sorted(set(baseline) - live)
    return new, known, stale
