"""Render the port's Python API reference,
``mxnet_tpu_torch/docs/api_python.md``: every public class (with method
signatures) and function of the user-facing modules, by introspection
(the port's counterpart of ``tools/gen_api_docs.py``, over the same list
of modules in the same order).

Run: ``python -m mxnet_tpu_torch.tools.gen_api_docs [--out PATH]
[--device cpu]``.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import sys

from . import _device

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "api_python.md")

# (title, module path, note) — the JAX tool's list and order
MODULES = [
    ("NDArray", "mxnet_tpu_torch.ndarray",
     "imperative tensors; generated op functions are indexed separately in "
     "[operators.md](operators.md)"),
    ("Symbol", "mxnet_tpu_torch.symbol", "declarative graphs"),
    ("Executor", "mxnet_tpu_torch.executor", None),
    ("Module", "mxnet_tpu_torch.module", "the training lifecycle"),
    ("Executor manager (pre-Module DP)", "mxnet_tpu_torch.executor_manager",
     None),
    ("Model / checkpoints", "mxnet_tpu_torch.model", None),
    ("IO", "mxnet_tpu_torch.io", None),
    ("Image", "mxnet_tpu_torch.image", None),
    ("Detection augmenters", "mxnet_tpu_torch.image_det", None),
    ("ImageRecordIter", "mxnet_tpu_torch.io_image", None),
    ("RecordIO", "mxnet_tpu_torch.recordio", None),
    ("KVStore", "mxnet_tpu_torch.kvstore", None),
    ("Optimizer", "mxnet_tpu_torch.optimizer", None),
    ("LR schedulers", "mxnet_tpu_torch.lr_scheduler", None),
    ("Metric", "mxnet_tpu_torch.metric", None),
    ("Initializer", "mxnet_tpu_torch.initializer", None),
    ("RNN cells", "mxnet_tpu_torch.rnn.rnn_cell", None),
    ("RNN IO", "mxnet_tpu_torch.rnn.io", None),
    ("Callback", "mxnet_tpu_torch.callback", None),
    ("Monitor", "mxnet_tpu_torch.monitor", None),
    ("Context", "mxnet_tpu_torch.context", None),
    ("Random", "mxnet_tpu_torch.random", None),
    ("Autograd (contrib)", "mxnet_tpu_torch.contrib.autograd", None),
    ("Custom operators", "mxnet_tpu_torch.operator", None),
    ("Profiler", "mxnet_tpu_torch.profiler", None),
    ("Telemetry", "mxnet_tpu_torch.telemetry",
     "metrics registry + spans + training events"),
    ("Compile observability", "mxnet_tpu_torch.compileobs",
     "program registry: CUDA-graph captures, nvcc builds and first runs at "
     "a new signature, recompile attribution, device-memory gauges, OOM "
     "forensics"),
    ("Graph passes", "mxnet_tpu_torch.graphpass",
     "Symbol-level optimization pipeline: canonicalize / constant fold / "
     "CSE / fusion grouping / shape bucketing"),
    ("Compile cache", "mxnet_tpu_torch.compile_cache",
     "persistent cross-process compile cache over the nvcc kernel "
     "libraries: hit/miss accounting, corrupt artifacts rebuilt"),
    ("Training health guard", "mxnet_tpu_torch.guard",
     "NaN/stall sentinel, skip/rollback/abort policy ladder, exact "
     "mid-epoch resume"),
    ("Elastic training", "mxnet_tpu_torch.elastic",
     "membership epochs, survivor reconfiguration, worker rejoin"),
    ("Static analysis", "mxnet_tpu_torch.analysis",
     "fwlint invariant checkers + baseline ratchet"),
    ("Engine dependency sanitizer", "mxnet_tpu_torch.analysis.sanitizer",
     "runtime check of engine push declarations "
     "(`MXNET_ENGINE_SANITIZER`)"),
    ("Serving", "mxnet_tpu_torch.serving",
     "paged-KV continuous-batching inference engine"),
    ("RTC", "mxnet_tpu_torch.rtc", None),
    ("Visualization", "mxnet_tpu_torch.visualization", None),
    ("Parallel (mesh over CUDA positions)", "mxnet_tpu_torch.parallel",
     "a mesh is positions under one controller; without a device list they "
     "fill the cards and repeat them (one card: cuda:0 at every position)"),
    ("Model zoo", "mxnet_tpu_torch.models", None),
    ("AOT export", "mxnet_tpu_torch.export_artifact", None),
]


def first_line(obj):
    """First sentence of the first docstring paragraph (not cut inside
    (...) or ``...``)."""
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    para = doc.strip().split("\n\n")[0]
    text = " ".join(line.strip() for line in para.splitlines())
    depth = 0
    ticks = 0
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == "`":
            ticks += 1
        elif (ch == "." and depth == 0 and ticks % 2 == 0
              and (i + 1 == len(text) or text[i + 1] == " ")):
            return text[: i + 1]
    return text


def sig(obj):
    """``obj``'s signature with the reprs that differ between processes
    (addresses, module file paths, class reprs) normalized."""
    try:
        s = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    s = re.sub(r" at 0x[0-9a-f]+", "", s)
    s = re.sub(r"<module '([^']+)' from '[^']+'>", r"<module \1>", s)
    s = re.sub(r"<class '([^']+)'>", r"<class \1>", s)
    return s


def public_members(mod, owner="mxnet_tpu_torch"):
    """(classes, functions) a module makes public: ``__all__`` or its
    names without a leading underscore, less re-exported modules and
    members of other packages than ``owner``."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in sorted(vars(mod)) if not n.startswith("_")]
    classes, functions = [], []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        mod_of = getattr(obj, "__module__", None)
        if mod_of is not None and not (str(mod_of) == owner or
                                       str(mod_of).startswith(owner + ".")):
            continue
        if inspect.isclass(obj):
            classes.append((n, obj))
        elif callable(obj):
            functions.append((n, obj))
    return classes, functions


def class_methods(cls):
    out = []
    for n, m in sorted(vars(cls).items()):
        if n.startswith("_") and n != "__init__":
            continue
        if isinstance(m, (staticmethod, classmethod)):
            m = m.__func__
        elif isinstance(m, property):
            out.append((n, "(property)", first_line(m.fget)))
            continue
        if not callable(m):
            continue
        out.append((n, sig(m), first_line(m)))
    return out


def api_of(path, owner="mxnet_tpu_torch"):
    """``{name: signature}`` of a module's public functions and
    ``{class: {method: signature}}`` of its classes."""
    mod = importlib.import_module(path)
    classes, functions = public_members(mod, owner)
    return ({n: sig(fn) for n, fn in functions},
            {n: {mn: ms for mn, ms, _ in class_methods(c)} for n, c in classes})


def render():
    lines = [
        "# Python API reference (the PyTorch/CUDA port)",
        "",
        "Generated by `python -m mxnet_tpu_torch.tools.gen_api_docs` from the "
        "code — do not edit. Per-operator docs: [operators.md](operators.md).",
        "",
    ]
    for title, path, note in MODULES:
        mod = importlib.import_module(path)
        lines.append("## %s (`%s`)" % (title, path))
        lines.append("")
        intro = first_line(mod)
        if intro:
            lines.append(intro)
        if note:
            lines.append("")
            lines.append("*%s*" % note)
        lines.append("")
        classes, functions = public_members(mod)
        for n, cls in classes:
            bases = ", ".join(b.__name__ for b in cls.__bases__
                              if b is not object)
            head = "### class `%s`" % n
            if bases:
                head += " *(%s)*" % bases
            lines.append(head)
            fl = first_line(cls)
            if fl:
                lines.append("")
                lines.append(fl)
            lines.append("")
            meths = class_methods(cls)
            if meths:
                lines.append("| method | signature | |")
                lines.append("|---|---|---|")
                for mn, ms, md in meths:
                    lines.append("| `%s` | `%s` | %s |"
                                 % (mn, ms.replace("|", "\\|"),
                                    md.replace("|", "\\|")))
                lines.append("")
        if functions:
            lines.append("### functions")
            lines.append("")
            lines.append("| function | signature | |")
            lines.append("|---|---|---|")
            for n, fn in functions:
                lines.append("| `%s` | `%s` | %s |"
                             % (n, sig(fn).replace("|", "\\|"),
                                first_line(fn).replace("|", "\\|")))
            lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    dev = _device.resolve(a.device)
    text = render()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(text)
    print(json.dumps(dict({"tool": "gen_api_docs", "out": a.out,
                           "modules": len(MODULES),
                           "lines": text.count("\n")},
                          **_device.fields(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
