"""Render the port's operator index, ``mxnet_tpu_torch/docs/operators.md``:
every registered operator with its inputs, parameters and aliases (the
port's counterpart of ``tools/gen_op_docs.py``, over the port's registry,
``mxnet_tpu_torch/ops/registry.py``).

Run: ``python -m mxnet_tpu_torch.tools.gen_op_docs [--out PATH]
[--device cpu]`` (rewrites ``mxnet_tpu_torch/docs/operators.md`` unless
``--out`` names another file). It never writes the JAX package's
``docs/operators.md``.
"""
from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import sys

from . import _device

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "operators.md")


def render(registry):
    """The index's text from a registry's ``_OP_REGISTRY`` (any module
    with the JAX package's registry interface), and its canonical op
    count."""
    seen = {}
    aliases = collections.defaultdict(list)
    for name, op in sorted(registry._OP_REGISTRY.items()):
        if op.name in seen:
            if name != op.name:
                aliases[op.name].append(name)
            continue
        seen[op.name] = op
        if name != op.name:
            aliases[op.name].append(name)

    by_module = collections.defaultdict(list)
    for name, op in seen.items():
        mod = inspect.getmodule(op.forward)
        modname = (mod.__name__.rsplit(".", 1)[-1] if mod else "?")
        by_module[modname].append((name, op))

    out = ["# Operator index",
           "",
           "Generated by `python -m mxnet_tpu_torch.tools.gen_op_docs` — %d "
           "canonical ops "
           "(%d names including aliases). Each op is callable as "
           "`mx.nd.<name>` and `mx.sym.<name>`; `_contrib_X` ops also as "
           "`mx.nd.contrib.X`. Full per-op parameter docs: `help(mx.nd.<name>)`."
           % (len(seen), len(registry._OP_REGISTRY)),
           ""]
    for modname in sorted(by_module):
        out.append("## %s" % modname)
        out.append("")
        out.append("| Op | Inputs | Parameters | Aliases |")
        out.append("|---|---|---|---|")
        for name, op in sorted(by_module[modname]):
            try:
                args = ", ".join(op.arg_names({}))
            except Exception:  # an op whose inputs follow its attributes
                args = "(attr-dependent)"
            params = ", ".join(op.params) if op.params else ""
            al = ", ".join(sorted(aliases.get(name, [])))
            out.append("| `%s` | %s | %s | %s |" % (name, args, params, al))
        out.append("")
    return "\n".join(out), len(seen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    dev = _device.resolve(a.device)
    import mxnet_tpu_torch  # noqa: F401  (registers every op)
    from ..ops import registry

    text, n = render(registry)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(text)
    print(json.dumps(dict({"tool": "gen_op_docs", "out": a.out, "ops": n,
                           "names": len(registry._OP_REGISTRY)},
                          **_device.fields(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
