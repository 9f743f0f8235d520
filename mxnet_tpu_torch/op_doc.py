"""Generated operator documentation of the port (counterpart of
``mxnet_tpu/op_doc.py``; reference: python/mxnet/symbol_doc.py and
ndarray_doc.py, which attach doc text built from the registry's
metadata to the generated op functions).

``build_doc`` renders an op's registry metadata (argument names, the
parameter table with kinds and defaults, aliases, output names and the
forward's own docstring) into a docstring; ``attach_docs`` sets it on
every named function of a module.
"""
from __future__ import annotations

from .ops.registry import get_op


def _param_rows(op):
    rows = []
    for name, p in (op.params or {}).items():
        required = getattr(p, "required", False)
        default = getattr(p, "default", None)
        kind = getattr(p, "kind", "value")
        if kind == "<lambda>" or kind.startswith("_"):
            kind = "value"  # internal helper names aren't user documentation
        rows.append((name, kind, "required" if required else repr(default)))
    return rows


def build_doc(op_name, flavor="imperative"):
    """Render a docstring for one registered op."""
    op = get_op(op_name)
    # defaults for the non-required params are enough for arg-name lambdas
    # (e.g. Convolution's optional bias keyed on no_bias)
    partial = {k: p.default for k, p in (op.params or {}).items() if not p.required}
    try:
        args = list(op.arg_names(partial))
    except Exception:  # arg list genuinely needs a required attr
        args = ["..."]
    lines = []
    head = ("Imperative" if flavor == "imperative" else "Symbolic")
    lines.append("%s form of operator ``%s``." % (head, op_name))
    if op.alias:
        lines.append("")
        lines.append("Aliases: %s" % ", ".join(op.alias))
    lines.append("")
    lines.append("Inputs: %s" % ", ".join(args))
    rows = _param_rows(op)
    if rows:
        lines.append("")
        lines.append("Parameters")
        lines.append("----------")
        for name, kind, default in rows:
            lines.append("%s : %s (%s)" % (name, kind, default))
    try:
        outs = op.output_names(partial)
        if outs and list(outs) != ["output"]:
            lines.append("")
            lines.append("Outputs: %s" % ", ".join(outs))
    except Exception:  # fwlint: disable=swallowed-exception — best-effort
        pass  # doc probe: a custom op's output_names may need real args
    if getattr(op.forward, "__doc__", None):
        lines.append("")
        lines.append(op.forward.__doc__.strip())
    return "\n".join(lines)


def attach_docs(module, names, flavor):
    """Attach generated docstrings to the op functions in ``module``."""
    import logging

    for name in names:
        fn = getattr(module, name, None)
        if fn is None:
            continue
        try:
            fn.__doc__ = build_doc(name, flavor)
        except Exception as e:  # registry metadata bug — surface, don't hide
            logging.warning("op_doc: failed to build doc for %s: %s", name, e)
