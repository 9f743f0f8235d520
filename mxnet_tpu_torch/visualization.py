"""Network visualization of the port (counterpart of
``mxnet_tpu/visualization.py``; reference: python/mxnet/visualization.py):
``print_summary`` and ``plot_network``.

Both render from one graph view (:func:`_graph_view`) over the Symbol's
nodes; parameter counts are the sizes of each node's weight-like
arguments at their inferred shapes. ``plot_network`` needs the
``graphviz`` package and raises ``ImportError`` without it.
"""
from __future__ import annotations

from .symbol import Symbol, _topo_order

__all__ = ["print_summary", "plot_network"]

# variable-name suffixes that mean "learnable/auxiliary tensor, not data"
# (states and data-like inputs are NOT here: their shapes are batch-sized
# and must not count as parameters)
_WEIGHT_SUFFIXES = (
    "_weight", "_bias", "_gamma", "_beta", "_moving_mean", "_moving_var",
)


def _is_weight_name(name):
    return name.endswith(_WEIGHT_SUFFIXES)


class _NodeInfo:
    __slots__ = ("name", "op", "attrs", "preds", "out_shape", "param_count",
                 "is_output")

    def __init__(self, name, op, attrs):
        self.name = name
        self.op = op
        self.attrs = attrs
        self.preds = []        # visible predecessor names (non-weight)
        self.out_shape = None  # first-output shape minus batch, or None
        self.param_count = 0
        self.is_output = False


def _graph_view(symbol, shape=None):
    """List of _NodeInfo in topological order: compute nodes plus any
    variables that appear as graph outputs or data inputs.

    With ``shape`` (dict of input name -> shape), output shapes are inferred
    through ``get_internals`` and parameter counts are the summed sizes of
    each node's weight-like variable inputs — read from the inferred ARG
    shapes, so they are exact whatever the op's internal arithmetic is.
    """
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    shape_of_output = {}
    shape_of_arg = {}
    if shape is not None:
        internals = symbol.get_internals()
        arg_shapes, out_shapes, _ = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_of_output = dict(zip(internals.list_outputs(), out_shapes))
        shape_of_arg = dict(zip(internals.list_arguments(), arg_shapes or []))

    order = _topo_order(symbol._entries)
    output_ids = {id(n) for n, _ in symbol._entries}
    infos = []
    for node in order:
        # weight-like variables fold into their consumer's param count;
        # every other variable (data, labels, states) is a visible node
        if node.is_variable and not (
                id(node) in output_ids or not _is_weight_name(node.name)):
            continue
        info = _NodeInfo(node.name, node.op or "null", dict(node.attrs or {}))
        info.is_output = id(node) in output_ids
        if not node.is_variable:
            for inp, _k in node.inputs:
                if inp.is_variable:
                    if _is_weight_name(inp.name):
                        info.param_count += _size_of(
                            shape_of_arg.get(inp.name))
                    else:
                        info.preds.append(inp.name)
                else:
                    info.preds.append(inp.name)
            key = node.name + "_output"
        else:
            key = node.name
        s = shape_of_output.get(key)
        info.out_shape = tuple(s[1:]) if s else None
        infos.append(info)
    return infos


def _size_of(shape):
    if not shape:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ------------------------------------------------------------------ summary
def print_summary(symbol, shape=None, line_length=120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer table: name(type), output shape, #params, connections.

    ``positions`` are column right-edges, as fractions of ``line_length``
    (or absolute columns if > 1) — the reference's signature.
    """
    cols = [int(line_length * p) if p <= 1 else int(p) for p in positions]
    infos = _graph_view(symbol, shape)

    def emit(fields):
        line = []
        start = 0
        for text, edge in zip(fields, cols):
            cell = str(text)[: edge - start]
            line.append(cell + " " * (edge - start - len(cell)))
            start = edge
        print("".join(line))

    rule, double = "_" * line_length, "=" * line_length
    print(rule)
    emit(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print(double)
    total = 0
    for i, info in enumerate(infos):
        out = "x".join(str(d) for d in info.out_shape) if info.out_shape else ""
        first = info.preds[0] if info.preds else ""
        emit(["%s(%s)" % (info.name, info.op), out, info.param_count, first])
        for extra in info.preds[1:]:
            emit(["", "", "", extra])
        total += info.param_count
        print(double if i == len(infos) - 1 else rule)
    print("Total params: %s" % total)
    print(rule)


# ------------------------------------------------------------------ plotting
# op -> (palette color index, label function). Anything unlisted gets the
# default color with its op name as the label.
def _label_conv(a):
    k = a.get("kernel", "")
    s = a.get("stride", "") or "(1,1)"
    return "Convolution\n%s/%s, %s" % (_fmt_shape(k), _fmt_shape(s),
                                       a.get("num_filter", ""))


def _label_pool(a):
    return "Pooling\n%s, %s/%s" % (
        a.get("pool_type", "max"), _fmt_shape(a.get("kernel", "")),
        _fmt_shape(a.get("stride", "") or "(1,1)"))


def _fmt_shape(text):
    from .base import parse_shape

    try:
        dims = parse_shape(str(text))
    except Exception:  # noqa: BLE001 — attr not shape-like: show verbatim
        return str(text)
    return "x".join(str(d) for d in dims or ())


_PALETTE = ("#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3",
            "#fdb462", "#b3de69", "#fccde5")

_STYLE = {
    "null": (0, None),
    "Convolution": (1, _label_conv),
    "Deconvolution": (1, _label_conv),
    "FullyConnected": (1, lambda a: "FullyConnected\n%s" % a.get("num_hidden", "")),
    "Activation": (2, lambda a: "Activation\n%s" % a.get("act_type", "")),
    "LeakyReLU": (2, lambda a: "LeakyReLU\n%s" % a.get("act_type", "")),
    "BatchNorm": (3, None),
    "Pooling": (4, _label_pool),
    "Concat": (5, None),
    "Flatten": (5, None),
    "Reshape": (5, None),
    "Softmax": (6, None),
    "SoftmaxOutput": (6, None),
    "SoftmaxActivation": (6, None),
}
_DEFAULT_STYLE = (7, None)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz digraph of the network (edges drawn data-flow 'back' style,
    shape labels on edges when ``shape`` is given). Requires graphviz."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    # weight variables are folded away by the default view; the
    # hide_weights=False variant re-includes them (one shape inference
    # either way)
    infos = (_graph_view_all_vars(symbol, shape) if not hide_weights
             else _graph_view(symbol, shape))
    known = {i.name for i in infos}

    base_attrs = {"shape": "box", "fixedsize": "true", "width": "1.3",
                  "height": "0.8034", "style": "filled"}
    if node_attrs:
        base_attrs.update(node_attrs)
    dot = Digraph(name=title)

    shapes_by_name = {i.name: i.out_shape for i in infos}
    for info in infos:
        color_i, labeler = _STYLE.get(info.op, _DEFAULT_STYLE)
        attrs = {"shape": "box", "fixedsize": "false", "style": "filled",
                 "fillcolor": _PALETTE[color_i]}
        if info.op == "null":
            attrs["shape"] = "oval"
            label = info.name
        else:
            label = labeler(info.attrs) if labeler else info.op
        dot.node(name=info.name, label=label, **attrs)
    for info in infos:
        if info.op == "null":
            continue
        for pred in info.preds:
            if pred not in known:
                continue
            edge_attrs = {"dir": "back", "arrowtail": "open"}
            ps = shapes_by_name.get(pred)
            if shape is not None and ps:
                edge_attrs["label"] = "x".join(str(d) for d in ps)
            dot.edge(tail_name=info.name, head_name=pred, **edge_attrs)
    return dot


def _graph_view_all_vars(symbol, shape):
    """Variant of _graph_view that keeps weight variables visible (used by
    plot_network(hide_weights=False)) and routes them into preds."""
    infos = _graph_view(symbol, shape)
    by_name = {i.name: i for i in infos}
    order = _topo_order(symbol._entries)
    out = []
    for node in order:
        if node.is_variable and node.name not in by_name:
            vi = _NodeInfo(node.name, "null", dict(node.attrs or {}))
            out.append(vi)
        elif node.name in by_name:
            info = by_name[node.name]
            if not node.is_variable:
                info.preds = [inp.name for inp, _ in node.inputs]
            out.append(info)
    return out
