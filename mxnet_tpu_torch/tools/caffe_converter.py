"""The Caffe layer mapping of the port: the prototxt text-format parser
and the layer-to-symbol conversion behind ``mx.contrib.caffe.CaffeOp``
(the port's own copy of the converter's ``parse_prototxt``,
``_get_layers``, ``_bn_scale_map``, ``expand_layers`` and
``_convert_layer`` in ``tools/caffe_converter.py``; reference:
tools/caffe_converter/ and plugin/caffe).

It builds symbols through the package it is handed (``mx``), so the
symbols, their argument names and their JSON are the converter's. The
weight-file decoder and the command line stay with the repository's
converter: a port symbol file loads in either package.
"""
from __future__ import annotations

import re

_TOKEN = re.compile(
    r"""\s*(?:(?P<comment>\#[^\n]*)
            |(?P<brace>[{}])
            |(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)?
            |(?P<string>"(?:[^"\\]|\\.)*")
            |(?P<scalar>[^\s{}:#]+))""",
    re.VERBOSE,
)


def _tokenize(text):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            rest = text[pos:].strip()
            if rest:  # never truncate silently — a partial parse would
                # convert to a silently-wrong (shorter) network
                raise ValueError("prototxt: cannot tokenize at %r"
                                 % (rest[:40],))
            return
        pos = m.end()
        if m.group("comment"):
            continue
        yield m


def _coerce(tok):
    s = tok.strip()
    if s.startswith('"'):
        if len(s) < 2 or not s.endswith('"'):
            raise ValueError("prototxt: unterminated string %r" % (s[:40],))
        return s[1:-1]
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s  # enum name


def parse_prototxt(text):
    """Parse protobuf text format into nested dicts; repeated fields become
    lists (every field is stored as a list — callers use _one()/_all())."""
    root = {}
    stack = [root]
    pending = None  # field name waiting for a value or a '{'
    for m in _tokenize(text):
        if m.group("comment"):
            continue
        if m.group("brace"):
            if m.group("brace") == "{":
                if pending is None:
                    raise ValueError("prototxt: '{' without a field name")
                child = {}
                stack[-1].setdefault(pending, []).append(child)
                stack.append(child)
                pending = None
            else:
                if pending is not None:
                    raise ValueError(
                        "prototxt: dangling field %r" % (pending,))
                stack.pop()
                if not stack:
                    raise ValueError("prototxt: unbalanced '}'")
        elif m.group("name"):
            if pending is None:
                # a field name — with ':' for scalars, bare before '{'
                pending = m.group("name")
            elif not m.group("colon"):
                # a bare word VALUE (enum name or true/false)
                stack[-1].setdefault(pending, []).append(
                    _coerce(m.group("name")))
                pending = None
            else:
                raise ValueError("prototxt: dangling field %r" % (pending,))
        else:
            value = m.group("string") or m.group("scalar")
            if pending is None:
                raise ValueError("prototxt: value without a field name")
            stack[-1].setdefault(pending, []).append(_coerce(value))
            pending = None
    if len(stack) != 1:
        raise ValueError("prototxt: unbalanced '{'")
    return root


def _one(msg, key, default=None):
    v = msg.get(key)
    return v[0] if v else default


def _all(msg, key):
    return msg.get(key, [])


V1_ENUM_NAMES = {
    "CONCAT": "Concat", "CONVOLUTION": "Convolution", "DATA": "Data",
    "DROPOUT": "Dropout", "FLATTEN": "Flatten", "INNER_PRODUCT":
    "InnerProduct", "LRN": "LRN", "POOLING": "Pooling", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "SOFTMAX": "Softmax", "SOFTMAX_LOSS":
    "SoftmaxWithLoss", "SPLIT": "Split", "TANH": "TanH", "ELTWISE":
    "Eltwise", "ABSVAL": "AbsVal", "DECONVOLUTION": "Deconvolution",
    "POWER": "Power",
}


_DATA_LAYER_TYPES = {"Data", "ImageData", "HDF5Data", "MemoryData",
                     "WindowData", "DummyData", "Input", "Annotated"}


def _xy(param, base, default=None):
    """Caffe's kernel_size/kernel_h/kernel_w convention -> (h, w)."""
    v = _one(param, base + "_size", _one(param, base))
    if v is not None:
        return (int(v), int(v))
    h = _one(param, base + "_h")
    w = _one(param, base + "_w")
    if h is not None or w is not None:
        return (int(h or 0), int(w or 0))
    return default


def _get_layers(net):
    layers = _all(net, "layer") + _all(net, "layers")
    out = []
    for l in layers:
        ltype = _one(l, "type", "")
        if isinstance(ltype, str) and ltype in V1_ENUM_NAMES:
            ltype = V1_ENUM_NAMES[ltype]
        phases = [_one(r, "phase") for r in _all(l, "include")]
        if phases and all(str(p).upper() == "TEST" for p in phases):
            continue  # TEST-only layers are accuracy/eval heads
        out.append((ltype, l))
    return out


def _bn_scale_map(layers):
    """Scale-layer name -> the BatchNorm layer it folds into (caffe couples
    BatchNorm [stats] + Scale [affine]).

    Pairing is by dataflow, not prototxt order: the Scale's bottom must be
    the tensor the BatchNorm produced, threaded only through layers that are
    identity at inference (Split, deploy-time Dropout). An intervening ReLU
    (or any other real op) breaks the pairing — folding the affine through
    it would change semantics (caffe applies Scale after the activation)."""
    m = {}
    bn_tensors = {}  # tensor name -> BatchNorm layer whose raw output it is
    for ltype, l in layers:
        name = _one(l, "name", "")
        bottoms, tops = _all(l, "bottom"), _all(l, "top")
        if ltype == "BatchNorm":
            for t in (tops or [name]):
                bn_tensors[t] = name
            continue
        if ltype == "Scale":
            if bottoms and bottoms[0] in bn_tensors:
                # pop: a BN output can absorb at most one affine
                m[name] = bn_tensors.pop(bottoms[0])
            continue
        if ltype in ("Split", "Dropout") and bottoms \
                and bottoms[0] in bn_tensors:
            # identity at inference: every top is still the BN's raw output
            bn = bn_tensors[bottoms[0]]
            for t in tops:
                bn_tensors[t] = bn
            continue
        # a real op: any tensor it writes (in-place included) is no longer
        # a raw BN output
        for t in tops:
            bn_tensors.pop(t, None)
    return m


def expand_layers(mx, prototxt_text, inputs, name_prefix=None):
    """PUBLIC: expand a prototxt snippet into a native subgraph fed by
    existing symbols — the engine behind ``mx.contrib.caffe.CaffeOp`` (the
    runtime analog of the reference's plugin/caffe). ``inputs`` bind to the
    first layer's bottoms positionally; later layers chain by blob name.
    Raises on data layers, unknown ops, and unresolved bottoms — the same
    no-silently-wrong-network rules as the offline converter."""
    if not inputs:
        raise ValueError("expand_layers needs at least one input symbol")
    net = parse_prototxt(prototxt_text)
    layers = _get_layers(net)
    if not layers:
        raise ValueError("prototxt contains no layers")
    for ltype, _ in layers:
        if ltype in _DATA_LAYER_TYPES:
            raise ValueError(
                "data layers are not allowed here — pass inputs as symbols")

    scale_to_bn = _bn_scale_map(layers)
    blobs = {}
    first_bottoms = _all(layers[0][1], "bottom") or ["data"]
    for i, sym in enumerate(inputs):
        key = first_bottoms[i] if i < len(first_bottoms) else "_in%d" % i
        blobs[key] = sym

    out = None
    prev_top = first_bottoms[0] if first_bottoms else None
    for idx, (ltype, l) in enumerate(layers):
        lname = _one(l, "name", "") or "%s_l%d" % (name_prefix or "caffe",
                                                   idx)
        if name_prefix:
            lname = "%s_%s" % (name_prefix, lname)
        declared = _all(l, "bottom")
        if not declared and prev_top is not None:
            declared = [prev_top]
        missing = [b for b in declared if b not in blobs]
        sheddable = "Loss" in ltype or ltype == "Accuracy"
        bad = [b for b in missing
               if not (sheddable and declared and b != declared[0])]
        if bad:
            raise ValueError(
                "layer %r consumes blob(s) %r that no input or earlier "
                "layer produces" % (lname, bad))
        bottoms = [blobs[b] for b in declared if b in blobs]
        if ltype == "Scale" and _one(l, "name", "") not in scale_to_bn:
            raise ValueError(
                "standalone Scale layer %r is not supported" % (lname,))
        converted = _convert_layer(mx, ltype, l, lname, bottoms)
        if converted is None:  # folded (Scale into BN) or eval-only layer
            continue
        out = converted
        tops = _all(l, "top") or [_one(l, "name", "")]
        for t in tops:
            blobs[t] = out
        prev_top = tops[0]
    if out is None:
        raise ValueError("no layer produced an output")
    return out


def _convert_layer(mx, ltype, l, name, bottoms):
    """One caffe layer -> one symbol (or None to skip). Raises on unknown
    types — silent drops would produce silently-wrong networks."""
    s = bottoms[0] if bottoms else None
    if ltype == "Convolution" or ltype == "Deconvolution":
        p = _one(l, "convolution_param", {})
        kernel = _xy(p, "kernel")
        stride = _xy(p, "stride", (1, 1))
        pad = _xy(p, "pad", (0, 0))
        dilate = _xy(p, "dilation", (1, 1))
        kwargs = dict(kernel=kernel, stride=stride, pad=pad,
                      num_filter=int(_one(p, "num_output")),
                      num_group=int(_one(p, "group", 1)),
                      no_bias=not _one(p, "bias_term", True), name=name)
        if ltype == "Convolution":
            kwargs["dilate"] = dilate
            return mx.sym.Convolution(s, **kwargs)
        return mx.sym.Deconvolution(s, **kwargs)
    if ltype == "InnerProduct":
        p = _one(l, "inner_product_param", {})
        return mx.sym.FullyConnected(
            s, num_hidden=int(_one(p, "num_output")),
            no_bias=not _one(p, "bias_term", True), name=name)
    if ltype == "Pooling":
        p = _one(l, "pooling_param", {})
        pool = _one(p, "pool", "MAX")
        pool_type = {0: "max", 1: "avg", "MAX": "max", "AVE": "avg"}.get(pool)
        if pool_type is None:  # STOCHASTIC (2) has no analog here
            raise ValueError("pooling mode %r not supported" % (pool,))
        if _one(p, "global_pooling", False):
            return mx.sym.Pooling(s, kernel=(1, 1), global_pool=True,
                                  pool_type=pool_type, name=name)
        return mx.sym.Pooling(
            s, kernel=_xy(p, "kernel"), stride=_xy(p, "stride", (1, 1)),
            pad=_xy(p, "pad", (0, 0)), pool_type=pool_type,
            pooling_convention="full", name=name)  # caffe ceils output dims
    if ltype == "ReLU":
        p = _one(l, "relu_param", {})
        slope = float(_one(p, "negative_slope", 0.0))
        if slope:
            return mx.sym.LeakyReLU(s, act_type="leaky", slope=slope,
                                    name=name)
        return mx.sym.Activation(s, act_type="relu", name=name)
    if ltype == "TanH":
        return mx.sym.Activation(s, act_type="tanh", name=name)
    if ltype == "Sigmoid":
        return mx.sym.Activation(s, act_type="sigmoid", name=name)
    if ltype == "PReLU":
        return mx.sym.LeakyReLU(s, act_type="prelu", name=name)
    if ltype == "LRN":
        p = _one(l, "lrn_param", {})
        region = _one(p, "norm_region", "ACROSS_CHANNELS")
        if region not in ("ACROSS_CHANNELS", 0):
            raise ValueError(
                "LRN %r: norm_region %r not supported (across-channel only)"
                % (name, region))
        return mx.sym.LRN(s, alpha=float(_one(p, "alpha", 1.0)),
                          beta=float(_one(p, "beta", 0.75)),
                          knorm=float(_one(p, "k", 1.0)),
                          nsize=int(_one(p, "local_size", 5)), name=name)
    if ltype == "Dropout":
        p = _one(l, "dropout_param", {})
        return mx.sym.Dropout(s, p=float(_one(p, "dropout_ratio", 0.5)),
                              name=name)
    if ltype in ("Softmax", "SoftmaxWithLoss"):
        # caffe softmaxes over axis 1 (channels); multi_output is that
        # semantic for >2-D inputs and identical to the default for 2-D
        return mx.sym.SoftmaxOutput(s, multi_output=True, name=name)
    if ltype == "Flatten":
        return mx.sym.Flatten(s, name=name)
    if ltype == "Split":
        return s  # fan-out is implicit in a dataflow graph
    if ltype == "Concat":
        p = _one(l, "concat_param", {})
        dim = int(_one(p, "axis", _one(p, "concat_dim", 1)))
        return mx.sym.Concat(*bottoms, dim=dim, name=name)
    if ltype == "Eltwise":
        p = _one(l, "eltwise_param", {})
        op = _one(p, "operation", "SUM")
        coeff = [float(c) for c in _all(p, "coeff")]
        if coeff and len(coeff) != len(bottoms):
            raise ValueError(
                "Eltwise %r: %d coeffs for %d inputs"
                % (name, len(coeff), len(bottoms)))
        if op in ("SUM", 1, "sum"):
            if coeff and any(c != 1.0 for c in coeff):
                acc = bottoms[0] * coeff[0]
                for b, c in zip(bottoms[1:], coeff[1:]):
                    acc = acc + b * c
                return acc
            acc = bottoms[0]
            for b in bottoms[1:]:
                acc = acc + b
            return acc
        if op in ("PROD", 0, "prod"):
            acc = bottoms[0]
            for b in bottoms[1:]:
                acc = acc * b
            return acc
        if op in ("MAX", 2, "max"):
            acc = bottoms[0]
            for b in bottoms[1:]:
                acc = mx.sym.maximum(acc, b)
            return acc
        raise ValueError("Eltwise operation %r not supported" % (op,))
    if ltype == "BatchNorm":
        p = _one(l, "batch_norm_param", {})
        eps = float(_one(p, "eps", 1e-5))
        use_global = bool(_one(p, "use_global_stats", True))
        # fix_gamma unless a Scale layer follows (caffe splits affine out)
        return mx.sym.BatchNorm(s, eps=eps, use_global_stats=use_global,
                                fix_gamma=False, name=name)
    if ltype == "Scale":
        # caffe idiom: BatchNorm (stats) + Scale (affine). The BatchNorm
        # symbol above already carries gamma/beta, so Scale folds into it —
        # convert_model maps the Scale blobs onto the BN arg names.
        return s
    if ltype == "Reshape":
        p = _one(l, "reshape_param", {})
        shape_msg = _one(p, "shape", {})
        dims = tuple(int(d) for d in _all(shape_msg, "dim"))
        return mx.sym.Reshape(s, shape=dims, name=name)
    if ltype == "Crop":
        p = _one(l, "crop_param", {})
        axis = int(_one(p, "axis", 2))
        offsets = [int(o) for o in _all(p, "offset")]
        if axis != 2:
            raise ValueError(
                "Crop %r: axis=%d not supported (only spatial axis 2)"
                % (name, axis))
        if len(offsets) == 1:
            offsets = offsets * 2  # caffe: one offset applies to all axes
        return mx.sym.Crop(*bottoms, num_args=len(bottoms),
                           offset=tuple(offsets) if offsets else (0, 0),
                           name=name)
    if ltype == "AbsVal":
        return mx.sym.abs(s, name=name)
    if ltype == "Power":
        p = _one(l, "power_param", {})
        power = float(_one(p, "power", 1.0))
        scale = float(_one(p, "scale", 1.0))
        shift = float(_one(p, "shift", 0.0))
        out = s * scale + shift if (scale != 1.0 or shift != 0.0) else s
        if power != 1.0:
            out = out ** power
        return out
    if ltype in ("Accuracy", "Silence"):
        return None
    raise ValueError("caffe layer type %r is not supported" % (ltype,))
