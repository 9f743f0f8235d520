"""The Caffe layer mapping of the port: the prototxt text-format parser
and the layer-to-symbol conversion behind ``mx.contrib.caffe.CaffeOp``
(the port's own copy of the converter's ``parse_prototxt``,
``_get_layers``, ``_bn_scale_map``, ``expand_layers`` and
``_convert_layer`` in ``tools/caffe_converter.py``; reference:
tools/caffe_converter/ and plugin/caffe).

It builds symbols through the package it is handed (``mx``), so the
symbols, their argument names and their JSON are the converter's, and a
port symbol file loads in either package. ``convert_symbol`` and
``convert_model`` (with the ``.caffemodel`` protobuf decoder) build
through the port itself; ``python -m mxnet_tpu_torch.tools.caffe_converter
deploy.prototxt [weights.caffemodel] prefix`` writes the symbol and
parameter files.
"""
from __future__ import annotations

import argparse
import re
import struct
import sys

import numpy as np

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


# ---------------------------------------------------------------------------
# protobuf wire format (.caffemodel) — schema-driven minimal decoder
# ---------------------------------------------------------------------------
# Field numbers from the reference's tools/caffe_converter/caffe.proto
# (NetParameter :64, LayerParameter :310, V1LayerParameter :1205,
# BlobProto :10, BlobShape :6).

BLOB_SHAPE = {1: ("dim", "packed_varint")}
BLOB_PROTO = {
    1: ("num", "varint"),
    2: ("channels", "varint"),
    3: ("height", "varint"),
    4: ("width", "varint"),
    5: ("data", "packed_f32"),
    7: ("shape", ("msg", BLOB_SHAPE)),
    8: ("double_data", "packed_f64"),
}
LAYER_V2 = {
    1: ("name", "string"),
    2: ("type", "string"),
    3: ("bottom", "string"),
    4: ("top", "string"),
    7: ("blobs", ("msg", BLOB_PROTO)),
}
LAYER_V1 = {
    2: ("bottom", "string"),
    3: ("top", "string"),
    4: ("name", "string"),
    5: ("type", "varint"),
    6: ("blobs", ("msg", BLOB_PROTO)),
}
NET_PARAM = {
    1: ("name", "string"),
    2: ("layers", ("msg", LAYER_V1)),
    100: ("layer", ("msg", LAYER_V2)),
}

# V1LayerParameter.LayerType enum values -> new-style type strings
V1_TYPE_NAMES = {
    3: "Concat", 4: "Convolution", 5: "Data", 6: "Dropout", 8: "Flatten",
    14: "InnerProduct", 15: "LRN", 17: "Pooling", 18: "ReLU", 19: "Sigmoid",
    20: "Softmax", 21: "SoftmaxWithLoss", 22: "Split", 23: "TanH",
    25: "Eltwise", 26: "Power", 30: "ArgMax", 33: "Slice", 35: "AbsVal",
    39: "Deconvolution",
}
# prototxt V1 enum names (type: CONVOLUTION) -> new-style
V1_ENUM_NAMES = {
    "CONCAT": "Concat", "CONVOLUTION": "Convolution", "DATA": "Data",
    "DROPOUT": "Dropout", "FLATTEN": "Flatten", "INNER_PRODUCT":
    "InnerProduct", "LRN": "LRN", "POOLING": "Pooling", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "SOFTMAX": "Softmax", "SOFTMAX_LOSS":
    "SoftmaxWithLoss", "SPLIT": "Split", "TANH": "TanH", "ELTWISE":
    "Eltwise", "ABSVAL": "AbsVal", "DECONVOLUTION": "Deconvolution",
    "POWER": "Power",
}


def _read_varint(buf, pos):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def decode_message(buf, schema):
    """Decode one message per `schema` {field_no: (name, kind)}; unknown
    fields are skipped by wire type. Every field decodes to a list."""
    msg = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            payload = None
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            payload = buf[pos:pos + n]
            pos += n
            val = None
        elif wire == 5:
            payload = buf[pos:pos + 4]
            pos += 4
            val = None
        elif wire == 1:
            payload = buf[pos:pos + 8]
            pos += 8
            val = None
        else:
            raise ValueError("unsupported wire type %d" % wire)
        spec = schema.get(field_no)
        if spec is None:
            continue
        name, kind = spec
        if kind == "varint":
            out = val
        elif kind == "string":
            out = payload.decode("utf-8")
        elif kind == "packed_f32":
            if payload is not None:
                out = np.frombuffer(payload, dtype="<f4")
            else:  # unpacked encoding of a packed-capable field
                out = np.frombuffer(struct.pack("<I", val), dtype="<f4")
        elif kind == "packed_f64":
            out = np.frombuffer(payload, dtype="<f8")
        elif kind == "packed_varint":
            if payload is not None:
                out, p2 = [], 0
                while p2 < len(payload):
                    v, p2 = _read_varint(payload, p2)
                    out.append(v)
            else:
                out = [val]
        elif isinstance(kind, tuple) and kind[0] == "msg":
            out = decode_message(payload, kind[1])
        else:
            raise ValueError("bad schema kind %r" % (kind,))
        if kind in ("packed_f32", "packed_f64") and name in msg:
            msg[name] = [np.concatenate([msg[name][0], out])]
        elif kind == "packed_varint":
            # flatten: packed payloads and repeated unpacked varints both
            # decode to one list of ints
            msg.setdefault(name, []).extend(out)
        else:
            msg.setdefault(name, []).append(out)
    return msg


def read_caffemodel(path):
    """-> list of {name, type, blobs:[np.ndarray]} in network order."""
    with open(path, "rb") as f:
        net = decode_message(f.read(), NET_PARAM)
    layers = []
    for raw in _all(net, "layer") + _all(net, "layers"):
        ltype = _one(raw, "type", "")
        if isinstance(ltype, int):
            ltype = V1_TYPE_NAMES.get(ltype, str(ltype))
        blobs = []
        for b in _all(raw, "blobs"):
            data = _one(b, "data")
            if data is None:
                data = _one(b, "double_data")
            if data is None:
                continue
            shape_msg = _one(b, "shape")
            if shape_msg is not None and _all(shape_msg, "dim"):
                shape = tuple(_all(shape_msg, "dim"))
            else:
                legacy = [_one(b, k, 0) or 0
                          for k in ("num", "channels", "height", "width")]
                shape = tuple(d for d in legacy if d) or (len(data),)
            blobs.append(np.asarray(data, dtype=np.float32).reshape(shape))
        layers.append({"name": _one(raw, "name", ""), "type": ltype,
                       "blobs": blobs})
    return layers


# ---------------------------------------------------------------------------
# symbol conversion
# ---------------------------------------------------------------------------


def convert_symbol(prototxt_text):
    """Convert a deploy prototxt to a Symbol.

    Returns (symbol, input_name, input_dim_or_None). The graph is built
    layer-name-keyed so convert_model's parameters bind directly.
    """
    net = parse_prototxt(prototxt_text)
    layers = _get_layers(net)
    return _build_symbol(net, layers)


def _build_symbol(net, layers):
    import mxnet_tpu_torch as mx

    scale_to_bn = _bn_scale_map(layers)

    # input discovery (reference order: input_dim > input_shape > Input layer)
    input_name, input_dim = "data", None
    if _all(net, "input"):
        input_name = _one(net, "input")
        if _all(net, "input_dim"):
            input_dim = [int(d) for d in _all(net, "input_dim")][:4]
        elif _all(net, "input_shape"):
            input_dim = [int(d) for d in _all(_one(net, "input_shape"), "dim")]
    blobs = {}  # caffe top name -> Symbol
    first_real = None
    for ltype, l in layers:
        if ltype in _DATA_LAYER_TYPES:
            tops = _all(l, "top") or ["data"]
            input_name = tops[0]
            if ltype == "Input":
                shape_msg = _one(_one(l, "input_param", {}), "shape")
                if shape_msg:
                    input_dim = [int(d) for d in _all(shape_msg, "dim")]
            continue
        if first_real is None:
            first_real = l
    if first_real is not None and input_name not in blobs:
        bottoms = _all(first_real, "bottom")
        if bottoms and _one(net, "input") is None and not any(
                t in _DATA_LAYER_TYPES for t, _ in layers):
            input_name = bottoms[0]
    blobs[input_name] = mx.sym.Variable(input_name)

    sym = None
    for ltype, l in layers:
        if ltype in _DATA_LAYER_TYPES:
            continue
        name = _one(l, "name", "")
        declared = _all(l, "bottom")
        missing = [b for b in declared if b not in blobs]
        # the only bottom a layer may legitimately shed is a loss/eval
        # layer's label, fed by a TEST-phase data layer we skipped — and the
        # label is never the first bottom. Anything else (a typo'd bottom, a
        # skipped branch of Concat/Eltwise) would silently detach part of
        # the network.
        sheddable = "Loss" in ltype or ltype == "Accuracy"
        bad = [b for b in missing
               if not (sheddable and declared and b != declared[0])]
        if bad:
            raise ValueError(
                "%s layer %r: bottom(s) %r are not produced by any converted "
                "layer — refusing to build a silently-wrong network"
                % (ltype, name, bad))
        bottoms = [blobs[b] for b in declared if b in blobs]
        tops = _all(l, "top") or [name]
        if ltype == "Scale" and name not in scale_to_bn:
            raise ValueError(
                "standalone Scale layer %r (no preceding BatchNorm) is not "
                "supported — its learned scaling cannot be silently dropped"
                % (name,))
        converted = _convert_layer(mx, ltype, l, name, bottoms)
        if converted is None:
            continue
        sym = converted
        for t in tops:
            blobs[t] = sym
    if sym is None:
        raise ValueError("prototxt has no convertible layers")
    # the network output is the last non-data layer's top
    return sym, input_name, input_dim


def convert_model(prototxt_text, caffemodel_path):
    """-> (symbol, arg_params, aux_params) with this framework's naming
    (`<layer>_weight/_bias/_gamma/_beta`, aux `<bn>_moving_mean/_var`)."""
    net = parse_prototxt(prototxt_text)
    proto_layers = _get_layers(net)
    sym, input_name, input_dim = _build_symbol(net, proto_layers)
    layers = read_caffemodel(caffemodel_path)
    bn_for_scale = _bn_scale_map(proto_layers)
    arg_params, aux_params = {}, {}
    for layer in layers:
        name, ltype, blobs = layer["name"], layer["type"], layer["blobs"]
        if not blobs:
            continue
        if ltype in ("Convolution", "Deconvolution", "InnerProduct",
                     "Scale", "PReLU"):
            if ltype == "Scale":
                bn = bn_for_scale.get(name)
                if bn is None:
                    continue
                arg_params[bn + "_gamma"] = blobs[0].reshape(-1)
                if len(blobs) > 1:
                    arg_params[bn + "_beta"] = blobs[1].reshape(-1)
            elif ltype == "PReLU":
                arg_params[name + "_gamma"] = blobs[0].reshape(-1)
            else:
                w = blobs[0]
                if ltype == "InnerProduct" and w.ndim > 2:
                    # legacy caffemodels store FC weights 4-D with leading
                    # singleton num/channels dims
                    w = w.reshape(w.shape[-2], w.shape[-1])
                arg_params[name + "_weight"] = w
                if len(blobs) > 1:
                    arg_params[name + "_bias"] = blobs[1].reshape(-1)
        elif ltype == "BatchNorm":
            # blobs: mean, var, scale_factor — caffe stores UNNORMALIZED
            # accumulators; divide by the scale factor
            sf = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 else 1.0
            sf = 1.0 / sf if sf != 0 else 0.0
            aux_params[name + "_moving_mean"] = blobs[0].reshape(-1) * sf
            aux_params[name + "_moving_var"] = blobs[1].reshape(-1) * sf
            arg_params.setdefault(
                name + "_gamma",
                np.ones_like(aux_params[name + "_moving_mean"]))
            arg_params.setdefault(
                name + "_beta",
                np.zeros_like(aux_params[name + "_moving_mean"]))
    return sym, arg_params, aux_params


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert Caffe prototxt (+caffemodel) to symbol/params")
    ap.add_argument("prototxt")
    ap.add_argument("caffemodel", nargs="?",
                    help="optional binary weights file")
    ap.add_argument("prefix", help="output prefix")
    args = ap.parse_args(argv)

    import mxnet_tpu_torch as mx

    with open(args.prototxt) as f:
        text = f.read()
    if args.caffemodel:
        sym, arg_params, aux_params = convert_model(text, args.caffemodel)
        nd_args = {"arg:%s" % k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                   arg_params.items()}
        nd_args.update({"aux:%s" % k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                        aux_params.items()})
        mx.nd.save("%s-0000.params" % args.prefix, nd_args)
        print("saved %s-0000.params (%d arrays)"
              % (args.prefix, len(nd_args)))
    else:
        sym, _, _ = convert_symbol(text)
    with open("%s-symbol.json" % args.prefix, "w") as f:
        f.write(sym.tojson())
    print("saved %s-symbol.json" % args.prefix)


if __name__ == "__main__":
    sys.exit(main())
