"""Python-free deployment artifacts (counterpart of
``mxnet_tpu/export_artifact.py``; reference: ``amalgamation/README.md``
and ``src/c_api/c_predict_api.cc``).

An export writes one ``.mxa`` file that ``libmxtpu_predict_native.so``
(``csrc/native_rt/``, built by :mod:`._predict_native`) runs with no
Python in the process: the C predict API (``MXPredCreateFromFile``, ...)
for a predict artifact, ``MXTrainNative*`` for a train artifact.

Container layout (little-endian), the JAX package's byte for byte::

    8 bytes   magic "MXTPUAR1"
    u64 n     manifest length   | n bytes of JSON
    u64 n     program length    | n bytes of program
    u64 n     params length     | n bytes of NDArray-dict save format
                                  (keys "arg:NAME"/"aux:NAME", and
                                  "state:NAME:K" in a train artifact)

The program section is where the packages part (``ROADMAP.md`` C34).
The JAX package writes StableHLO from ``jax.export`` and runs it through
PJRT; the port writes the symbol JSON of the graph its executor and
fused step run (the graph passes applied), and the runtime interprets it
over ATen with the port's own attention kernels and libtorch's C++
autograd. The manifest says so in ``"program_format":
"mxnet-symbol-json"``; its other keys are the JAX exporter's, with
``platform`` ``"cuda"`` or ``"cpu"``, and a train artifact also carries
``"optimizer_params"`` (the JAX package bakes them into its program).
The params section is written by ``nd.save``, byte-equal to the JAX
package's for the same parameters, so the weights of either package's
artifact load in both; neither runtime runs the other's program.

A train artifact of ``num_devices=N`` is the data-parallel step over N
positions: the JAX package's ``"sharding"`` tags in the manifest, and in
the program section, beside the symbol JSON's ``nodes``, a ``"dp"`` entry
holding :class:`.parallel.dp.DPGraph`'s plan (each node's form, each
output's batch axis), which the runtime reads (``csrc/native_rt/dp.cc``).

``kept`` flags follow the JAX exporter's dead-code elimination
(``module_kept_var_idx``): an input or parameter is kept when an output
depends on its value. The port derives them from the graph with
:func:`_ignored_inputs`, the inputs each op's forward does not read
(a ``fix_gamma`` BatchNorm's gamma).
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

from . import compileobs as _compileobs
from . import context as _context
from . import graphpass as _graphpass
from . import ndarray as nd
from .base import MXNetError
from .executor import graph_is_stochastic
from .ops.registry import get_op

MAGIC = b"MXTPUAR1"
PROGRAM_FORMAT = "mxnet-symbol-json"

__all__ = ["export_predict_artifact", "export_train_artifact",
           "load_artifact_manifest", "MAGIC", "PROGRAM_FORMAT"]

def _ignored_inputs(node):
    """Input positions of op ``node`` whose values its forward does not
    read: the gamma of a ``fix_gamma`` BatchNorm (replaced by ones). A
    loss head's label is read (the JAX package's heads are custom VJPs,
    whose label stays an operand of the exported program)."""
    if node.op in ("BatchNorm", "BatchNorm_v1") and node.attrs.get("fix_gamma"):
        return {1}
    return set()


def _read_variables(symbol):
    """Names of the variables an output of ``symbol`` reads the value of."""
    seen, out = set(), set()
    stack = [n for n, _ in symbol._entries]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if node.is_variable:
            out.add(node.name)
            continue
        skip = _ignored_inputs(node)
        stack.extend(inp for i, (inp, _) in enumerate(node.inputs)
                     if i not in skip)
    return out


def _resolve_platform(platform):
    """The manifest's platform: ``"cuda"`` or ``"cpu"``. The JAX
    package's ``"tpu"`` (and None) mean the port's current device."""
    if platform in ("cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    if platform in (None, "tpu"):
        return "cpu" if _context.current_context().device_type == "cpu" \
            else "cuda"
    raise MXNetError("export: unknown platform %r (cuda, cpu, or tpu for "
                     "the current device)" % (platform,))


def _host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _infer_labels(symbol, shapes, candidates, arg_names):
    """Fill ``shapes`` with the inferable shapes of the label-named
    ``candidates``; returns the names filled."""
    filled = []
    inferred, _, _ = symbol.infer_shape_partial(**shapes)
    for n, shp in zip(arg_names, inferred):
        if n in candidates and shp is not None and 0 not in tuple(shp):
            shapes[n] = tuple(shp)
            filled.append(n)
    return filled


def _output_dtypes(symbol, dtypes):
    _, out_types, _ = symbol.infer_type(**dtypes)
    return [str(np.dtype(t)) for t in out_types]


def _params_blob(params_dict, path):
    """The NDArray-dict save format of ``params_dict`` (``nd.save``'s
    bytes, written beside ``path`` and read back)."""
    tmp = "%s.params.%d.tmp" % (path, os.getpid())
    try:
        nd.save(tmp, params_dict)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write(path, manifest, program, pbytes):
    mjs = json.dumps(manifest, indent=1).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(mjs)))
        f.write(mjs)
        f.write(struct.pack("<Q", len(program)))
        f.write(program)
        f.write(struct.pack("<Q", len(pbytes)))
        f.write(pbytes)


def export_predict_artifact(symbol, arg_params, aux_params, input_shapes,
                            path, platform="tpu", dtype="float32",
                            matmul_precision="highest"):
    """Export ``symbol``'s inference forward into a ``.mxa`` file and
    return its manifest.

    ``arg_params``/``aux_params`` are the trained parameters,
    ``input_shapes`` the data inputs' shapes (label inputs of loss heads
    are inferred, marked ``"kind": "label"`` and fed zeros by the
    runtime). ``platform`` is recorded (``"cuda"``/``"cpu"``; the JAX
    package's ``"tpu"`` means the current device); the runtime runs on the
    device its caller asks for. ``matmul_precision`` is recorded as the
    JAX exporter records it: the port computes in full float32."""
    platform = _resolve_platform(platform)
    with _compileobs.record_compile(
            "export.predict",
            site="mxnet_tpu_torch/export_artifact.py:export_predict_artifact"):
        program_sym = _graphpass.optimize(symbol)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_params = {k: _host(v) for k, v in (arg_params or {}).items()}
        aux_params = {k: _host(v) for k, v in (aux_params or {}).items()}

        input_names = [n for n in arg_names if n not in arg_params]
        param_names = [n for n in arg_names if n in arg_params]
        missing_aux = [n for n in aux_names if n not in aux_params]
        if missing_aux:
            raise MXNetError("missing aux params: %s" % missing_aux)

        shapes = {n: tuple(s) for n, s in input_shapes.items()}
        kinds = {n: "data" for n in shapes}
        unknown = [n for n in input_names if n not in shapes]
        # only label-named inputs are inferred and zero-fed: anything else
        # without a shape is a parameter missing from arg_params
        inferable = [n for n in unknown if n == "label" or n.endswith("_label")]
        not_label = [n for n in unknown if n not in inferable]
        if not_label:
            raise MXNetError(
                "arguments %s have neither a value in arg_params nor a shape "
                "in input_shapes; if they are network inputs pass their "
                "shapes, if they are parameters add them to arg_params"
                % not_label)
        if inferable:
            for n in _infer_labels(symbol, shapes, inferable, arg_names):
                kinds[n] = "label"
            unknown = [n for n in input_names if n not in shapes]
            if unknown:
                raise MXNetError("cannot infer shapes for inputs %s" % unknown)
        bad = [n for n in input_shapes if n not in input_names]
        if bad:
            raise MXNetError("input_shapes for non-input names %s (bound "
                             "params?)" % bad)

        np_dtype = np.dtype(dtype)
        read = _read_variables(program_sym)
        kept_params = (["arg:" + n for n in param_names if n in read]
                       + ["aux:" + n for n in aux_names if n in read])
        all_shapes = dict(shapes)
        all_shapes.update({n: arg_params[n].shape for n in param_names})
        _, out_shapes, _ = symbol.infer_shape(**all_shapes)
        if out_shapes is None:
            raise MXNetError("export: shape inference failed for %s"
                             % all_shapes)
        out_dtypes = _output_dtypes(symbol, {n: np_dtype for n in input_names
                                             if kinds.get(n) == "data"})
        manifest = {
            "version": 1,
            "platform": platform,
            "matmul_precision": matmul_precision,
            "inputs": [{"name": n, "shape": list(shapes[n]),
                        "dtype": str(np_dtype), "kind": kinds.get(n, "data"),
                        "kept": n in read}
                       for n in input_names],
            "params": kept_params,
            "outputs": [{"name": n, "shape": [int(d) for d in s],
                         "dtype": t}
                        for n, s, t in zip(symbol.list_outputs(), out_shapes,
                                           out_dtypes)],
            "program_format": PROGRAM_FORMAT,
        }
        params_dict = {}
        for key in kept_params:  # unread params stay out, as in JAX's
            kind, _, n = key.partition(":")
            src = arg_params if kind == "arg" else aux_params
            params_dict[key] = nd.array(np.asarray(src[n]),
                                        ctx=_context.cpu())
        _write(path, manifest, program_sym.tojson().encode(),
               _params_blob(params_dict, path))
    return manifest


def _rule_params(rule, optimizer, param_names, lr_mult, wd_mult):
    """The manifest's ``optimizer_params``: the rule's constants (what the
    JAX package bakes into its program) and each parameter's
    multipliers."""
    out = {"wd": float(optimizer.wd),
           "rescale_grad": float(rule.rescale),
           "clip_gradient": (None if rule.clip is None else float(rule.clip))}
    for k in ("momentum", "beta1", "beta2", "eps", "gamma1", "gamma2",
              "centered", "clip_weights", "rho", "lamda1", "beta"):
        if hasattr(rule, k):
            out[k] = float(getattr(rule, k) or 0.0)
    out["lr_mult"] = {n: lr_mult[n] for n in param_names}
    out["wd_mult"] = {n: wd_mult[n] for n in param_names}
    return out


def export_train_artifact(symbol, input_shapes, path, optimizer="sgd",
                          optimizer_params=None, initializer=None,
                          arg_params=None, aux_params=None, platform="tpu",
                          matmul_precision="highest", seed=0,
                          compute_dtype=None, num_devices=1):
    """Export a whole training step (forward, backward and the optimizer
    update of the fused step) into a ``.mxa`` file (``kind: "train"``)
    and return its manifest.

    The step's flat signature, role-tagged in the manifest, is the JAX
    package's::

        step(params..., states..., auxs..., inputs..., lr, t)
          -> (new_params..., new_states..., new_auxs..., outputs...)

    ``lr`` is the float32 the client passes each step, ``t`` the update
    count from ``t0`` (Adam's bias correction). Initial parameters come
    from ``arg_params``/``aux_params`` or ``initializer`` (default
    Xavier) and ship in the params section with zeroed optimizer slots.
    ``compute_dtype="bfloat16"`` is the fused step's recipe (float32
    masters and slots, bfloat16 compute, float32 gradients through the
    cast). A stochastic graph draws from a generator seeded with
    ``seed + t``.

    ``num_devices=N`` exports the data-parallel step over N positions (the
    JAX package's manifest: parameters, slots, auxiliary states, ``lr`` and
    ``t`` ``"sharding": "rep"``, data and labels ``"batch"``, N dividing
    every batch; its ``compile_options`` are XLA's and left out, C34). The
    program section then also carries ``"dp"``, each node's form and each
    value's batch axis from :class:`.parallel.dp.DPGraph` (a node it
    refuses is refused here, before any initializer draws), and the
    runtime computes the global-batch step from them. The params section is
    the one-position export's."""
    from . import initializer as init_mod
    from . import optimizer as opt_mod
    from .parallel import fused_opt

    shapes = {n: tuple(s) for n, s in input_shapes.items()}
    arg_names = symbol.list_arguments()
    # a label-named input is a label whether its shape is given or inferred
    # (the JAX exporter makes a given one a data input: an LM's label,
    # which goes through a Reshape and cannot be inferred, would then be
    # fed as data by the C client and cast under a compute_dtype)
    label_like = [n for n in arg_names
                  if (n == "label" or n.endswith("_label"))
                  and n not in (arg_params or {})]
    if [n for n in label_like if n not in shapes]:
        _infer_labels(symbol, shapes, label_like, arg_names)
    data_shapes = [(n, s) for n, s in shapes.items() if n not in label_like]
    label_shapes = [(n, shapes[n]) for n in label_like if n in shapes]

    # checked before any initializer runs: a refused export draws nothing
    if num_devices > 1:
        for n, _ in data_shapes + label_shapes:
            shp = shapes[n]
            if not shp or shp[0] % num_devices != 0:
                raise ValueError(
                    "num_devices=%d must divide input '%s' batch dim %r"
                    % (num_devices, n, shp[:1]))
    platform = _resolve_platform(platform)

    with _compileobs.record_compile(
            "export.train_step",
            site="mxnet_tpu_torch/export_artifact.py:export_train_artifact"):
        inputs = {n for n, _ in data_shapes + label_shapes}
        pnames = [n for n in arg_names if n not in inputs]
        anames = symbol.list_auxiliary_states()
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("export: shape inference failed for %s" % shapes)
        arg_shapes = dict(zip(arg_names, arg_shapes))
        aux_shapes = dict(zip(anames, aux_shapes))
        opt = opt_mod.create(optimizer, sym=symbol,
                             param_idx2name={n: n for n in pnames},
                             **dict(optimizer_params or {}))
        rule = fused_opt.make_rule(opt)
        lr_mult, wd_mult = fused_opt.mults_for(opt, pnames)
        nslot = rule.nslot
        program_sym = _graphpass.optimize(symbol)
        # the data-parallel plan (a refusal names the op and the node)
        # comes before any initializer draws, as the checks above
        program = json.loads(program_sym.tojson())
        if num_devices > 1:
            program["dp"] = _dp_plan(program_sym, symbol, shapes, inputs,
                                     arg_names, anames, num_devices)
        stochastic = graph_is_stochastic(program_sym)
        loss_flags = [not node.is_variable and get_op(node.op).is_loss
                      for node, _ in symbol._entries]

        if initializer is None:
            initializer = init_mod.Xavier()
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})

        def initial(n, given, shape):
            if n in given:
                v = _host(given[n])
            else:
                host = nd.zeros(shape, ctx=_context.cpu())
                initializer(n, host)
                v = host.asnumpy()
            return np.asarray(v).astype(np.float32)

        params0 = {n: initial(n, arg_params, arg_shapes[n]) for n in pnames}
        auxs0 = {n: initial(n, aux_params, aux_shapes[n]) for n in anames}

        read = _read_variables(program_sym)
        f32 = "float32"
        args_desc = []

        def arg_row(name, role, shape, kept, donated, sharding="rep"):
            args_desc.append({
                "name": name, "role": role, "shape": [int(d) for d in shape],
                "dtype": "int32" if role == "t" else f32, "kept": kept,
                "donated": donated, "sharding": sharding})

        for n in pnames:
            arg_row(n, "param", arg_shapes[n], True, True)
        for n in pnames:
            for k in range(nslot):
                arg_row("%s:%d" % (n, k), "state", arg_shapes[n], True, True)
        for n in anames:
            arg_row(n, "aux", aux_shapes[n], True, True)
        batch_tag = "batch" if num_devices > 1 else "rep"
        for n, _ in data_shapes:
            arg_row(n, "data", shapes[n], n in read, False, batch_tag)
        for n, _ in label_shapes:
            arg_row(n, "label", shapes[n], n in read, False, batch_tag)
        # lr and t are read where the rule reads them (AdaDelta has no lr;
        # only a rule whose step size depends on t, and a graph's draws,
        # read t)
        uses_t = rule.step_lr(1.0, 1) != rule.step_lr(1.0, 2)
        arg_row("lr", "lr", (), bool(pnames) and not isinstance(
            rule, fused_opt._AdaDeltaRule), False)
        arg_row("t", "t", (), (bool(pnames) and uses_t) or stochastic, False)

        outs_desc = (
            [{"name": n, "role": "param", "shape": list(arg_shapes[n])}
             for n in pnames]
            + [{"name": "%s:%d" % (n, k), "role": "state",
                "shape": list(arg_shapes[n])}
               for n in pnames for k in range(nslot)]
            + [{"name": n, "role": "aux", "shape": list(aux_shapes[n])}
               for n in anames]
            + [{"name": n, "role": "out", "shape": list(s)}
               for n, s in zip(symbol.list_outputs(), out_shapes)])
        # an output holds the batch when its leading dim is the global
        # batch (the JAX exporter's rule: a dim the batch only divides
        # stays replicated)
        global_batch = shapes[data_shapes[0][0]][0] if data_shapes else -1
        for d in outs_desc:
            d["shape"] = [int(x) for x in d["shape"]]
            d["dtype"] = f32
            d["sharding"] = ("batch" if num_devices > 1 and d["role"] == "out"
                             and d["shape"][:1] == [global_batch] else "rep")

        manifest = {
            "version": 2,
            "kind": "train",
            "num_devices": int(num_devices),
            "platform": platform,
            "matmul_precision": matmul_precision,
            "compute_dtype": _dtype_name(compute_dtype),
            "optimizer": type(opt).__name__,
            "nslot": nslot,
            "t0": 1,
            "seed": int(seed),
            "loss_outputs": [bool(f) for f in loss_flags],
            "args": args_desc,
            "outputs": outs_desc,
            "program_format": PROGRAM_FORMAT,
            "optimizer_params": _rule_params(rule, opt, pnames, lr_mult,
                                             wd_mult),
        }

        params_dict = {}
        cpu = _context.cpu()
        for n in pnames:
            params_dict["arg:" + n] = nd.array(params0[n], ctx=cpu)
            for k in range(nslot):
                params_dict["state:%s:%d" % (n, k)] = nd.array(
                    np.zeros(arg_shapes[n], np.float32), ctx=cpu)
        for n in anames:
            params_dict["aux:" + n] = nd.array(auxs0[n], ctx=cpu)
        _write(path, manifest, json.dumps(program, indent=2).encode(),
               _params_blob(params_dict, path))
    return manifest


def _dp_plan(program_sym, symbol, shapes, inputs, arg_names, aux_names, n):
    """The program section's ``"dp"`` entry of a data-parallel train
    artifact: :class:`.parallel.dp.DPGraph`'s decisions over ``n``
    positions, one per node of the program's JSON (``forms``: ``"local"``,
    ``"dp"`` or ``"global"``, None for a variable; ``batch_axes``: the
    batch axis of each output, None where it holds no batch), so the
    runtime reads them and derives none. Raises, naming the op and the
    node, for a node ``dp.py`` refuses."""
    import torch

    from .parallel.dp import DPGraph
    from .parallel.mesh import Mesh
    from .symbol import _topo_order

    mesh = Mesh(np.array([torch.device("cpu")] * n, dtype=object), ["dp"])
    plan = DPGraph(program_sym, mesh, "dp", shapes, set(inputs), arg_names,
                   aux_names, order_like=symbol)
    order = _topo_order(program_sym._entries)   # tojson's node order
    return {"axis": "dp", "num_devices": int(n),
            "forms": [None if node.is_variable else plan.how[id(node)]
                      for node in order],
            "batch_axes": [plan.axes[id(node)] for node in order]}


def _dtype_name(dtype):
    """numpy's name of ``dtype`` (None: float32); numpy has no bfloat16,
    so that name is kept as given."""
    if dtype is None:
        return "float32"
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return str(np.dtype(dtype))


def load_artifact_manifest(path):
    """``(manifest, program length, params length)`` of a ``.mxa`` file
    (either package's): the Python mirror of the runtime's reader."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise MXNetError("not an .mxa artifact: %s" % path)
        (mlen,) = struct.unpack("<Q", f.read(8))
        manifest = json.loads(f.read(mlen).decode())
        (plen,) = struct.unpack("<Q", f.read(8))
        f.seek(plen, 1)
        (qlen,) = struct.unpack("<Q", f.read(8))
        return manifest, plen, qlen
