"""Per-function AST dataflow — which local names hold device values (the
port's copy of ``mxnet_tpu/analysis/dataflow.py``, over PyTorch's idioms).

The lint half's value-tracking engine. For every function in a file, a
single in-order walk evaluates each expression into a :class:`Val`
carrying two independent taint lattices:

* **device** — does this expression hold a tensor on the card?
  ``DEVICE`` / ``HOST`` / ``UNKNOWN``. Seeded from NDArray / ``nd.*``
  constructors, ``torch`` constructors given a device that is not the CPU
  (``torch.zeros(n, device=dev)``), ``.to(device)`` and ``.cuda()``,
  ``NDArray.data`` (the held tensor), the kernel wrappers of ``ops/``
  (``flash_attention*``, ``paged_attention*``), executor outputs
  (``.forward()`` / ``.get_outputs()`` / ``.outputs``), parameters
  annotated with a tensor type, and call-return summaries for same-file
  callees; propagated through assignment, tuple unpack, attribute load,
  arithmetic, subscripts, iteration and ``torch.*`` calls over a device
  operand; KILLED by the host-materializing methods (``.cpu()`` /
  ``.numpy()`` / ``.asnumpy()`` / ``.asscalar()`` / ``.tolist()`` /
  ``.item()``) and ``np.*`` constructors — reassigning a name to a host
  value ends its tracking.
* **step** — does this expression derive from a per-step Python scalar
  (loop counter, ``nbatch``/``epoch``-style name, un-bucketed ``len()`` or
  ``.shape``)? Feeding one into the key or the static buffers of a CUDA
  graph is the statically-predictable recapture hazard ``compileobs`` can
  only attribute after the fact. KILLED by bucketing calls (any callee
  whose name contains ``bucket``) and by ``np.*`` scalar/array conversion.

Every Val carries a human-readable provenance ``chain``
(``python -m mxnet_tpu_torch.tools.fwlint --explain`` prints it), so a
finding can show *why* the analyzer believes a value is on the card or
per-step.

This is a lint-grade analysis, deliberately unsound in both directions:
one in-order pass per function (no branch joins, no fixpoint inside a
function), bare-name call summaries, no aliasing through containers.
Checkers treat UNKNOWN conservatively per rule — see checkers.py.
Stdlib-only, like the rest of the package.
"""
from __future__ import annotations

import ast

__all__ = ["DEVICE", "HOST", "UNKNOWN", "Val", "FunctionFlow", "FileFlow",
           "analyze", "dotted_name"]

DEVICE = "device"
HOST = "host"
UNKNOWN = "unknown"

_MAX_CHAIN = 8

# dotted-call prefixes that construct/return device arrays (NDArrays)
_DEVICE_CALL_PREFIXES = ("nd.", "mx.nd.", "ndarray.")
_DEVICE_CALLS = ("NDArray", "nd.NDArray", "ndarray.NDArray")
# the kernel wrappers of ops/ (ops/attention.py): their outputs lie where
# their inputs do, on the card on every path a kernel launches
KERNEL_WRAPPERS = ("flash_attention", "flash_attention_forward",
                   "flash_attention_backward",
                   "flash_attention_backward_f32", "paged_attention",
                   "paged_attention_multi")
# torch constructors whose result lies on their ``device=`` argument
_TORCH_CTORS = ("zeros", "ones", "full", "empty", "arange", "tensor",
                "as_tensor", "rand", "randn", "randint", "linspace", "eye",
                "randperm", "empty_strided")
# torch constructors that inherit the device of their first argument
_TORCH_LIKE = ("zeros_like", "ones_like", "empty_like", "full_like",
               "rand_like", "randn_like")
# methods that host-materialize their receiver (the escape hatches)
_HOST_METHODS = ("asnumpy", "asscalar", "tolist", "item", "cpu", "numpy")
# device-in device-out methods (shape/dtype/layout transforms, reductions,
# arithmetic)
_DEVICE_METHODS = ("astype", "reshape", "transpose", "flatten", "squeeze",
                   "expand_dims", "broadcast_to", "clip", "sum", "mean",
                   "max", "min", "prod", "dot", "copyto", "as_in_context",
                   "copy", "slice", "take", "add", "ravel", "detach",
                   "wait_to_read", "any", "all", "to", "float", "half",
                   "bfloat16", "double", "long", "int", "bool", "contiguous",
                   "view", "view_as", "permute", "clone", "unsqueeze",
                   "expand", "expand_as", "repeat", "narrow", "select",
                   "index_select", "gather", "scatter", "masked_fill",
                   "argmax", "argmin", "softmax", "log_softmax", "exp",
                   "log", "sqrt", "rsqrt", "abs", "square", "pow", "norm",
                   "matmul", "mm", "bmm", "mul", "div", "sub", "neg",
                   "type_as", "split", "chunk", "cumsum", "amax", "amin",
                   "isfinite", "isnan", "eq", "ne", "gt", "lt", "ge", "le",
                   "copy_", "add_", "mul_", "sub_", "div_", "zero_",
                   "fill_", "clamp", "clamp_", "float_power")
# calls whose return is a fresh device value regardless of receiver
# (executor outputs: the module/executor step-path contract)
_DEVICE_RETURN_METHODS = ("forward", "get_outputs", "get_input_grads")
# attributes that stay device when loaded off a device value
_DEVICE_ATTRS = ("grad", "T", "outputs")
# attributes that are metadata, never a device payload
_META_ATTRS = ("shape", "ndim", "dtype", "size", "context", "ctx", "device",
               "is_cuda", "requires_grad")
# parameter names that are per-step scalars wherever they appear
_STEP_PARAM_NAMES = ("nbatch", "epoch", "num_update", "step_id", "niter",
                     "nbatches", "batch_idx")
# array constructors whose SHAPE comes from their arguments (shared with
# the recapture-hazard checker): a per-step dim in, a per-step shape out
SHAPE_CTORS = frozenset(
    pre + name
    for pre in ("np.", "numpy.", "nd.", "torch.")
    for name in ("zeros", "ones", "full", "empty", "arange", "rand",
                 "randn"))
# annotation text fragments that mark a parameter as a tensor
_ARRAY_ANNOTATIONS = ("NDArray", "ndarray", "Tensor")


def _host_device(node):
    """True when ``node`` names the host: the constant ``"cpu"`` (or a
    ``torch.device("cpu")`` / ``mx.cpu()`` spelling of it)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name.endswith("cpu"):
            return True
        if name.endswith("device") and node.args:
            return _host_device(node.args[0])
    return False


def _device_arg(node):
    """True when ``node`` is an expression that names a device and not the
    host: a string constant starting ``cuda``, a ``torch.device(...)`` /
    ``mx.gpu()`` call, or a name or attribute that reads like a device
    (``device``, ``dev``, ``ctx``, ``context``)."""
    if node is None or _host_device(node):
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    name = dotted_name(node.func) if isinstance(node, ast.Call) \
        else dotted_name(node)
    leaf = name.rsplit(".", 1)[-1].lower()
    return leaf in ("device", "dev", "ctx", "context", "gpu", "tpu",
                    "cuda", "_device", "_dev", "_ctx", "_context") \
        or leaf.endswith("_device")


def dotted_name(node):
    """Best-effort dotted name of an expression (``os.environ`` ->
    'os.environ') — the shared helper every analysis module resolves
    names with (checkers/lockgraph import it from here)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return base + "." + node.attr if base else node.attr
    return ""


_dotted = dotted_name


class Val:
    """One expression's abstract value: device lattice + step taint, each
    with a provenance chain for ``--explain``. ``listy`` marks a Python
    CONTAINER of device arrays (executor ``.outputs`` / ``get_outputs()``)
    — len() of one is graph arity, not array structure."""

    __slots__ = ("dev", "chain", "step", "schain", "listy")

    def __init__(self, dev=UNKNOWN, chain=(), step=False, schain=(),
                 listy=False):
        self.dev = dev
        self.chain = tuple(chain)[-_MAX_CHAIN:]
        self.step = step
        self.schain = tuple(schain)[-_MAX_CHAIN:]
        self.listy = listy

    def __repr__(self):
        return "Val(%s%s)" % (self.dev, ", step" if self.step else "")


_BOTTOM = Val()


def _join(*vals):
    """Merge operand values: DEVICE wins (an expression touching any
    device operand is device-resident), HOST only when all agree."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return _BOTTOM
    dev, chain = UNKNOWN, ()
    if any(v.dev == DEVICE for v in vals):
        dev = DEVICE
        chain = next(v.chain for v in vals if v.dev == DEVICE)
    elif vals and all(v.dev == HOST for v in vals):
        dev = HOST
    step = any(v.step for v in vals)
    schain = next((v.schain for v in vals if v.step), ())
    return Val(dev, chain, step, schain)


class FunctionFlow:
    """One in-order dataflow walk over a single function (or the module
    body when ``fnode`` is an ``ast.Module``). After construction,
    :meth:`val` answers for every expression node the walk evaluated."""

    def __init__(self, ctx, fnode, summaries=None, seed_device_params=False):
        self.ctx = ctx
        self.fnode = fnode
        self.summaries = summaries or {}
        self.values = {}  # id(node) -> Val
        self._env = {}
        self._loop_depth = 0
        if isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._seed_params(fnode, seed_device_params)
            self._walk(fnode.body)
        elif isinstance(fnode, ast.Lambda):
            self._seed_params(fnode, seed_device_params)
            self._eval(fnode.body)
        else:  # ast.Module
            self._walk(fnode.body)

    # ------------------------------------------------------------- seeding
    def _seed_params(self, fnode, seed_device):
        args = fnode.args
        params = list(getattr(args, "posonlyargs", ())) + list(args.args) \
            + list(args.kwonlyargs)
        # a parameter defaulting to a Python constant (train=True) is a
        # host scalar, not a tensor
        positional = list(getattr(args, "posonlyargs", ())) + list(args.args)
        scalar = {a.arg for a, d in zip(positional[len(positional)
                                                   - len(args.defaults):],
                                        args.defaults)
                  if isinstance(d, ast.Constant)}
        scalar |= {a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
                   if isinstance(d, ast.Constant)}
        for a in params:
            dev = UNKNOWN
            chain = ()
            ann = getattr(a, "annotation", None)
            ann_txt = ast.dump(ann) if ann is not None else ""
            if any(t in ann_txt for t in _ARRAY_ANNOTATIONS):
                dev = DEVICE
                chain = ("line %d: parameter %s annotated as an array type"
                         % (fnode.lineno, a.arg),)
            elif seed_device and a.arg not in scalar \
                    and a.arg not in ("self", "cls"):
                dev = DEVICE
                chain = ("line %d: parameter %s of a function run under "
                         "a CUDA-graph capture" % (fnode.lineno, a.arg),)
            step = a.arg in _STEP_PARAM_NAMES
            schain = ("line %d: parameter %s is a per-step scalar by name"
                      % (fnode.lineno, a.arg),) if step else ()
            self._env[a.arg] = Val(dev, chain, step, schain)

    # ------------------------------------------------------------ statements
    def _walk(self, body):
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return  # nested scopes are analyzed by their own FunctionFlow
        if isinstance(s, ast.Assign):
            v = self._eval(s.value)
            for t in s.targets:
                self._assign(t, v, s.value)
        elif isinstance(s, ast.AnnAssign):
            v = self._eval(s.value) if s.value is not None else _BOTTOM
            self._assign(s.target, v, s.value or s)
        elif isinstance(s, ast.AugAssign):
            inc = self._eval(s.value)
            if isinstance(s.target, ast.Name):
                old = self._env.get(s.target.id, _BOTTOM)
                v = _join(old, inc)
                # `n += 1` inside a loop is the canonical hand-rolled
                # per-step counter
                if self._loop_depth and isinstance(s.value, ast.Constant) \
                        and isinstance(s.value.value, (int, float)):
                    v = Val(v.dev, v.chain, True, v.schain or (
                        "line %d: %s incremented inside a loop (per-step "
                        "counter)" % (s.lineno, s.target.id),))
                self._env[s.target.id] = v
        elif isinstance(s, ast.For):
            it = self._eval(s.iter)
            self._bind_loop_target(s.target, s.iter, it)
            self._loop_depth += 1
            self._walk(s.body)
            self._loop_depth -= 1
            self._walk(s.orelse)
        elif isinstance(s, ast.While):
            self._eval(s.test)
            self._loop_depth += 1
            self._walk(s.body)
            self._loop_depth -= 1
            self._walk(s.orelse)
        elif isinstance(s, ast.If):
            self._eval(s.test)
            self._walk(s.body)
            self._walk(s.orelse)
        elif isinstance(s, ast.With) or isinstance(s, ast.AsyncWith):
            for item in s.items:
                v = self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, v, item.context_expr)
            self._walk(s.body)
        elif isinstance(s, ast.Try):
            self._walk(s.body)
            for h in s.handlers:
                self._walk(h.body)
            self._walk(s.orelse)
            self._walk(s.finalbody)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self._eval(s.value)
        elif isinstance(s, ast.Expr):
            self._eval(s.value)
        elif isinstance(s, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self._eval(child)
        # Pass/Break/Continue/Import/Global/Nonlocal: nothing to evaluate

    def _bind_loop_target(self, target, iter_node, it_val):
        """``for`` targets: rows of a device iterable stay device; the
        counter of ``enumerate()`` / a ``range()`` variable is per-step."""
        iname = _dotted(iter_node.func) if isinstance(iter_node, ast.Call) \
            else ""
        elem = Val(it_val.dev, it_val.chain)
        if iname.endswith("range"):
            elem = Val(HOST, (), True,
                       ("line %d: loop counter over %s"
                        % (iter_node.lineno, iname or "iterable"),))
        if iname == "enumerate" and isinstance(target, ast.Tuple) \
                and target.elts:
            inner = _BOTTOM
            if iter_node.args:
                inner_v = self.values.get(id(iter_node.args[0]))
                if inner_v is not None:
                    inner = Val(inner_v.dev, inner_v.chain)
            counter = Val(HOST, (), True,
                          ("line %d: enumerate() counter (per-step scalar)"
                           % iter_node.lineno,))
            self._assign(target.elts[0], counter, iter_node)
            for t in target.elts[1:]:
                self._assign(t, inner, iter_node)
            return
        self._assign(target, elem, iter_node)

    def _assign(self, target, val, src_node):
        if isinstance(target, ast.Name):
            chain = val.chain
            if val.dev == DEVICE:
                chain = val.chain + (
                    "line %d: %s = %s" % (getattr(src_node, "lineno",
                                                  target.lineno),
                                          target.id,
                                          self._snippet(src_node)),)
            schain = val.schain
            if val.step:
                schain = val.schain + (
                    "line %d: %s = %s" % (getattr(src_node, "lineno",
                                                  target.lineno),
                                          target.id,
                                          self._snippet(src_node)),)
            self._env[target.id] = Val(val.dev, chain, val.step, schain,
                                       listy=val.listy)
        elif isinstance(target, (ast.Tuple, ast.List)):
            parts = None
            if isinstance(src_node, (ast.Tuple, ast.List)) \
                    and len(src_node.elts) == len(target.elts):
                parts = [self.values.get(id(e), _BOTTOM)
                         for e in src_node.elts]
            for i, t in enumerate(target.elts):
                # unpacking a device tuple/array: every element inherits
                self._assign(t, parts[i] if parts else
                             Val(val.dev, val.chain, val.step, val.schain),
                             src_node)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, val, src_node)
        # Attribute/Subscript targets: no local binding to update

    def _snippet(self, node):
        txt = self.ctx.line_text(getattr(node, "lineno", 0))
        return txt if len(txt) <= 60 else txt[:57] + "..."

    # ----------------------------------------------------------- expressions
    def _eval(self, node):
        v = self._eval_inner(node)
        self.values[id(node)] = v
        return v

    def _eval_inner(self, node):
        if node is None:
            return _BOTTOM
        if isinstance(node, ast.Name):
            return self._env.get(node.id, _BOTTOM)
        if isinstance(node, ast.Constant):
            return Val(HOST)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value)
            if node.attr in _META_ATTRS:
                sch = ("line %d: .%s of %s (un-bucketed shape metadata)"
                       % (node.lineno, node.attr, self._snippet(node)),)
                return Val(HOST, (), node.attr == "shape", sch)
            if node.attr == "outputs":
                # executor outputs are device-resident whatever we know
                # about the executor itself — a SEED, not a propagation
                return Val(DEVICE, (
                    "line %d: .outputs — executor outputs are "
                    "device-resident" % node.lineno,), listy=True)
            if node.attr == "data" and base.dev != HOST:
                # NDArray.data is the held tensor: a SEED on any receiver
                # not proven to be on the host (a DataBatch's .data is a
                # list of arrays: a container, not a tensor)
                batch = "batch" in dotted_name(node.value).lower()
                return Val(DEVICE, base.chain + (
                    "line %d: .data — %s" % (
                        node.lineno, "a batch's arrays" if batch
                        else "the tensor an NDArray holds"),), listy=batch)
            if base.dev == DEVICE and node.attr in _DEVICE_ATTRS:
                return Val(DEVICE, base.chain + (
                    "line %d: .%s of a device value" % (node.lineno,
                                                        node.attr),))
            return _BOTTOM
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value)
            sl = self._eval(node.slice)
            # indexing a device array yields a device view; subscripting a
            # .shape tuple stays per-step; a SLICE whose bound is per-step
            # (x[:n] — or any axis of a multi-dim x[:, :n]) yields a
            # per-step SHAPE, the classic hazard
            step, schain = base.step, base.schain
            slice_step, slice_schain = False, ()
            if isinstance(node.slice, ast.Slice):
                slice_step, slice_schain = sl.step, sl.schain
            elif isinstance(node.slice, ast.Tuple):
                for e in node.slice.elts:
                    ev = self.values.get(id(e))
                    if isinstance(e, ast.Slice) and ev is not None \
                            and ev.step:
                        slice_step, slice_schain = True, ev.schain
                        break
            if slice_step:
                step, schain = True, slice_schain + (
                    "line %d: slice bound is per-step — the result's "
                    "shape varies every step" % node.lineno,)
            return Val(base.dev if base.dev == DEVICE else UNKNOWN,
                       base.chain, step, schain)
        if isinstance(node, ast.BinOp):
            return _join(self._eval(node.left), self._eval(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand)
        if isinstance(node, ast.BoolOp):
            return _join(*[self._eval(v) for v in node.values])
        if isinstance(node, ast.Compare):
            vals = [self._eval(node.left)] + [self._eval(c)
                                              for c in node.comparators]
            # identity/None checks are STRUCTURE checks, not a device
            # read: `if rng is None:` branches on argument structure
            # (membership, `n in params`, is a container lookup)
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops) \
                    or any(isinstance(c, ast.Constant) and c.value is None
                           for c in node.comparators):
                return Val(HOST)
            j = _join(*vals)
            # comparing against a device operand yields a device boolean
            return Val(j.dev, j.chain, j.step, j.schain)
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            return _join(self._eval(node.body), self._eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            vals = [self._eval(e) for e in node.elts]
            j = _join(*vals)
            # containers don't aggregate STEP taint: packing a counter
            # into carry state is not itself a per-step-shaped value; a
            # container of tensors is no tensor (its truth is its length)
            return Val(j.dev, j.chain, listy=j.dev == DEVICE)
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self._eval(k)
            j = _join(*[self._eval(v) for v in node.values])
            return Val(j.dev, j.chain, listy=j.dev == DEVICE)
        if isinstance(node, ast.JoinedStr):
            for part in node.values:
                self._eval(part)
            return Val(HOST)
        if isinstance(node, ast.FormattedValue):
            return self._eval(node.value)
        if isinstance(node, ast.Starred):
            return self._eval(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            saved = dict(self._env)
            for gen in node.generators:
                it = self._eval(gen.iter)
                self._bind_loop_target(gen.target, gen.iter, it)
                for cond in gen.ifs:
                    self._eval(cond)
            if isinstance(node, ast.DictComp):
                self._eval(node.key)
                out = self._eval(node.value)
            else:
                out = self._eval(node.elt)
            self._env = saved
            return Val(out.dev, out.chain, out.step, out.schain,
                       listy=out.dev == DEVICE)
        if isinstance(node, ast.Lambda):
            return _BOTTOM  # separate scope; not evaluated here
        if isinstance(node, ast.Slice):
            bounds = [self._eval(part)
                      for part in (node.lower, node.upper, node.step)
                      if part is not None]
            # a slice carries its bounds' STEP taint (x[:n] reshapes per
            # step) but never a device payload
            j = _join(*bounds)
            return Val(UNKNOWN, (), j.step, j.schain)
        # anything else: evaluate children for completeness
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._eval(child)
        return _BOTTOM

    def _eval_call(self, node):
        fname = _dotted(node.func)
        args = [self._eval(a) for a in node.args]
        for kw in node.keywords:
            args.append(self._eval(kw.value))
        recv = None
        if isinstance(node.func, ast.Attribute):
            recv = self._eval(node.func.value)

        # --- step lattice: a call RETURN is not assumed per-step (an
        # arbitrary function laundering a counter into a fixed-shape
        # array is the common case — init_state(shape), rng.randint).
        # len() seeds; int()/float() keep the scalar a scalar; and a
        # SHAPE-taking constructor fed a per-step dim yields a per-step
        # SHAPE (np.zeros(n) stays hazardous however many names it
        # passes through before reaching a graph-keyed wrapper).
        step, schain = False, ()
        if fname == "len":
            step = True
            schain = ("line %d: len(%s) — un-bucketed size"
                      % (node.lineno, self._snippet(node)),)
        elif fname in ("int", "float", "abs", "round", "min", "max") \
                and any(a.step for a in args):
            step = True
            schain = next(a.schain for a in args if a.step)
        elif fname in SHAPE_CTORS and any(a.step for a in args):
            step = True
            schain = next(a.schain for a in args if a.step) + (
                "line %d: %s(...) shape derives from a per-step scalar"
                % (node.lineno, fname),)
        if "bucket" in fname.lower():
            # routed through a bucketing helper: shape-stable by contract
            step, schain = False, ()
        if fname in ("len", "int", "float", "bool", "str", "round"):
            # a Python scalar: on the host, whatever it was made from
            return Val(HOST, (), step, schain)

        # --- device lattice
        if fname.startswith(_DEVICE_CALL_PREFIXES) or fname in _DEVICE_CALLS:
            return Val(DEVICE, ("line %d: %s(...) constructs a device array"
                                % (node.lineno, fname),), step, schain)
        leaf = fname.rsplit(".", 1)[-1]
        if leaf in KERNEL_WRAPPERS:
            return Val(DEVICE, ("line %d: %s(...) — a kernel wrapper's "
                                "output" % (node.lineno, fname),),
                       step, schain)
        if fname.startswith("torch."):
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            if leaf in _TORCH_CTORS and _device_arg(kw.get("device")):
                return Val(DEVICE, ("line %d: %s(..., device=...) "
                                    "constructs a tensor on the card"
                                    % (node.lineno, fname),), step, schain)
            if leaf in _TORCH_LIKE and args and args[0].dev == DEVICE \
                    and not _host_device(kw.get("device")):
                return Val(DEVICE, args[0].chain + (
                    "line %d: %s(...) of a device value"
                    % (node.lineno, fname),), step, schain)
            if any(a.dev == DEVICE for a in args):
                src = next(a for a in args if a.dev == DEVICE)
                return Val(DEVICE, src.chain + (
                    "line %d: %s(...) over a device value"
                    % (node.lineno, fname),), step, schain)
        if isinstance(node.func, ast.Attribute):
            m = node.func.attr
            if m in _HOST_METHODS:
                return Val(HOST, (), step, schain)
            if m == "cuda" or (m == "to" and (
                    any(_device_arg(a) for a in node.args)
                    or any(k.arg == "device" and _device_arg(k.value)
                           for k in node.keywords))):
                return Val(DEVICE, ("line %d: .%s(...) moves a tensor to "
                                    "the card" % (node.lineno, m),),
                           step, schain)
            if m in _DEVICE_RETURN_METHODS:
                return Val(DEVICE,
                           ("line %d: .%s() returns executor/device outputs"
                            % (node.lineno, m),), step, schain, listy=True)
            if recv is not None and recv.dev == DEVICE:
                if m in _DEVICE_METHODS:
                    return Val(DEVICE, recv.chain + (
                        "line %d: .%s() of a device value" % (node.lineno,
                                                              m),),
                               step, schain)
                return Val(UNKNOWN, (), step, schain)
        if fname.startswith(("np.", "numpy.")):
            return Val(HOST, (), step, schain)
        if isinstance(node.func, ast.Name):
            summ = self.summaries.get(node.func.id)
            if summ:
                return Val(DEVICE,
                           ("line %d: %s() returns a device value "
                            "(same-file summary)" % (node.lineno,
                                                     node.func.id),),
                           step, schain)
        return Val(UNKNOWN, (), step, schain)


class FileFlow:
    """Dataflow for every function in one file, plus same-file
    call-return summaries (two passes: summaries from pass 1 feed the
    propagation of pass 2)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.functions = [n for n in ctx.nodes
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        first = {f: FunctionFlow(ctx, f) for f in self.functions}
        self.summaries = {}
        for f, flow in first.items():
            if self._returns_device(f, flow):
                self.summaries[f.name] = True
        self.flows = {f: FunctionFlow(ctx, f, summaries=self.summaries)
                      for f in self.functions}
        # module-level statements are a scope too (scripts under tools/,
        # module-scope graph wrappers): FunctionFlow already knows how to
        # walk an ast.Module body
        self.module_flow = FunctionFlow(ctx, ctx.tree,
                                        summaries=self.summaries)
        self._by_id = {}
        for flow in self.flows.values():
            self._by_id.update(flow.values)
        self._by_id.update(self.module_flow.values)

    @staticmethod
    def _returns_device(fnode, flow):
        for n in ast.walk(fnode):
            if isinstance(n, ast.Return) and n.value is not None:
                v = flow.values.get(id(n.value))
                if v is not None and v.dev == DEVICE:
                    return True
        return False

    def val(self, node):
        """The Val computed for ``node``, or None if the walk never
        evaluated it (module-level code, nested lambdas)."""
        return self._by_id.get(id(node))

    def flow_of(self, fnode):
        return self.flows.get(fnode)


def analyze(ctx):
    """Cached FileFlow for a FileContext (one dataflow pass per file no
    matter how many rules consult it)."""
    flow = getattr(ctx, "_dataflow", None)
    if flow is None:
        flow = ctx._dataflow = FileFlow(ctx)
    return flow
