"""The pass implementations (counterpart of
``mxnet_tpu/graphpass/passes.py``; see the package doc for the pipeline
contract). Every pass copies the incoming Symbol's nodes (:func:`_clone`)
and mutates the copy — callers never observe a half-rewritten graph.

Ground rules shared by every pass:

* **output nodes are pinned**: a node referenced by ``sym._entries`` is
  never replaced or renamed — ``list_outputs()`` strings are part of the
  Module/metric binding surface;
* **variables are never created or destroyed**: the arg/aux name sets are
  the executor's binding contract (checked again by ``optimize``);
* **numerics-preserving**: rewrites are exact (identity elimination,
  commutative operand swap, CSE of deterministic stateless ops) or
  reassociations of scalar constants whose error is bounded well inside
  the 1e-5 golden-test tolerance (scalar-chain folding);
* **stochastic and stateful ops are opaque**: Dropout and the sampling
  ops draw from the device's generator in graph order and BatchNorm
  mutates aux state — neither is merged, moved, or folded. An op whose
  randomness depends on its attrs (``LeakyReLU``'s rrelu, ``RNN``'s
  dropout) counts as stochastic whatever its attrs, as it does in the JAX
  package, so both packages merge the same nodes.
"""
from __future__ import annotations

import ast
import hashlib

from .. import telemetry
from ..base import attr_str
from ..ops.registry import get_op
from ..symbol import Symbol, _Node, _topo_order

from . import register_pass

# binary elementwise ops where operand order is numerically irrelevant
# (IEEE add/mul/max/min commute exactly; n-ary add_n is excluded — sorting
# its operands reorders the float summation)
_COMMUTATIVE = frozenset((
    "elemwise_add", "elemwise_mul", "_maximum", "_minimum",
    "broadcast_add", "broadcast_plus", "broadcast_mul",
    "broadcast_maximum", "broadcast_minimum",
))

# pointwise ops a loop fusion would merge: the fuse_elemwise pass groups
# chains of these for attribution (the annotation changes no numerics and
# lowers nothing; the group records where a fused kernel could go)
_ELEMWISE = frozenset((
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_power_scalar", "_rpower_scalar",
    "_maximum", "_minimum", "_maximum_scalar", "_minimum_scalar",
    "Activation", "relu", "sigmoid", "tanh", "softsign", "negative",
    "abs", "exp", "expm1", "log", "log1p", "log2", "log10", "sqrt",
    "rsqrt", "square", "cbrt", "rcbrt", "reciprocal", "erf", "sign",
    "floor", "ceil", "round", "rint", "fix", "trunc", "clip",
    "degrees", "radians", "sin", "cos", "tan", "sinh", "cosh",
    "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
    "smooth_l1", "_copy", "identity",
))

# scalar-op identities: applying the op with this scalar is a no-op
_IDENTITY_SCALAR = {
    "_mul_scalar": 1.0,
    "_div_scalar": 1.0,
    "_plus_scalar": 0.0,
    "_minus_scalar": 0.0,
    "_power_scalar": 1.0,
}

# init ops producing a uniform constant tensor, and the value they hold
_INIT_VALUE = {
    "_zeros": lambda attrs: 0.0,
    "_ones": lambda attrs: 1.0,
    "_full": lambda attrs: float(attrs.get("value", 0.0)),
}

# scalar ops foldable onto a uniform constant: value' = f(value, scalar)
_SCALAR_EVAL = {
    "_mul_scalar": lambda v, s: v * s,
    "_plus_scalar": lambda v, s: v + s,
    "_minus_scalar": lambda v, s: v - s,
    "_rminus_scalar": lambda v, s: s - v,
    "_div_scalar": lambda v, s: v / s,
    "_rdiv_scalar": lambda v, s: s / v if v != 0.0 else None,
    "_power_scalar": lambda v, s: v ** s,
}


def _clone(sym):
    """``sym``'s graph with new nodes that share the input's ``attrs``
    dicts: a pass gives a node new attrs, it never edits them, so a node
    it leaves alone keeps the attrs object a caller may know it by
    (``test_utils.installed_decisions`` keys its choices on them)."""
    mapping = {}
    for node in _topo_order(sym._entries):
        mapping[id(node)] = _Node(
            node.op, node.name, node.attrs,
            [(mapping[id(i)], k) for i, k in node.inputs],
            dict(node._extra_attrs))
    return Symbol([(mapping[id(n)], k) for n, k in sym._entries])


def _stochastic(op):
    """Whether ``op`` may draw random numbers for some attrs (the JAX
    package's ``Operator.stochastic`` flag)."""
    st = op._stochastic
    return True if callable(st) else bool(st)


def _pinned(sym):
    return {id(n) for n, _ in sym._entries}


def _count_nodes(sym):
    return len(_topo_order(sym._entries))


def structural_hash(sym_or_node, _memo=None):
    """Content hash of a node's subtree (or a Symbol's whole graph):
    op + canonical attrs + recursively-hashed inputs. Variables hash by
    name. Used as the deterministic sort key for commutative-operand
    canonicalization and as the CSE value number."""
    if isinstance(sym_or_node, Symbol):
        memo = {}
        parts = ["%s#%d" % (_node_hash(n, memo), k)
                 for n, k in sym_or_node._entries]
        return hashlib.sha1("|".join(parts).encode()).hexdigest()
    return _node_hash(sym_or_node, _memo if _memo is not None else {})


def _node_hash(node, memo):
    h = memo.get(id(node))
    if h is not None:
        return h
    # iterative post-order: zoo graphs (inception_resnet_v2 ~1500 nodes)
    # would blow the recursion limit
    stack = [node]
    while stack:
        n = stack[-1]
        if id(n) in memo:
            stack.pop()
            continue
        missing = [i for i, _ in n.inputs if id(i) not in memo
                   and not i.is_variable]
        if missing:
            stack.extend(missing)
            continue
        stack.pop()
        if n.is_variable:
            memo[id(n)] = hashlib.sha1(
                ("var:%s" % n.name).encode()).hexdigest()[:16]
            continue
        parts = [n.op]
        parts.extend("%s=%s" % (k, attr_str(v))
                     for k, v in sorted(n.attrs.items()))
        for inp, k in n.inputs:
            ih = memo.get(id(inp)) if not inp.is_variable else \
                hashlib.sha1(("var:%s" % inp.name).encode()).hexdigest()[:16]
            memo.setdefault(id(inp), ih)
            parts.append("%s#%d" % (ih, k))
        memo[id(n)] = hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]
    return memo[id(node)]


# ---------------------------------------------------------------------------
# canonicalize
# ---------------------------------------------------------------------------


@register_pass("canonicalize")
def canonicalize(sym):
    """Stable structural form: operands of commutative binary ops are
    sorted by subtree content hash, so ``a + b`` and ``b + a`` — and any
    construction-order difference upstream of them — produce the same
    post-pass digest. This is what makes digest-equal mean
    structurally-equal for the compile-cache key."""
    g = _clone(sym)
    memo = {}
    for node in _topo_order(g._entries):
        if node.is_variable or node.op not in _COMMUTATIVE:
            continue
        op = get_op(node.op)
        if len(node.inputs) != 2 or op.aux_names(node.attrs):
            continue
        keyed = [(_node_hash(i, memo), k, (i, k)) for i, k in node.inputs]
        node.inputs = [e for _, _, e in sorted(keyed, key=lambda t: t[:2])]
        # ancestors hash over the sorted form
        memo.pop(id(node), None)
    return g


# ---------------------------------------------------------------------------
# fold_constants
# ---------------------------------------------------------------------------


@register_pass("fold_constants")
def fold_constants(sym):
    """Identity elimination (``x*1``, ``x+0``, ``x**1`` — bit-exact),
    scalar-chain folding (``(x*a)*b -> x*(a*b)``,
    ``(x+a)-b -> x+(a-b)``), and constant folding of scalar ops applied
    to uniform init tensors (``_ones(s)*2 -> _full(s, 2)``). Dead nodes
    fall out of the graph by unreachability."""
    g = _clone(sym)
    pinned = _pinned(g)
    before = _count_nodes(g)
    # entry-level replacement: id(eliminated node) -> the (node, k) entry
    # its consumers should read instead
    repl = {}

    def _resolve(entry):
        node, k = entry
        while id(node) in repl:
            node, k = repl[id(node)]
        return node, k

    for node in _topo_order(g._entries):
        if node.is_variable:
            continue
        node.inputs = [_resolve(e) for e in node.inputs]
        if id(node) in pinned or len(node.inputs) != 1:
            continue
        scalar = node.attrs.get("scalar")
        inp, k = node.inputs[0]
        # 1) identity scalar op: drop the node entirely
        if node.op in _IDENTITY_SCALAR and \
                scalar == _IDENTITY_SCALAR[node.op]:
            repl[id(node)] = (inp, k)
            continue
        if inp.is_variable or id(inp) in pinned:
            continue
        # 2) same-family scalar chains collapse onto this node
        if scalar is not None and len(inp.inputs) == 1:
            in_scalar = inp.attrs.get("scalar")
            if in_scalar is not None:
                if node.op == "_mul_scalar" and inp.op == "_mul_scalar":
                    node.attrs = dict(node.attrs,
                                      scalar=float(in_scalar) * float(scalar))
                    node.inputs = [inp.inputs[0]]
                    continue
                addish = {"_plus_scalar": 1.0, "_minus_scalar": -1.0}
                if node.op in addish and inp.op in addish:
                    net = addish[inp.op] * float(in_scalar) \
                        + addish[node.op] * float(scalar)
                    node.op = "_plus_scalar"
                    node.attrs = get_op("_plus_scalar").canonicalize_attrs(
                        {"scalar": net})[0]
                    node.inputs = [inp.inputs[0]]
                    continue
        # 3) scalar op over a uniform init tensor folds to _full
        if node.op in _SCALAR_EVAL and inp.op in _INIT_VALUE \
                and not inp.inputs:
            new_val = _SCALAR_EVAL[node.op](_INIT_VALUE[inp.op](inp.attrs),
                                            float(scalar))
            if new_val is None:
                continue
            attrs = {"shape": inp.attrs.get("shape", ()),
                     "value": new_val}
            if inp.attrs.get("dtype") is not None:
                attrs["dtype"] = inp.attrs["dtype"]
            node.op = "_full"
            node.attrs = get_op("_full").canonicalize_attrs(attrs)[0]
            node.inputs = []
    g._entries = [_resolve(e) for e in g._entries]
    eliminated = before - _count_nodes(g)
    if eliminated:
        telemetry.counter("graphpass.nodes_eliminated",
                          **{"pass": "fold_constants"}).inc(eliminated)
    return g


# ---------------------------------------------------------------------------
# eliminate_common_subexpr (CSE)
# ---------------------------------------------------------------------------


@register_pass("eliminate_common_subexpr")
def eliminate_common_subexpr(sym):
    """Merge structurally identical deterministic nodes: same op, same
    canonical attrs, same input entries. Stochastic ops (per-node rng
    streams) and aux-mutating ops (BatchNorm) are never merged; output
    nodes are pinned (their names are the output surface)."""
    g = _clone(sym)
    pinned = _pinned(g)
    before = _count_nodes(g)
    repl = {}   # id(duplicate node) -> surviving node
    table = {}  # value number -> surviving node
    for node in _topo_order(g._entries):
        if node.is_variable:
            continue
        node.inputs = [(repl.get(id(i), i), k) for i, k in node.inputs]
        op = get_op(node.op)
        if _stochastic(op) or op.aux_names(node.attrs):
            continue
        key = (node.op,
               tuple(sorted((k, attr_str(v))
                            for k, v in node.attrs.items())),
               tuple((id(i), k) for i, k in node.inputs))
        prev = table.get(key)
        if prev is None:
            table[key] = node
        elif id(node) not in pinned:
            repl[id(node)] = prev
    g._entries = [(repl.get(id(n), n), k) for n, k in g._entries]
    eliminated = before - _count_nodes(g)
    if eliminated:
        telemetry.counter("graphpass.nodes_eliminated",
                          **{"pass": "eliminate_common_subexpr"}).inc(
            eliminated)
    return g


# ---------------------------------------------------------------------------
# fuse_elemwise
# ---------------------------------------------------------------------------


@register_pass("fuse_elemwise")
def fuse_elemwise(sym):
    """Group chains of pointwise ops under a shared ``__fuse_group__``
    attribute. Purely annotational — the executor still runs every node
    on its own; the groups give telemetry (and a future segment-lowering
    pass) the fusion structure at the Symbol level. A producer joins its
    consumer's group only when the consumer is its sole reader (the
    fusion-legality condition for avoiding recompute)."""
    g = _clone(sym)
    order = _topo_order(g._entries)
    consumers = {}
    for node in order:
        for inp, _ in node.inputs:
            consumers[id(inp)] = consumers.get(id(inp), 0) + 1
    for node, _ in g._entries:
        consumers[id(node)] = consumers.get(id(node), 0) + 1

    parent = {}

    def find(i):
        while parent.get(i, i) != i:
            parent[i] = parent.get(parent[i], parent[i])
            i = parent[i]
        return i

    def union(a, b):
        parent.setdefault(a, a)
        parent.setdefault(b, b)
        parent[find(a)] = find(b)

    for node in order:
        if node.is_variable or node.op not in _ELEMWISE:
            continue
        for inp, _ in node.inputs:
            if not inp.is_variable and inp.op in _ELEMWISE \
                    and consumers.get(id(inp), 0) == 1:
                union(id(inp), id(node))
    groups = {}
    for node in order:
        if node.is_variable or id(node) not in parent:
            continue
        groups.setdefault(find(id(node)), []).append(node)
    fused = 0
    gid = 0
    for node in order:  # stable numbering: by first member's topo index
        root = find(id(node)) if id(node) in parent else None
        members = groups.pop(root, None) if root is not None else None
        if not members or len(members) < 2:
            continue
        for m in members:
            m._extra_attrs["__fuse_group__"] = "g%d" % gid
        fused += len(members)
        gid += 1
    if fused:
        telemetry.counter("graphpass.nodes_fused").inc(fused)
    return g


# ---------------------------------------------------------------------------
# bucket_shapes (opt-in: changes declared bind shapes)
# ---------------------------------------------------------------------------

_BUCKET_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _bucket(n):
    for b in _BUCKET_LADDER:
        if n <= b:
            return b
    return n


@register_pass("bucket_shapes")
def bucket_shapes(sym):
    """Round every Variable-declared batch dimension (``__shape__`` dim 0)
    up to the next bucket so nearby batch sizes share one compiled
    program. OPT-IN ONLY (``MXNET_GRAPH_PASSES=default,bucket_shapes``):
    consumers must pad their batches to the bucketed shape — this pass
    changes what ``simple_bind`` allocates, not just how it runs."""
    g = _clone(sym)
    changed = 0
    for node in _topo_order(g._entries):
        if not node.is_variable:
            continue
        raw = node._extra_attrs.get("__shape__")
        if not raw:
            continue
        shape = tuple(ast.literal_eval(raw))
        if not shape or not isinstance(shape[0], int) or shape[0] <= 0:
            continue
        b = _bucket(shape[0])
        if b != shape[0]:
            node._extra_attrs["__shape__"] = str((b,) + tuple(shape[1:]))
            changed += 1
    if changed:
        telemetry.counter("graphpass.shapes_bucketed").inc(changed)
    return g
