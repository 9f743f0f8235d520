"""fwlint checkers — each rule encodes a bug class the framework has shipped
(the port's copy of ``mxnet_tpu/analysis/checkers.py``).

Rule catalog. Eleven rules are the JAX package's, with its semantics and
messages; four replace its JAX-specific rules with the port's CUDA-graph
counterparts (``ROADMAP.md`` C25-C28 say what differs):

* ``env-raw-read``        raw ``MXNET_*`` env reads crash on garbage values;
                          the ``base.env_*`` helpers are mandatory outside
                          ``base.py``.
* ``bare-except``         ``except:`` catches KeyboardInterrupt/SystemExit.
* ``swallowed-exception`` a broad handler whose body is only ``pass``/
                          ``continue`` drops the only trace of a failure.
* ``thread-hygiene``      every ``threading.Thread`` must be named and
                          daemonized-or-joined.
* ``lock-discipline``     attributes annotated ``# guarded-by: <lock>``
                          must be touched under ``with <lock>``.
* ``lock-order``          whole-repo lock-acquisition graph (lockgraph.py):
                          cycles and blocking calls under a shared lock.
* ``mutable-default-arg`` the classic shared-default footgun.
* ``unguarded-shared-write`` / ``check-then-act`` / ``unbalanced-acquire``
  / ``guard-mismatch``    the concurrency pass (concurrency.py).
* ``host-sync``           (JAX: ``device-escape``) a device->host sync in
                          the port's hot path (``module/``, ``serving/``,
                          ``executor.py``, ``executor_manager.py``,
                          ``parallel/spmd.py``): ``.cpu()`` / ``.asnumpy()``
                          / ``.asscalar()`` on anything not proven host,
                          ``.item()`` / ``.tolist()`` / ``.numpy()`` /
                          ``float``/``int``/``bool`` / truthiness /
                          ``np.*`` (``np.asarray`` included) / formatting
                          of a tracked device value, and every
                          ``torch.cuda.synchronize``.
* ``untracked-capture``   (JAX: ``untracked-jit``) a CUDA-graph capture
                          (``torch.cuda.CUDAGraph()``, ``torch.cuda.graph``,
                          ``capture_begin``, ``make_graphed_callables``), a
                          ``torch.compile`` or an ``nvcc`` build outside
                          ``compileobs.record_compile``/``note_compile``:
                          a program the registry never sees.
* ``capture-impure``      (JAX: ``trace-impure``) inside a function reached
                          from a CUDA-graph capture body: a host effect that
                          runs once at capture and never on replay, a host
                          sync, or a CUDA runtime call that ends the capture;
                          and a capture that leaves the garbage collector on.
* ``recapture-hazard``    (JAX: ``recompile-hazard``) a graph key or a
                          graph's argument derived from a per-step Python
                          scalar or an un-bucketed size: a fresh capture
                          per value.

Checkers are plain callables ``(FileContext) -> [Finding]`` with a ``rules``
attribute; ``CHECKERS`` is the registry the driver iterates. Repo-scope
checkers (``(list[FileContext]) -> [Finding]``) live in ``REPO_CHECKERS``
— they see every file at once (lock-order's acquisition graph,
capture-impure's cross-file call closure).
"""
from __future__ import annotations

import ast
import re

from .fwlint import Finding, import_alias_map as _import_alias_map
from .dataflow import DEVICE, HOST, FunctionFlow, dotted_name, \
    analyze as _analyze
from .lockgraph import build as _build_lock_graph, \
    _lock_ctor

__all__ = ["CHECKERS", "REPO_CHECKERS"]

# the one module allowed to touch os.environ for MXNET_* keys: it hosts the
# env_* helpers themselves
ENV_HELPER_FILE = "mxnet_tpu_torch/base.py"

# the training step path: Module forward/backward/update, the executor
# plumbing and the fused step's trainer, plus the serving engine's
# prefill/decode loop (its token egress is inline-suppressed with a reason)
HOT_PATH_PREFIXES = ("mxnet_tpu_torch/module/", "mxnet_tpu_torch/serving/")
HOT_PATH_FILES = ("mxnet_tpu_torch/executor.py",
                  "mxnet_tpu_torch/executor_manager.py",
                  "mxnet_tpu_torch/parallel/spmd.py")

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")


def _checker(*rules):
    def deco(fn):
        fn.rules = rules
        return fn
    return deco


# the one shared name resolver (dataflow.dotted_name) under the package's
# historical local alias
_name_of = dotted_name


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# env-raw-read
# ---------------------------------------------------------------------------

def _is_environ(node):
    return _name_of(node) in ("os.environ", "environ")


@_checker("env-raw-read")
def check_env_raw_read(ctx):
    if ctx.path == ENV_HELPER_FILE:
        return []
    out = []

    def flag(node, key):
        out.append(Finding(
            "env-raw-read", ctx.path, node.lineno, node.col_offset,
            "raw read of %s: use base.env_int/env_float/env_bool/env_str "
            "(garbage values must warn + default, not crash)" % key,
            context=ctx.qualnames.get(node, "")))

    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            fname = _name_of(node.func)
            key = None
            if fname in ("os.environ.get", "environ.get", "os.getenv",
                         "getenv") and node.args:
                key = _const_str(node.args[0])
            if key and key.startswith("MXNET_"):
                flag(node, key)
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                            ast.Load):
            if _is_environ(node.value):
                key = _const_str(node.slice)
                if key and key.startswith("MXNET_"):
                    flag(node, key)
    return out


# ---------------------------------------------------------------------------
# bare-except / swallowed-exception
# ---------------------------------------------------------------------------

_BROAD = ("Exception", "BaseException")


def _is_broad_handler(handler):
    if handler.type is None:
        return True
    if isinstance(handler.type, ast.Tuple):
        return any(_name_of(e).split(".")[-1] in _BROAD
                   for e in handler.type.elts)
    return _name_of(handler.type).split(".")[-1] in _BROAD


def _body_swallows(body):
    return all(isinstance(s, (ast.Pass, ast.Continue)) for s in body)


def _has_raise(body):
    return any(isinstance(n, ast.Raise)
               for s in body for n in ast.walk(s))


@_checker("bare-except", "swallowed-exception")
def check_excepts(ctx):
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        qn = ctx.qualnames.get(node, "")
        if _is_broad_handler(node) and _body_swallows(node.body):
            out.append(Finding(
                "swallowed-exception", ctx.path, node.lineno,
                node.col_offset,
                "broad except whose body is only pass/continue drops the "
                "only trace of a failure: narrow the clause, log, or count "
                "it in telemetry (suppress with a reason if intentional)",
                context=qn))
        elif node.type is None and not _has_raise(node.body):
            out.append(Finding(
                "bare-except", ctx.path, node.lineno, node.col_offset,
                "bare except catches KeyboardInterrupt/SystemExit: catch "
                "Exception (or narrower), or re-raise",
                context=qn))
    return out


# ---------------------------------------------------------------------------
# thread-hygiene
# ---------------------------------------------------------------------------

def _is_thread_ctor(node):
    return isinstance(node, ast.Call) and _name_of(node.func) in (
        "threading.Thread", "Thread")


def _assign_targets_of(ctx, node):
    """Names the Thread() value ends up bound to: climbs through list/tuple
    displays and comprehensions to the enclosing Assign, and recognizes
    ``xs.append(Thread(...))``."""
    names = set()
    cur = node
    for parent in ctx.ancestors(node):
        if isinstance(parent, ast.Call) and cur is not node:
            break  # the value was consumed by some other call — give up
        if isinstance(parent, ast.Call) and _name_of(parent.func).endswith(
                ".append"):
            owner = parent.func.value
            names.add(owner.attr if isinstance(owner, ast.Attribute)
                      else _name_of(owner))
            break
        if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (parent.targets if isinstance(parent, ast.Assign)
                       else [parent.target])
            for t in targets:
                if isinstance(t, ast.Attribute):
                    names.add(t.attr)
                elif isinstance(t, ast.Name):
                    names.add(t.id)
            break
        if not isinstance(parent, (ast.List, ast.Tuple, ast.ListComp,
                                   ast.GeneratorExp, ast.comprehension,
                                   ast.IfExp, ast.Starred)):
            break
        cur = parent
    return names


@_checker("thread-hygiene")
def check_thread_hygiene(ctx):
    joined, daemonized = set(), set()
    for node in ctx.nodes:
        if isinstance(node, ast.Call) and _name_of(node.func).endswith(
                ".join"):
            owner = node.func.value
            joined.add(owner.attr if isinstance(owner, ast.Attribute)
                       else _name_of(owner))
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon":
                    owner = t.value
                    daemonized.add(owner.attr
                                   if isinstance(owner, ast.Attribute)
                                   else _name_of(owner))
    out = []
    for node in ctx.nodes:
        if not _is_thread_ctor(node):
            continue
        qn = ctx.qualnames.get(node, "")
        kwargs = {k.arg: k.value for k in node.keywords if k.arg}
        if "name" not in kwargs:
            out.append(Finding(
                "thread-hygiene", ctx.path, node.lineno, node.col_offset,
                "threading.Thread without name=: stall dumps and py-spy "
                "output cannot attribute an anonymous thread",
                context=qn))
        daemon = kwargs.get("daemon")
        is_daemon = daemon is not None and not (
            isinstance(daemon, ast.Constant) and daemon.value is False)
        if not is_daemon:
            targets = _assign_targets_of(ctx, node)
            if not (targets & (joined | daemonized)):
                out.append(Finding(
                    "thread-hygiene", ctx.path, node.lineno,
                    node.col_offset,
                    "non-daemon threading.Thread that is never joined (and "
                    "never set .daemon): a forgotten one hangs interpreter "
                    "exit — pass daemon=True or join it",
                    context=qn))
    return out


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

def _lock_aliases(ctx, node):
    """Local names aliasing a lock at ``node``'s scope: for every simple
    ``alias = self.<lock>`` / ``alias = <lock>`` / ``alias = mod.<lock>``
    assignment in the enclosing function, map alias -> lock's bare name.
    Without them ``lk = self._lock; with lk:`` would escape checking
    entirely."""
    fn = None
    for parent in ctx.ancestors(node):
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = parent
            break
    if fn is None:
        return {}
    aliases = {}
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign):
            continue
        src = n.value
        ent = None
        if isinstance(src, ast.Attribute):
            # the source KIND travels with the alias: `lk = self._lock`
            # must never satisfy a module-level guarded-by "_lock"
            kind = "self" if _name_of(src.value) == "self" else "mod"
            ent = (kind, src.attr)
        elif isinstance(src, ast.Name):
            ent = ("bare", src.id)
        if ent is None:
            continue
        # no name-shape filter: an alias of ANY attr resolves — a bogus
        # entry can only ever name the wrong lock (no match), never
        # invent a held lock the source didn't reference
        for t in n.targets:
            if isinstance(t, ast.Name):
                aliases[t.id] = ent
    return aliases


def _with_locks(ctx, node):
    """``(kind, name)`` pairs held at ``node`` — kind ``self`` for
    ``with self.<lock>``, ``mod`` for ``with other.<lock>``, ``bare``
    for ``with <lock>`` — with local aliases resolved to their SOURCE
    kind (:func:`_lock_aliases`)."""
    held = set()
    aliases = None
    for parent in ctx.ancestors(node):
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            for item in parent.items:
                expr = item.context_expr
                if isinstance(expr, ast.Attribute):
                    kind = "self" if _name_of(expr.value) == "self" \
                        else "mod"
                    held.add((kind, expr.attr))
                elif isinstance(expr, ast.Name):
                    if aliases is None:
                        aliases = _lock_aliases(ctx, node)
                    held.add(aliases.get(expr.id, ("bare", expr.id)))
    return held


def _check_guarded_set(ctx, guarded, nodes, describe, module_scope=False,
                       self_owned=()):
    out = []
    for node, name in nodes:
        lock, decl_lines = guarded[name]
        if node.lineno in decl_lines:
            continue
        held = _with_locks(ctx, node)
        if module_scope:
            # a module-level guarded name needs the MODULE lock: an
            # unrelated class's same-named `with self._lock:` must not
            # satisfy it
            ok = any(n_ == lock and k != "self" for k, n_ in held)
        elif lock in self_owned:
            # ... and symmetrically, a class-OWNED lock (self.<lock>
            # constructed in the class) is only satisfied by the
            # instance lock, not a same-named module-level `with _lock:`
            ok = ("self", lock) in held
        else:
            ok = any(n_ == lock for _k, n_ in held)
        if not ok:
            out.append(Finding(
                "lock-discipline", ctx.path, node.lineno,
                node.col_offset,
                "%s is annotated guarded-by: %s but accessed outside "
                "`with %s`" % (describe % name, lock, lock),
                context=ctx.qualnames.get(node, "")))
    return out


def _collect_guarded(ctx, scope, target_pred):
    """{name: (lock, {declaration lines})} for guarded-by-annotated
    assignments under ``scope`` whose targets satisfy ``target_pred``;
    re-annotation conflicts come back as findings."""
    guarded, out = {}, []
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        m = _GUARDED_BY_RE.search(ctx.comments.get(node.lineno, ""))
        if not m:
            continue
        for t in node.targets:
            name = target_pred(t, node)
            if name is None:
                continue
            lock, lines = guarded.setdefault(name, (m.group(1), set()))
            if lock != m.group(1):
                out.append(Finding(
                    "lock-discipline", ctx.path, node.lineno,
                    node.col_offset,
                    "%s re-annotated with a different lock (%s vs %s)"
                    % (name, m.group(1), lock),
                    context=ctx.qualnames.get(node, "")))
            lines.add(node.lineno)
    return guarded, out


@_checker("lock-discipline")
def check_lock_discipline(ctx):
    out = []
    # class half: self.<attr> annotations checked across the class
    for cls in ctx.nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded, conflicts = _collect_guarded(
            ctx, cls,
            lambda t, node: t.attr if isinstance(t, ast.Attribute)
            and _name_of(t.value) == "self" else None)
        out.extend(conflicts)
        if not guarded:
            continue
        # locks the class itself CONSTRUCTS (self._lock = Lock()) can
        # only be satisfied by the instance lock
        self_owned = set()
        for n in ast.walk(cls):
            if isinstance(n, ast.Assign) and _lock_ctor(n.value):
                # lockgraph's detector, so lock-discipline and the
                # lock-order graph can never disagree on what is a lock
                for t in n.targets:
                    if isinstance(t, ast.Attribute) \
                            and _name_of(t.value) == "self":
                        self_owned.add(t.attr)
        accesses = [(n, n.attr) for n in ast.walk(cls)
                    if isinstance(n, ast.Attribute)
                    and _name_of(n.value) == "self" and n.attr in guarded]
        out.extend(_check_guarded_set(ctx, guarded, accesses, "self.%s",
                                      self_owned=self_owned))
    # module half: module-level names annotated beside
    # their declaration — telemetry-style `_STATE = {}  # guarded-by: _lock`
    def _module_target(t, node):
        if isinstance(t, ast.Name) and ctx.qualnames.get(node) == \
                "<module>":
            return t.id
        return None

    guarded, conflicts = _collect_guarded(ctx, ctx.tree, _module_target)
    out.extend(conflicts)
    if guarded:
        # Python scoping, not bare-name matching: a function that BINDS
        # the name locally (and doesn't declare it global) shadows the
        # guarded module global — its accesses are a different variable
        shadow_cache = {}

        def _shadowed(node, name):
            fn = None
            for parent in ctx.ancestors(node):
                if isinstance(parent, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    fn = parent
                    break
            if fn is None:
                return False
            key = id(fn)
            if key not in shadow_cache:
                bound, globals_ = set(), set()
                args = fn.args
                for a in (list(getattr(args, "posonlyargs", ()))
                          + list(args.args) + list(args.kwonlyargs)):
                    bound.add(a.arg)
                for n in ast.walk(fn):
                    if isinstance(n, ast.Name) \
                            and isinstance(n.ctx, (ast.Store, ast.Del)):
                        bound.add(n.id)
                    elif isinstance(n, ast.Global):
                        globals_.update(n.names)
                shadow_cache[key] = (bound, globals_)
            bound, globals_ = shadow_cache[key]
            return name in bound and name not in globals_

        accesses = [(n, n.id) for n in ctx.nodes
                    if isinstance(n, ast.Name) and n.id in guarded
                    and ctx.qualnames.get(n) != "<module>"
                    and not _shadowed(n, n.id)]
        out.extend(_check_guarded_set(ctx, guarded, accesses, "%s",
                                      module_scope=True))
    return out


# ---------------------------------------------------------------------------
# host-sync (the port's device-escape: a device->host sync in the hot path)
# ---------------------------------------------------------------------------

# scalar builtins that copy a tensor on the card to the host when applied
# to one (float(t) is Tensor.__float__ = .item(), a blocking transfer)
_ESCAPE_BUILTINS = ("float", "int", "bool", "str")
# explicit sync spellings: flagged unless the receiver is proven host (or
# is a module: ``mx.cpu()`` names the host context)
_EXPLICIT_SYNC_METHODS = ("asnumpy", "asscalar", "cpu")
# methods that sync when their receiver is a tracked device value
_IMPLICIT_SYNC_METHODS = ("tolist", "item", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize", "cuda.synchronize")


def _hot_path(ctx):
    return (ctx.path in HOT_PATH_FILES
            or any(ctx.path.startswith(p) for p in HOT_PATH_PREFIXES))


def _dev(val):
    return val is not None and val.dev == DEVICE


def _truthiness_tests(nodes):
    """id(expr) -> context word for every expression whose truth value
    Python asks for (a device boolean there is a sync)."""
    tests = {}

    def _test(expr, where):
        # a BoolOp/`not` test is covered operand-by-operand: registering
        # the join too would double-report one sync
        if isinstance(expr, ast.BoolOp) or (
                isinstance(expr, ast.UnaryOp)
                and isinstance(expr.op, ast.Not)):
            return
        tests[id(expr)] = where

    for node in nodes:
        if isinstance(node, ast.If):
            _test(node.test, "if")
        elif isinstance(node, ast.While):
            _test(node.test, "while")
        elif isinstance(node, ast.Assert):
            _test(node.test, "assert")
        elif isinstance(node, ast.IfExp):
            _test(node.test, "conditional expression")
        elif isinstance(node, ast.BoolOp):
            for v in node.values:
                _test(v, "and/or")
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            _test(node.operand, "not")
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                _test(cond, "comprehension filter")
    return tests


def _import_names(ctx):
    """Names an import statement binds in this file."""
    out = set()
    for node in ctx.nodes:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


def _host_syncs(ctx, flow, nodes):
    """``(node, what, chain)`` for every device->host sync among ``nodes``
    (``flow.val`` answers for the expressions). Shared by host-sync (over a
    hot-path file) and capture-impure (over a captured function's body)."""
    nodes = list(nodes)
    tests = _truthiness_tests(nodes)
    modules = _import_names(ctx)
    for node in nodes:
        if isinstance(node, ast.Call):
            fname = _name_of(node.func)
            val0 = flow.val(node.args[0]) if node.args else None
            if fname in _SYNC_CALLS:
                yield node, "%s()" % fname, ()
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _EXPLICIT_SYNC_METHODS:
                recv = flow.val(node.func.value)
                module = isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in modules
                if not module and (recv is None or recv.dev != HOST):
                    yield (node, ".%s()" % node.func.attr,
                           recv.chain if recv else ())
                continue
            if fname in _ESCAPE_BUILTINS and node.args and _dev(val0) \
                    and not val0.listy:
                yield (node, "%s() on a tracked device value" % fname,
                       val0.chain)
                continue
            if fname.startswith(("np.", "numpy.")) and any(
                    _dev(flow.val(a)) for a in node.args):
                bad = next(a for a in node.args if _dev(flow.val(a)))
                yield (node, "%s(...) over a tracked device value (host "
                       "ufunc)" % fname, flow.val(bad).chain)
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _IMPLICIT_SYNC_METHODS:
                recv = flow.val(node.func.value)
                if _dev(recv):
                    yield (node, ".%s() on a tracked device value"
                           % node.func.attr, recv.chain)
                continue
            # `if t.any():` forces the device boolean like `if t > 0:`
            if id(node) in tests:
                val = flow.val(node)
                if _dev(val) and not val.listy:
                    yield (node, "truthiness/comparison of a tracked device "
                           "value in `%s`" % tests[id(node)], val.chain)
        elif id(node) in tests:
            val = flow.val(node)
            if _dev(val) and not val.listy:
                yield (node, "truthiness/comparison of a tracked device "
                       "value in `%s`" % tests[id(node)], val.chain)
        elif isinstance(node, ast.FormattedValue):
            val = flow.val(node.value)
            if _dev(val):
                yield (node, "f-string formatting of a tracked device value",
                       val.chain)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            left = node.left
            if isinstance(left, ast.Constant) and isinstance(left.value,
                                                             str):
                val = flow.val(node.right)
                if _dev(val):
                    yield (node, "%-formatting of a tracked device value",
                           val.chain)


@_checker("host-sync")
def check_host_sync(ctx):
    if not _hot_path(ctx):
        return []
    flow = _analyze(ctx)
    return [Finding(
        "host-sync", ctx.path, node.lineno, node.col_offset,
        "%s in hot-path code makes the host wait for the card (and ends "
        "a CUDA-graph capture it runs in); keep the step on the card, or "
        "suppress with a reason for honest host egress" % what,
        context=ctx.qualnames.get(node, ""), chain=chain)
        for node, what, chain in _host_syncs(ctx, flow, ctx.nodes)]


# ---------------------------------------------------------------------------
# untracked-capture (the port's untracked-jit)
# ---------------------------------------------------------------------------

# the modules that run nvcc (or the host compiler) for the package's own
# libraries; each charges its builds to compileobs itself
BUILD_FILES = ("mxnet_tpu_torch/ops/_build.py", "mxnet_tpu_torch/_native.py",
               "mxnet_tpu_torch/_capi.py")
# references that record or compile a program
_CAPTURE_REFS = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph",
                 "torch.cuda.graph", "cuda.graph",
                 "torch.cuda.make_graphed_callables",
                 "torch.compile")
_SUBPROCESS_CALLS = ("subprocess.run", "subprocess.Popen",
                     "subprocess.check_call", "subprocess.check_output",
                     "subprocess.call", "os.system")
_REGISTRY_CALLS = ("record_compile", "note_compile")


def _is_registry_call(node):
    """Call of ``compileobs.record_compile`` / ``note_compile`` (any import
    alias ending in 'compileobs')."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _REGISTRY_CALLS):
        return False
    return _name_of(node.func.value).split(".")[-1].endswith("compileobs")


def _mentions_nvcc(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "nvcc" in n.value.split("/")[-1].split()[:1]:
            return True
        if isinstance(n, (ast.Name, ast.Attribute)) \
                and "nvcc" in _name_of(n).lower():
            return True
    return False


def _local_defs(ctx):
    """bare name -> [FunctionDef] for every def in the file."""
    defs = {}
    for n in ctx.nodes:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(n.name, []).append(n)
    return defs


def _enclosing_def(ctx, node):
    return next((p for p in ctx.ancestors(node)
                 if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))),
                None)


def _tracked_defs(ctx):
    """The defs of this file under the registry: each one that calls
    record_compile/note_compile, closed over the same-file defs they call
    (``self.method()`` or a bare name) — the serving graph's ``_build``
    charges the capture its ``_capture`` helper records."""
    defs = _local_defs(ctx)
    tracked = set()
    work = []
    for node in ctx.nodes:
        if _is_registry_call(node):
            fn = _enclosing_def(ctx, node)
            if fn is not None and fn not in tracked:
                tracked.add(fn)
                work.append(fn)
    while work:
        fn = work.pop()
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            name = (f.id if isinstance(f, ast.Name) else
                    f.attr if isinstance(f, ast.Attribute)
                    and _name_of(f.value) == "self" else None)
            for d in defs.get(name, ()):
                if d not in tracked:
                    tracked.add(d)
                    work.append(d)
    return tracked


@_checker("untracked-capture")
def check_untracked_capture(ctx):
    out = []
    tracked = None
    build_file = ctx.path in BUILD_FILES
    # names a `from torch.cuda import graph` / `from torch import compile`
    # binds in this file
    bare = {}
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom) and node.module in (
                "torch.cuda", "torch"):
            for alias in node.names:
                full = node.module + "." + alias.name
                if full in _CAPTURE_REFS:
                    bare[alias.asname or alias.name] = full
    for node in ctx.nodes:
        what = None
        if isinstance(node, ast.Attribute):
            fname = _name_of(node)
            if fname in _CAPTURE_REFS:
                what = fname
            elif node.attr == "capture_begin" \
                    and isinstance(ctx.parents.get(node), ast.Call):
                what = ".capture_begin()"
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in bare:
            what = bare[node.id]
        elif isinstance(node, ast.Call) and not build_file \
                and _name_of(node.func) in _SUBPROCESS_CALLS \
                and any(_mentions_nvcc(a) for a in node.args):
            what = "an nvcc build"
        if what is None:
            continue
        # `torch.cuda.graph` inside `torch.cuda.graph(...)`'s Attribute
        # chain is one reference, not two
        parent = ctx.parents.get(node)
        if isinstance(parent, ast.Attribute) \
                and _name_of(parent) in _CAPTURE_REFS:
            continue
        if tracked is None:
            tracked = _tracked_defs(ctx)
        fn = _enclosing_def(ctx, node)
        if fn is not None and fn in tracked:
            continue
        out.append(Finding(
            "untracked-capture", ctx.path, node.lineno, node.col_offset,
            "%s outside the compileobs registry: this program gets no "
            "compile accounting or recapture attribution — charge it "
            "through mxnet_tpu_torch.compileobs.record_compile (or "
            "note_compile after the fact)" % what,
            context=ctx.qualnames.get(node, "")))
    return out


# ---------------------------------------------------------------------------
# capture-impure (repo scope: functions reached from a CUDA-graph capture)
# ---------------------------------------------------------------------------

# host effects that run once, at capture, and never on a replay
_IMPURE_CALL_PREFIXES = ("telemetry.", "time.", "random.", "np.random.",
                         "numpy.random.")
_MUTATING_METHODS = ("append", "extend", "add", "update", "pop",
                     "setdefault", "insert", "remove", "clear")
# CUDA runtime calls that are illegal while a stream captures: each ends
# (invalidates) the capture
_CAPTURE_ENDING = ("torch.cuda.synchronize", "cuda.synchronize",
                   "torch.cuda.empty_cache", "cuda.empty_cache",
                   "torch.cuda.Stream", "cuda.Stream", "torch.cuda.Event",
                   "cuda.Event")


def _is_capture_with(item):
    """``with torch.cuda.graph(...)`` (any spelling ending in
    ``cuda.graph``, or a bare ``graph(...)`` imported from torch.cuda)."""
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    name = _name_of(expr.func)
    return name.endswith("cuda.graph") or name == "graph"


def _capture_sites(ctx):
    """``(with node, enclosing def)`` for every capture body in the file."""
    out = []
    for node in ctx.nodes:
        if isinstance(node, (ast.With, ast.AsyncWith)) \
                and any(_is_capture_with(i) for i in node.items):
            out.append((node, _enclosing_def(ctx, node)))
    return out


def _gc_disabled_before(fn, with_node):
    """True when ``fn`` calls ``gc.disable()`` before the capture begins."""
    if fn is None:
        return False
    return any(isinstance(n, ast.Call) and _name_of(n.func) == "gc.disable"
               and n.lineno <= with_node.lineno for n in ast.walk(fn))


def _param_callers(ctx, fn, pname):
    """The callables passed as parameter ``pname`` of ``fn`` at its call
    sites in the same file (``self._capture_slot(g, lambda: ...)``)."""
    params = [a.arg for a in fn.args.args]
    if pname not in params:
        return []
    pos = params.index(pname)
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = (f.id if isinstance(f, ast.Name) else
                f.attr if isinstance(f, ast.Attribute) else None)
        if name != fn.name:
            continue
        off = 1 if (isinstance(f, ast.Attribute)
                    and _name_of(f.value) in ("self", "cls")) else 0
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        arg = kw.get(pname)
        if arg is None and 0 <= pos - off < len(node.args):
            arg = node.args[pos - off]
        if arg is not None:
            out.append(arg)
    return out


def _call_targets(ctx, defs, imports, by_path, call):
    """``(ctx, def)`` targets of one call: bare names and nested defs
    same-file, ``self.m()`` within the file, ``alias.fn()`` through
    imports, and a lambda's own calls."""
    f = call.func
    out = []
    if isinstance(f, ast.Name):
        out = [(ctx, d) for d in defs[ctx.path].get(f.id, ())]
    elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id in ("self", "cls"):
            out = [(ctx, d) for d in defs[ctx.path].get(f.attr, ())]
        else:
            tpath = imports[ctx.path].get(f.value.id)
            if tpath:
                tctx = by_path[tpath]
                out = [(tctx, d) for d in defs[tpath].get(f.attr, ())
                       if tctx.qualnames[d] == d.name]
    return out


def _reaching_capture(ctxs):
    """BFS over the call graph from every capture body: yields
    ``(ctx, node, root)`` where ``node`` is the capture ``with`` itself or
    a function whose body runs while the stream captures. A call of a
    parameter of the capturing function resolves through the function's
    same-file call sites (the fused step's ``fn`` is the lambda its
    caller passes)."""
    by_path = {c.path: c for c in ctxs}
    paths = set(by_path)
    defs = {c.path: _local_defs(c) for c in ctxs}
    imports = {c.path: _import_alias_map(c, paths) for c in ctxs}
    seen = set()
    work = []

    def push(tctx, d, root):
        key = (tctx.path, id(d))
        if key not in seen:
            seen.add(key)
            work.append((tctx, d, root))

    for ctx in ctxs:
        for wnode, encl in _capture_sites(ctx):
            root = "%s:%d" % (ctx.path, wnode.lineno)
            push(ctx, wnode, root)
    i = 0
    while i < len(work):
        ctx, node, root = work[i]
        i += 1
        body = node.body if not isinstance(node, ast.Lambda) \
            else [node.body]
        encl = node if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
            else _enclosing_def(ctx, node)
        for stmt in body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                targets = _call_targets(ctx, defs, imports, by_path, n)
                if not targets and isinstance(n.func, ast.Name) \
                        and encl is not None:
                    for arg in _param_callers(ctx, encl, n.func.id):
                        if isinstance(arg, ast.Lambda):
                            push(ctx, arg, root)
                        elif isinstance(arg, (ast.Name, ast.Attribute)):
                            fake = ast.Call(func=arg, args=[], keywords=[])
                            for t in _call_targets(ctx, defs, imports,
                                                   by_path, fake):
                                push(t[0], t[1], root)
                for t in targets:
                    push(t[0], t[1], root)
    return work


def _walk_own_body(fnode):
    """Every node in ``fnode``'s body EXCLUDING nested function/class
    scopes (those run when actually called, reached via the worklist)."""
    stack = list(fnode.body) if not isinstance(fnode, ast.Lambda) \
        else [fnode.body]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _SeededFlow:
    """One function's parameter-seeded flow, falling back to the file's
    flow for expressions it did not evaluate."""

    def __init__(self, fflow, fileflow):
        self._values = fflow.values
        self._file = fileflow

    def val(self, node):
        v = self._values.get(id(node))
        return v if v is not None else self._file.val(node)


def _capture_impure_repo(ctxs):
    out = []
    for ctx in ctxs:
        for wnode, encl in _capture_sites(ctx):
            if not _gc_disabled_before(encl, wnode):
                out.append(Finding(
                    "capture-impure", ctx.path, wnode.lineno,
                    wnode.col_offset,
                    "CUDA-graph capture with the garbage collector on: a "
                    "finalizer that runs inside it (a pinned buffer's free, "
                    "a pipeline joining its threads) calls the CUDA runtime "
                    "on this thread and ends the capture — gc.collect() "
                    "then gc.disable() around it, as the fused step does",
                    context=ctx.qualnames.get(wnode, "")))
    for ctx, fnode, root in _reaching_capture(ctxs):
        flow = _analyze(ctx)
        if isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_names = {a.arg for a in
                           list(getattr(fnode.args, "posonlyargs", ()))
                           + list(fnode.args.args)
                           + list(fnode.args.kwonlyargs)}
        else:
            local_names = set()
        scope = fnode if isinstance(fnode, (ast.FunctionDef,
                                            ast.AsyncFunctionDef,
                                            ast.Lambda)) \
            else _enclosing_def(ctx, fnode)
        if scope is not None and not isinstance(scope, ast.Lambda):
            for n in ast.walk(scope):
                if isinstance(n, (ast.Assign, ast.For, ast.With)):
                    targets = (n.targets if isinstance(n, ast.Assign)
                               else [n.target] if isinstance(n, ast.For)
                               else [i.optional_vars for i in n.items
                                     if i.optional_vars is not None])
                    for t in targets:
                        for leaf in ast.walk(t):
                            if isinstance(leaf, ast.Name):
                                local_names.add(leaf.id)

        def flag(node, what, chain=()):
            out.append(Finding(
                "capture-impure", ctx.path, node.lineno,
                getattr(node, "col_offset", 0),
                "%s inside code a CUDA-graph capture runs (capture at %s): "
                "it runs once, at capture, and never on a replay — or ends "
                "the capture outright" % (what, root),
                context=ctx.qualnames.get(node, ""), chain=chain))

        nodes = list(_walk_own_body(fnode))
        for n in nodes:
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                flag(n, "global/nonlocal declaration (closure/module "
                        "mutation)")
            elif isinstance(n, ast.Call):
                fname = _name_of(n.func)
                if fname in _CAPTURE_ENDING or (
                        isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("pin_memory",)) or any(
                        k.arg == "pin_memory" and not (
                            isinstance(k.value, ast.Constant)
                            and not k.value.value) for k in n.keywords):
                    flag(n, "CUDA runtime call %s (illegal while the stream "
                            "captures)" % (fname or "pin_memory"))
                elif fname == "print" \
                        or fname.startswith(_IMPURE_CALL_PREFIXES):
                    flag(n, "call to %s (host side effect)" % fname)
                elif isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _MUTATING_METHODS \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id not in local_names:
                    flag(n, "mutation of closure/global %r via .%s()"
                         % (n.func.value.id, n.func.attr))
        if isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # the parameters of a captured function are the capture's
            # tensors (a Python scalar among them is captured as a
            # constant either way)
            flow = _SeededFlow(FunctionFlow(ctx, fnode,
                                            summaries=flow.summaries,
                                            seed_device_params=True), flow)
        for node, what, chain in _host_syncs(ctx, flow, nodes):
            if _name_of(getattr(node, "func", None)) in _SYNC_CALLS:
                continue  # reported above as a capture-ending call
            flag(node, "host sync: %s" % what, chain)
    return out


@_checker("capture-impure")
def check_capture_impure(ctxs):
    return _capture_impure_repo(list(ctxs))


# ---------------------------------------------------------------------------
# recapture-hazard
# ---------------------------------------------------------------------------

# constructors of a captured program keyed by its input shapes
_GRAPH_CTORS = ("BucketGraph", "CUDAGraph", "make_graphed_callables")


def _builds_graph(node):
    return any(isinstance(n, ast.Call)
               and _name_of(n.func).rsplit(".", 1)[-1] in _GRAPH_CTORS
               for n in ast.walk(node))


def _graph_wrappers(ctx):
    """``(containers, keyed)``: names (bare or self-attribute) bound to a
    graph or a dict of graphs — built inline or by a same-file def that
    builds one — and the same-file defs that look a graph up by one of
    their parameters (``_slot(self, slot)``: ``self._graphs.get(slot)``)
    with that parameter's position."""
    defs = _local_defs(ctx)
    makers = {name for name, ds in defs.items()
                if any(isinstance(r, ast.Return) and r.value is not None
                       and _builds_graph(r.value)
                       for d in ds for r in ast.walk(d))}
    containers = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        v = node.value
        if not (_builds_graph(v) or any(
                isinstance(n, ast.Call)
                and _name_of(n.func).rsplit(".", 1)[-1] in makers
                for n in ast.walk(v))):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                containers.add(t.id)
            elif isinstance(t, ast.Attribute):
                containers.add(t.attr)
    keyed = {}
    for name, ds in defs.items():
        for d in ds:
            params = [a.arg for a in d.args.args]
            for n in ast.walk(d):
                key = None
                if isinstance(n, ast.Subscript) \
                        and isinstance(n.value, ast.Attribute) \
                        and "graph" in n.value.attr.lower():
                    key = n.slice
                elif isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "get" and n.args \
                        and isinstance(n.func.value, ast.Attribute) \
                        and "graph" in n.func.value.attr.lower():
                    key = n.args[0]
                if isinstance(key, ast.Name) and key.id in params:
                    off = 1 if params and params[0] in ("self", "cls") \
                        else 0
                    keyed[name] = params.index(key.id) - off
    return containers, keyed


@_checker("recapture-hazard")
def check_recapture_hazard(ctx):
    containers, keyed = _graph_wrappers(ctx)
    if not containers and not keyed:
        return []
    flow = _analyze(ctx)
    out = []

    def _name(f):
        if isinstance(f, ast.Name):
            return f.id
        if isinstance(f, ast.Attribute):
            return f.attr
        return None

    def flag(node, wname, val):
        out.append(Finding(
            "recapture-hazard", ctx.path, node.lineno, node.col_offset,
            "key or argument of graph-keyed wrapper %r derives from a "
            "per-step Python scalar or un-bucketed size: every new value "
            "captures a fresh CUDA graph (or misses its static buffers) — "
            "compileobs will attribute it after the fact; bucket it now: "
            "pad to a fixed set of shapes" % wname,
            context=ctx.qualnames.get(node, ""), chain=val.schain))

    for node in ctx.nodes:
        if isinstance(node, ast.Subscript) \
                and _name(node.value) in containers:
            val = flow.val(node.slice)
            if val is not None and val.step:
                flag(node, _name(node.value), val)
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        base = f.value if isinstance(f, ast.Subscript) else f
        wname = _name(base)
        if wname in containers:
            args = list(node.args) + [kw.value for kw in node.keywords]
        elif wname in keyed and 0 <= keyed[wname] < len(node.args):
            args = [node.args[keyed[wname]]]
        else:
            continue
        for arg in args:
            val = flow.val(arg)
            if val is not None and val.step:
                flag(node, wname, val)
    return out


# ---------------------------------------------------------------------------
# lock-order / concurrency (repo scope)
# ---------------------------------------------------------------------------

def _lock_graph_for(ctxs):
    """One LockGraph per lint run: lock-order and the concurrency pass
    consume the same build (cached on the first context — contexts are
    reconstructed per run, so the cache can never go stale)."""
    if not ctxs:
        return _build_lock_graph(ctxs)
    anchor = ctxs[0]
    key = tuple(id(c) for c in ctxs)
    cached = getattr(anchor, "_lockgraph_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    graph = _build_lock_graph(ctxs)
    anchor._lockgraph_cache = (key, graph)
    return graph


@_checker("lock-order")
def check_lock_order(ctxs):
    ctxs = list(ctxs)
    graph = _lock_graph_for(ctxs)
    out = []
    for cycle in graph.cycles():
        edges = graph.cycle_edges(cycle)
        if not edges:
            continue
        # anchor at the lexically-first edge site so the finding (and its
        # suppression) lives where a human can re-order the acquisitions
        anchor = min(edges.values())
        path, line, _txt = anchor
        detail = "; ".join("%s->%s at %s:%d" % (s, d, p, ln)
                           for (s, d), (p, ln, _t)
                           in sorted(edges.items()))
        out.append(Finding(
            "lock-order", path, line, 0,
            "lock-acquisition cycle %s: two threads taking these locks "
            "in opposite orders deadlock — impose one global order or "
            "split the critical sections (%s)"
            % (" -> ".join(cycle + (cycle[0],)), detail)))
    for held, kind, path, line in graph.blocking:
        shared = [h for h in held
                  if len(graph.acquire_fns.get(h, ())) > 1]
        if not shared:
            continue
        out.append(Finding(
            "lock-order", path, line, 0,
            "blocking call %s while holding %s — other threads' paths "
            "also take %s and will wedge behind this wait; drop the lock "
            "first or bound the wait" % (kind, shared[0], shared[0])))
    return out


# ---------------------------------------------------------------------------
# mutable-default-arg
# ---------------------------------------------------------------------------

_MUTABLE_CTORS = ("list", "dict", "set", "defaultdict", "OrderedDict")


def _is_mutable_default(node):
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and _name_of(node.func).split(".")[-1] in _MUTABLE_CTORS)


@_checker("mutable-default-arg")
def check_mutable_default(ctx):
    out = []
    for node in ctx.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            if _is_mutable_default(d):
                name = getattr(node, "name", "<lambda>")
                out.append(Finding(
                    "mutable-default-arg", ctx.path, d.lineno, d.col_offset,
                    "mutable default argument on %s(): shared across calls "
                    "— default to None and construct inside" % name,
                    context=ctx.qualnames.get(node, "")))
    return out


# ---------------------------------------------------------------------------
# concurrency (repo scope): thread roots, shared state, guards — see
# concurrency.py for the model
# ---------------------------------------------------------------------------

@_checker("unguarded-shared-write", "check-then-act", "unbalanced-acquire",
          "guard-mismatch")
def check_concurrency(ctxs):
    # attr-form import — same standalone-CLI constraint as the driver
    from .concurrency import run as _run

    ctxs = list(ctxs)
    return _run(ctxs, graph=_lock_graph_for(ctxs))


CHECKERS = (check_env_raw_read, check_excepts, check_thread_hygiene,
            check_lock_discipline, check_host_sync,
            check_recapture_hazard, check_untracked_capture,
            check_mutable_default)

REPO_CHECKERS = (check_capture_impure, check_lock_order, check_concurrency)
