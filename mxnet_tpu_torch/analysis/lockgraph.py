"""Whole-repo lock-acquisition graph (the ``lock-order`` rule's engine).

Builds one directed graph over every lock the repo creates —
``threading.Lock`` / ``RLock`` / ``Condition`` / ``Semaphore`` assigned to
a module-level name or a ``self.<attr>`` — and adds an edge ``A -> B``
whenever B is acquired while A is held:

* lexically, via nested ``with`` statements;
* sequentially, via manual ``lock.acquire()`` / ``lock.release()`` pairs
  (the acquire extends the held set for the rest of the enclosing block,
  including a ``try``'s body when the release sits in its ``finally``)
  and via ``stack.enter_context(lock)`` (ExitStack indirection — held for
  the rest of the block, released by the stack's own exit);
* transitively, via calls made under a lock: ``self.method()`` resolves
  within the class, ``alias.fn()`` through the file's imports,
  ``self.obj.method()`` through constructor-assignment types
  (``self.obj = SomeClass(...)``), and each resolved callee contributes
  its own (transitive) acquisitions via a repo-wide fixpoint.

The walk also records every ``self.<attr>`` / module-global access it
passes — ``(owner id, read|write, held locks, line, in-test)`` per
function into ``accesses`` — which is the raw material concurrency.py's
shared-state race inference consumes (one tree walk feeds both analyses),
plus ``unbalanced``: manual acquires whose release never appears in the
same function (``release_sites`` lets the consumer recognize the
cross-function handoff idiom before flagging).

Lock identity is **per declaration site** (``module.Class.attr``), not per
instance: two instances of one class share a node. That over-approximates
(instance-disjoint graphs can look cyclic) and under-approximates
(dynamic dispatch is invisible) — lint-grade by design; suppress a false
cycle with a written reason. ``Condition(lock)`` aliases the wrapped
lock, so the condition-wait idiom never reports an ordering against its
own lock; self-edges (reentrant re-acquisition) are dropped.

Two failure families feed the ``lock-order`` checker:

* **cycle** — a strongly-connected component in the graph: two threads
  taking the locks in opposite orders deadlock.
* **blocking-under-lock** — a blocking call (``queue.get``,
  ``Event.wait``, ``Thread.join``, ``time.sleep``, KV RPC, ``urlopen``)
  made while holding a lock that other functions also take: every one of
  them wedges behind the sleeper (the serving engine's submit-vs-driver
  split and telemetry's scrape path are exactly this shape).
  ``Condition.wait`` on the held lock itself is the sanctioned idiom
  (it releases the lock) and is exempt.

``python -m mxnet_tpu_torch.tools.fwlint --dump-lock-graph`` renders the
graph as DOT.
Stdlib-only.
"""
from __future__ import annotations

import ast

from .dataflow import dotted_name as _dotted
from .fwlint import import_alias_map

__all__ = ["LockGraph", "build"]

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
_QUEUE_CTORS = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")
# method calls that mutate their receiver in place — a call through a
# shared attribute is a WRITE to that attribute's object
_MUTATORS = ("append", "extend", "add", "update", "pop", "popleft",
             "setdefault", "insert", "remove", "discard", "clear",
             "appendleft", "popitem")
# self-attr types that are thread-safe primitives (or the thread handle
# itself): accesses through them are not shared-state races
_SAFE_ATTR_TYPES = ("__queue__", "__thread__", "__event__")
_RPC_ATTRS = ("pull", "push", "barrier", "request_server_stats")
_RPC_RECV_HINTS = ("kv", "client", "store")
# bare receiver names that are (near-certainly) stdlib/third-party
# modules, not repo instances — their attribute traffic is never a
# duck-typed repo call
_STDLIB_RECV = frozenset((
    "os", "sys", "time", "json", "re", "math", "struct", "socket",
    "threading", "queue", "logging", "ast", "io", "np", "numpy", "torch",
    "random", "collections", "itertools", "functools",
    "subprocess", "shutil", "tempfile", "urllib", "http", "argparse",
    "contextlib", "signal", "atexit", "traceback", "pickle", "hashlib",
    "base64", "zlib", "gzip", "csv", "heapq", "bisect", "string",
    "textwrap", "types", "typing", "enum", "abc", "copy", "weakref",
    "warnings", "inspect", "platform", "stat", "glob", "fnmatch",
    "errno", "select", "ssl", "uuid", "datetime", "statistics", "array",
    "ctypes", "mmap", "unittest", "pytest"))


def _modname(path):
    return path[:-3].replace("/", ".") if path.endswith(".py") else path


def _lock_ctor(call):
    """('Lock'|'RLock'|..., wrapped_expr_or_None) when ``call`` constructs
    a threading primitive; None otherwise."""
    if not isinstance(call, ast.Call):
        return None
    name = _dotted(call.func)
    base = name.rsplit(".", 1)[-1]
    if base not in _LOCK_CTORS:
        return None
    if not (name == base or name.startswith("threading.")):
        return None
    wrapped = call.args[0] if base == "Condition" and call.args else None
    return base, wrapped


class _FileInfo:
    """Per-file symbol tables: declared locks, imports, constructor-typed
    attributes, def index."""

    def __init__(self, ctx, known_paths, known_classes):
        self.ctx = ctx
        self.mod = _modname(ctx.path)
        self.module_locks = {}   # bare name -> lock id
        self.class_locks = {}    # (class, attr) -> lock id
        self.attr_types = {}     # (class, attr) -> bare class name
        self.imports = {}        # alias -> repo path
        self.defs = {}           # qualname -> FunctionDef
        self.class_names = set()  # every ClassDef, nested included (the
        # serve-tier handler classes live INSIDE factory functions)
        self.method_index = {}   # (class, method) -> def qualname
        self.properties = set()  # def qualnames decorated @property
        self.module_names = set()  # module-level assigned (data) names
        for node in ctx.nodes:
            if isinstance(node, ast.ClassDef):
                self.class_names.add(node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = ctx.qualnames[node]
                self.defs[qn] = node
                comps = qn.split(".")
                for c in reversed(comps[:-1]):
                    if c in self.class_names:  # innermost enclosing class
                        self.method_index.setdefault((c, comps[-1]), qn)
                        break
                for dec in node.decorator_list:
                    if _dotted(dec) in ("property", "cached_property",
                                        "functools.cached_property"):
                        self.properties.add(qn)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)) \
                    and ctx.qualnames.get(node) == "<module>":
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.module_names.add(t.id)
        self._scan_imports(known_paths)
        self._scan_assigns(known_classes)

    def _scan_imports(self, known_paths):
        self.imports = import_alias_map(self.ctx, known_paths)

    def _scan_assigns(self, known_classes):
        ctx = self.ctx
        for node in ctx.nodes:
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            qn = ctx.qualnames.get(node, "")
            ctor = _lock_ctor(node.value)
            callee = _dotted(node.value.func).rsplit(".", 1)[-1]
            for t in node.targets:
                if isinstance(t, ast.Name) and qn == "<module>" and ctor:
                    kind, wrapped = ctor
                    lid = (self._alias_of(wrapped, None) if wrapped
                           is not None else None)
                    self.module_locks[t.id] = lid or "%s.%s" % (self.mod,
                                                                t.id)
                elif isinstance(t, ast.Attribute) \
                        and _dotted(t.value) == "self":
                    cls = next((c for c in reversed(qn.split("."))
                                if c in self.class_names), None)
                    if cls is None:
                        continue
                    if ctor:
                        kind, wrapped = ctor
                        lid = (self._alias_of(wrapped, cls) if wrapped
                               is not None else None)
                        self.class_locks[(cls, t.attr)] = \
                            lid or "%s.%s.%s" % (self.mod, cls, t.attr)
                    elif callee in known_classes:
                        self.attr_types[(cls, t.attr)] = callee
                    elif callee in _QUEUE_CTORS:
                        self.attr_types[(cls, t.attr)] = "__queue__"
                    elif callee == "Thread":
                        self.attr_types[(cls, t.attr)] = "__thread__"
                    elif callee == "Event":
                        self.attr_types[(cls, t.attr)] = "__event__"

    def _alias_of(self, wrapped, cls):
        """``Condition(self._lock)`` / ``Condition(_lock)``: the condition
        IS the wrapped lock — one graph node, not two."""
        if isinstance(wrapped, ast.Attribute) \
                and _dotted(wrapped.value) == "self" and cls:
            return self.class_locks.get(
                (cls, wrapped.attr),
                "%s.%s.%s" % (self.mod, cls, wrapped.attr))
        if isinstance(wrapped, ast.Name):
            return self.module_locks.get(
                wrapped.id, "%s.%s" % (self.mod, wrapped.id))
        return None


class LockGraph:
    """``edges``: {(src, dst): (path, line, text)} example sites;
    ``acquire_fns``: lock id -> set of function keys taking it directly;
    ``blocking``: [(held tuple, kind, path, line)] candidates;
    ``cycles()``: list of lock-id cycles (each a tuple)."""

    def __init__(self, ctxs):
        self.ctxs = {c.path: c for c in ctxs}
        known_paths = set(self.ctxs)
        known_classes = set()
        for c in ctxs:
            for node in c.nodes:
                if isinstance(node, ast.ClassDef):
                    known_classes.add(node.name)
        self.known_classes = known_classes
        self.infos = {c.path: _FileInfo(c, known_paths, known_classes)
                      for c in ctxs}
        self.edges = {}
        self.acquire_fns = {}
        self.blocking = []
        self.accesses = {}  # fnkey -> [(owner, kind, line, held, in_test)]
        self.unbalanced = []  # (lock id, path, line, fnkey): acquire w/o
        # release in the same function
        self.release_sites = {}  # lock id -> set of fnkeys releasing it
        # duck-typed residue the type pass could not resolve: method calls
        # and attribute loads on receivers with unknown type.  concurrency
        # turns the DISTINCTIVE names (<= 2 repo candidates) into reach
        # edges so a supervisor driving a factory-built engine still
        # connects to it.
        self.unresolved_calls = {}  # fnkey -> {(method name, held tuple)}
        self.unresolved_attrs = {}  # fnkey -> {(attr name, held tuple)}
        self._direct = {}   # fnkey -> set(lock ids)
        self._calls = {}    # fnkey -> [(held tuple, callee key, site)]
        self._fn_blocking = {}  # fnkey -> [(kind, path, line)] own calls
        for ctx in ctxs:
            info = self.infos[ctx.path]
            for qn, fnode in info.defs.items():
                self._walk_fn(ctx, info, fnode, (ctx.path, qn))
        self._apply_transitive()

    def edge_set(self):
        """The static acquisition-order edges as a plain set of
        ``(src, dst)`` lock-id pairs — the witness's comparison baseline."""
        return set(self.edges)

    # ------------------------------------------------------------- walking
    def _walk_fn(self, ctx, info, fnode, key):
        comps = key[1].split(".")
        cls = next((c for c in reversed(comps[:-1])
                    if c in info.class_names), None)
        aliases = {}
        direct = self._direct.setdefault(key, set())
        calls = self._calls.setdefault(key, [])
        accesses = self.accesses.setdefault(key, [])
        # module-global accesses resolve AFTER the walk: any local binding
        # of the name (Python scoping, not flow order) shadows the global
        # unless a `global` declaration reclaims it
        pending_globals = []  # (name, kind, line, held, in_test)
        fn_bound = set()
        fn_globals = set()
        args = fnode.args
        for a in (list(getattr(args, "posonlyargs", ())) + list(args.args)
                  + list(args.kwonlyargs)):
            fn_bound.add(a.arg)
        man_acquires = []  # [lock id, line, released?] manual .acquire()s

        def resolve_lock(expr):
            if isinstance(expr, ast.Name):
                if expr.id in aliases:
                    return aliases[expr.id]
                return info.module_locks.get(expr.id)
            if isinstance(expr, ast.Attribute):
                base = expr.value
                if _dotted(base) == "self" and cls:
                    return info.class_locks.get((cls, expr.attr))
                if isinstance(base, ast.Name) and base.id in info.imports:
                    tinfo = self.infos.get(info.imports[base.id])
                    if tinfo:
                        return tinfo.module_locks.get(expr.attr)
                owner = self._typeof(info, cls, base)
                if owner and owner != "__queue__":
                    ent = self._class_lock(owner, expr.attr)
                    if ent:
                        return ent
            return None

        def resolve_call(call):
            f = call.func
            if isinstance(f, ast.Name):
                if f.id in info.defs:
                    return (ctx.path, f.id)
                # nested def in the current function
                nested = key[1] + "." + f.id
                if nested in info.defs:
                    return (ctx.path, nested)
                return None
            if isinstance(f, ast.Attribute):
                base = f.value
                if _dotted(base) == "self" and cls:
                    qn = info.method_index.get((cls, f.attr))
                    if qn:
                        return (ctx.path, qn)
                    return None
                if isinstance(base, ast.Name) and base.id in info.imports:
                    tpath = info.imports[base.id]
                    if f.attr in self.infos[tpath].defs:
                        return (tpath, f.attr)
                    return None
                owner = self._typeof(info, cls, base)
                if owner and owner != "__queue__":
                    return self._class_method(owner, f.attr)
            return None

        def check_blocking(call, held):
            f = call.func
            name = _dotted(f)
            kind = None
            if name == "time.sleep":
                kind = "time.sleep()"
            elif "urlopen" in name:
                kind = "urlopen()"
            elif isinstance(f, ast.Attribute):
                recv = _dotted(f.value).lower()
                rtype = self._typeof(info, cls, f.value)
                # receiver must LOOK like the blocking kind — a bare
                # attr-name match would flag os.path.join / ", ".join /
                # dict.get as deadlock-class findings
                if f.attr == "join" and (
                        rtype == "__thread__"
                        or any(h in recv for h in ("thread", "worker",
                                                   "flusher", "publisher",
                                                   "proc"))
                        or recv == "t"):
                    kind = "Thread.join()"
                elif f.attr == "wait":
                    lid = resolve_lock(f.value)
                    if lid is not None:
                        # Condition.wait on the HELD lock releases it:
                        # the sanctioned idiom; on an un-held condition
                        # it is a blocking (mis)use
                        if lid not in held:
                            kind = "Condition.wait()"
                    elif rtype == "__event__" or any(
                            h in recv for h in ("event", "cond", "done",
                                                "ready", "stop", "proc",
                                                "_ev", "work")):
                        kind = "Event.wait()"
                elif f.attr == "get" and (
                        "queue" in recv or recv.endswith("_q")
                        or rtype == "__queue__"):
                    kind = "queue.get()"
                elif f.attr in _RPC_ATTRS and any(
                        h in recv for h in _RPC_RECV_HINTS):
                    kind = "KV RPC .%s()" % f.attr
            if kind:
                if held:
                    self.blocking.append((tuple(held), kind, ctx.path,
                                          call.lineno))
                # remembered either way: a caller holding a lock around
                # a call into THIS function inherits the blocking via
                # the transitive pass. A Condition.wait records its lock
                # so a caller HOLDING that lock stays exempt (the wait
                # releases it even when split across functions).
                wlid = resolve_lock(f.value) if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "wait") else None
                self._fn_blocking.setdefault(key, []).append(
                    (kind, ctx.path, call.lineno, wlid))

        def resolve_owner(expr):
            """Shared-state owner id for an access expression, or None.
            ``self.<attr>`` (within a known class, not a lock, not a
            thread-safe primitive, not a method) -> ``module.Class.attr``;
            a module-level data name -> ``module.name`` (scoping resolved
            after the walk via ``pending_globals``)."""
            if isinstance(expr, ast.Attribute) \
                    and _dotted(expr.value) == "self" and cls:
                if (cls, expr.attr) in info.class_locks:
                    return None
                if info.attr_types.get((cls, expr.attr)) \
                        in _SAFE_ATTR_TYPES:
                    return None
                if (cls, expr.attr) in info.method_index:
                    return None  # method/property reference, not data
                return "%s.%s.%s" % (info.mod, cls, expr.attr)
            return None

        def record_name(node, kind, held, in_test):
            nm = node.id
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                fn_bound.add(nm)
            if nm in info.module_names and nm not in info.module_locks:
                pending_globals.append((nm, kind, node.lineno,
                                        tuple(held), in_test))

        def duck_recv(base):
            """True when ``base`` is a receiver whose type the pass cannot
            name — the residue worth matching by method name later."""
            if isinstance(base, ast.Name):
                return (base.id not in info.imports
                        and base.id not in info.module_locks
                        and base.id not in aliases
                        and base.id not in _STDLIB_RECV
                        and base.id not in ("self", "cls"))
            if isinstance(base, ast.Attribute) \
                    and _dotted(base.value) == "self" and cls:
                return ((cls, base.attr) not in info.class_locks
                        and self._typeof(info, cls, base) is None)
            return False

        def scan_calls(expr, held, in_test=False):
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    callee = resolve_call(node)
                    site = (ctx.path, node.lineno,
                            ctx.line_text(node.lineno))
                    if callee:
                        calls.append((tuple(held), callee, site))
                    elif isinstance(node.func, ast.Attribute) \
                            and not node.func.attr.startswith("__") \
                            and duck_recv(node.func.value):
                        self.unresolved_calls.setdefault(key, set()).add(
                            (node.func.attr, tuple(held)))
                    check_blocking(node, held)
                    f = node.func
                    if isinstance(f, ast.Attribute):
                        if f.attr in _MUTATORS:
                            owner = resolve_owner(f.value)
                            if owner:
                                accesses.append((owner, "write",
                                                 node.lineno, tuple(held),
                                                 in_test))
                            elif isinstance(f.value, ast.Name):
                                record_name(f.value, "write", held,
                                            in_test)
                        elif f.attr in ("acquire", "release"):
                            lid = resolve_lock(f.value)
                            if lid and f.attr == "release":
                                self.release_sites.setdefault(
                                    lid, set()).add(key)
                                for rec in reversed(man_acquires):
                                    if rec[0] == lid and not rec[2]:
                                        rec[2] = True
                                        break
                elif isinstance(node, ast.Attribute):
                    owner = resolve_owner(node)
                    if owner:
                        kind = "write" if isinstance(
                            node.ctx, (ast.Store, ast.Del)) else "read"
                        accesses.append((owner, kind, node.lineno,
                                         tuple(held), in_test))
                    elif isinstance(node.ctx, ast.Load) \
                            and not node.attr.startswith("__") \
                            and isinstance(node.value, ast.Name) \
                            and duck_recv(node.value):
                        # may be a PROPERTY of a repo class (the
                        # handler's `engine.draining` read) — matched
                        # against @property defs by the consumer
                        self.unresolved_attrs.setdefault(
                            key, set()).add((node.attr, tuple(held)))
                elif isinstance(node, ast.Name):
                    kind = "write" if isinstance(
                        node.ctx, (ast.Store, ast.Del)) else "read"
                    record_name(node, kind, held, in_test)
                elif isinstance(node, ast.Subscript) \
                        and isinstance(node.ctx, (ast.Store, ast.Del)):
                    owner = resolve_owner(node.value)
                    if owner:
                        accesses.append((owner, "write", node.lineno,
                                         tuple(held), in_test))
                    elif isinstance(node.value, ast.Name):
                        record_name(node.value, "write", held, in_test)

        def acquire_here(lid, stmt, held):
            site = (ctx.path, stmt.lineno, ctx.line_text(stmt.lineno))
            direct.add(lid)
            self.acquire_fns.setdefault(lid, set()).add(key)
            for h in held:
                self._edge(h, lid, site)

        def manual_lock_call(stmt):
            """(lock id, 'acquire'|'release'|'enter_context') when the
            statement is a bare manual lock operation; None otherwise."""
            if not (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)):
                return None
            call, f = stmt.value, stmt.value.func
            if f.attr in ("acquire", "release"):
                lid = resolve_lock(f.value)
                return (lid, f.attr) if lid else None
            if f.attr == "enter_context" and call.args:
                lid = resolve_lock(call.args[0])
                return (lid, "enter_context") if lid else None
            return None

        def block_walk(stmts, held):
            """Walk a statement sequence with RUNNING held state: a manual
            acquire/enter_context extends it for the remaining siblings
            (and their nested blocks), a release retires it."""
            cur = list(held)
            for s in stmts:
                cur = stmt_walk(s, cur)
            return cur

        def stmt_walk(stmt, held):
            """Walk one statement under ``held``; returns the held list the
            FOLLOWING sibling statements run under."""
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return held  # separate function keys
            if isinstance(stmt, ast.Global):
                fn_globals.update(stmt.names)
                return held
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                got = []
                site = (ctx.path, stmt.lineno, ctx.line_text(stmt.lineno))
                for item in stmt.items:
                    lid = resolve_lock(item.context_expr)
                    if lid:
                        if isinstance(item.optional_vars, ast.Name):
                            aliases[item.optional_vars.id] = lid
                        direct.add(lid)
                        self.acquire_fns.setdefault(lid, set()).add(key)
                        for h in held + got:
                            self._edge(h, lid, site)
                        got.append(lid)
                    else:
                        scan_calls(item.context_expr, held)
                    if isinstance(item.optional_vars, ast.Name):
                        fn_bound.add(item.optional_vars.id)
                block_walk(stmt.body, held + got)
                return held
            if isinstance(stmt, ast.Assign):
                lid = resolve_lock(stmt.value) if isinstance(
                    stmt.value, (ast.Name, ast.Attribute)) else None
                if lid:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            aliases[t.id] = lid
            op = manual_lock_call(stmt)
            if op is not None:
                lid, what = op
                scan_calls(stmt.value, held)
                if what == "acquire":
                    acquire_here(lid, stmt, held)
                    man_acquires.append([lid, stmt.lineno, False])
                    return held + [lid] if lid not in held else held
                if what == "enter_context":
                    # ExitStack owns the release — balanced by construction
                    acquire_here(lid, stmt, held)
                    return held + [lid] if lid not in held else held
                # release: scan_calls already retired the man_acquires rec
                out = list(held)
                if lid in out:
                    out.remove(lid)
                return out
            # scan this statement's own expressions (not nested stmts);
            # an If/While TEST is marked so check-then-act can find reads
            # whose decision a racing write invalidates
            test = stmt.test if isinstance(stmt,
                                           (ast.If, ast.While)) else None
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    scan_calls(child, held, in_test=child is test)
                elif isinstance(child, ast.withitem):
                    pass
            if isinstance(stmt, ast.Try):
                # sequential semantics for the acquire/try/finally idiom:
                # the body's running held state flows into orelse/finally,
                # and a finally release retires it for later siblings
                cur = block_walk(stmt.body, held)
                for h in stmt.handlers:
                    block_walk(h.body, held)
                cur = block_walk(stmt.orelse, cur)
                return block_walk(stmt.finalbody, cur)
            for field in ("body", "orelse"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    block_walk([s for s in sub
                                if isinstance(s, ast.stmt)], held)
            return held

        block_walk(fnode.body, [])
        for lid, line, released in man_acquires:
            if not released:
                self.unbalanced.append((lid, ctx.path, line, key))
        for nm, kind, line, held, in_test in pending_globals:
            if nm in fn_bound and nm not in fn_globals:
                continue  # a local binding shadows the module global
            accesses.append(("%s.%s" % (info.mod, nm), kind, line, held,
                             in_test))

    def _typeof(self, info, cls, expr):
        if isinstance(expr, ast.Attribute) \
                and _dotted(expr.value) == "self" and cls:
            return info.attr_types.get((cls, expr.attr))
        return None

    def _class_lock(self, owner, attr):
        for info in self.infos.values():
            ent = info.class_locks.get((owner, attr))
            if ent:
                return ent
        return None

    def _class_method(self, owner, attr):
        for path, info in self.infos.items():
            qn = info.method_index.get((owner, attr))
            if qn:
                return (path, qn)
        return None

    def _edge(self, src, dst, site):
        if src == dst:
            return  # reentrant re-acquisition, not an ordering
        self.edges.setdefault((src, dst), site)

    # ------------------------------------------------------------ fixpoint
    def _apply_transitive(self):
        acq = {k: set(v) for k, v in self._direct.items()}
        changed = True
        while changed:
            changed = False
            for fn, records in self._calls.items():
                mine = acq.setdefault(fn, set())
                for _held, callee, _site in records:
                    extra = acq.get(callee, ())
                    if not set(extra) <= mine:
                        mine |= set(extra)
                        changed = True
        self.acq = acq
        # transitive BLOCKING too: the motivating shapes put the queue
        # pop / event wait in a helper the lock-holder calls — lexical
        # detection alone would miss the advertised bug class entirely
        blk = {k: set(v) for k, v in self._fn_blocking.items()}
        changed = True
        while changed:
            changed = False
            for fn, records in self._calls.items():
                mine = blk.setdefault(fn, set())
                for _held, callee, _site in records:
                    extra = blk.get(callee, set())
                    if not extra <= mine:
                        mine |= extra
                        changed = True
        seen_blk = set(map(tuple, self.blocking))
        for fn, records in self._calls.items():
            for held, callee, site in records:
                if not held:
                    continue
                for m in acq.get(callee, ()):
                    for h in held:
                        self._edge(h, m, site)
                for kind, _bpath, _bline, wlid in sorted(
                        blk.get(callee, ()), key=lambda r: r[:3]):
                    if wlid is not None and wlid in held:
                        continue  # condition-wait on a lock WE hold
                    rec = (tuple(held),
                           "%s (inside %s, reached from this call)"
                           % (kind, callee[1]), site[0], site[1])
                    if rec not in seen_blk:
                        seen_blk.add(rec)
                        self.blocking.append(rec)

    # ------------------------------------------------------------- queries
    def nodes(self):
        out = set(self.acquire_fns)
        for s, d in self.edges:
            out.add(s)
            out.add(d)
        return sorted(out)

    def cycles(self):
        """Strongly-connected components with more than one node, each
        returned as a canonically-rotated tuple of lock ids."""
        adj = {}
        for s, d in self.edges:
            adj.setdefault(s, set()).add(d)
        index, low, stack, on = {}, {}, [], set()
        sccs, counter = [], [0]

        def strong(v):
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            for w in adj.get(v, ()):
                if w not in index:
                    strong(w)
                    low[v] = min(low[v], low[w])
                elif w in on:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(comp)

        for v in sorted(set(adj) | {d for ds in adj.values()
                                    for d in ds}):
            if v not in index:
                strong(v)
        out = []
        for comp in sccs:
            comp = sorted(comp)
            out.append(tuple(comp))
        return sorted(out)

    def cycle_edges(self, cycle):
        """The example sites of the edges inside one cycle (for the
        finding message and the DOT dump)."""
        nodes = set(cycle)
        return {(s, d): site for (s, d), site in sorted(self.edges.items())
                if s in nodes and d in nodes}

    def to_dot(self):
        lines = ["digraph lock_order {", "  rankdir=LR;",
                 '  node [shape=box, fontname="monospace"];']
        cyc_nodes = {n for c in self.cycles() for n in c}
        for n in self.nodes():
            style = ', color=red, penwidth=2' if n in cyc_nodes else ""
            lines.append('  "%s" [label="%s"%s];' % (n, n, style))
        for (s, d), (path, line, _text) in sorted(self.edges.items()):
            color = ', color=red' if s in cyc_nodes and d in cyc_nodes \
                else ""
            lines.append('  "%s" -> "%s" [label="%s:%d"%s];'
                         % (s, d, path, line, color))
        lines.append("}")
        return "\n".join(lines)


def build(ctxs):
    """Construct the LockGraph for a list of FileContexts."""
    return LockGraph(ctxs)
