"""Whole-repo concurrency analyzer — thread roots, shared state, guards.

Every cross-thread bug this repo has shipped (the profiler state races,
the DeviceFeedIter generation race, telemetry's unlocked ``_flusher``
read) was a *shared-state* bug the annotation-driven rules could not see:
``lock-discipline`` checks locks someone already annotated, ``lock-order``
checks locks someone already takes. This pass infers the threading
structure from the code itself, in four stages:

1. **Thread-root discovery** — every way this repo starts concurrent
   execution: ``threading.Thread(target=...)`` (names, bound methods,
   lambdas, factory closures), ``threading.Timer``, ``atexit.register``
   hooks, HTTP request-handler classes (one handler method per connection
   thread), plus the implicit **main** root. Each root resolves to the
   set of functions reachable from it over lockgraph's cross-file call
   graph (``python -m mxnet_tpu_torch.tools.fwlint --dump-thread-roots``
   prints the table).
2. **Shared-state inference** — ``self.<attr>`` / module-global accesses
   (recorded by lockgraph's walk — one tree traversal feeds both
   analyses) whose functions are reachable from >= 2 roots. Writes
   confined to ``__init__`` / module scope are *publish-once* (safe
   setup-then-read) and exempt; request-handler classes are exempt
   wholesale (one instance per connection thread — their ``self`` is
   thread-local by construction).
3. **Guarded-by inference** — the locks held at every access (through
   ``with``, manual acquire/release pairs, ExitStack indirection, local
   aliases, and helper calls). A lock held at a majority of accesses is
   the attribute's *dominant* lock; writes that bypass it are the race.
4. The runtime half lives in :mod:`witness` (``MXNET_LOCK_WITNESS``).

Rules:

* ``unguarded-shared-write`` — a shared mutable attribute written without
  its dominant lock (or with no lock anywhere): the finding's chain names
  the racing roots and an example guarded site, and the message proposes
  the ``# guarded-by:`` annotation. One finding per attribute (the first
  unguarded write anchors it).
* ``check-then-act``        — an ``if``/``while`` test reads a shared
  attribute outside the lock that guards its later write in the same
  function: the value can change between the check and the act (the
  supervisor-restart and drain-flag shapes).
* ``unbalanced-acquire``    — a manual ``lock.acquire()`` with no
  ``release()`` in the same function (and no cross-function handoff
  releasing it elsewhere in the repo): an exception between the two
  leaves the lock held forever.
* ``guard-mismatch``        — an explicit ``# guarded-by: X`` annotation
  on an attribute whose accesses actually hold lock Y: either the
  annotation or the code is lying, and lock-discipline is enforcing the
  wrong contract.

Lint-grade by design: instance identity collapses to the declaration
site, dynamic dispatch is invisible, and a class instantiated once per
thread can false-positive — suppress those with a written reason or
annotate the real guard. Stdlib-only.
"""
from __future__ import annotations

import ast
import re

from .dataflow import dotted_name as _dotted
from .fwlint import Finding
from .lockgraph import build as _build_lock_graph

__all__ = ["ConcurrencyModel", "build_model", "run"]

RULES = ("unguarded-shared-write", "check-then-act", "unbalanced-acquire",
         "guard-mismatch")

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")

# benign-by-design annotations (reason REQUIRED — a bare marker is
# ignored): `# thread-confined: <why instances never cross threads>` and
# `# race-ok: <why the unguarded access is safe>`.  On a ClassDef line
# (or the line above) the whole class's attrs are exempt; on an
# assignment line only that attr/global is.
_EXEMPT_RE = re.compile(r"#\s*(?:thread-confined|race-ok):\s*(\S.+)")

# base-class name fragments marking one-instance-per-connection handler
# classes: their do_*/handle methods run on server threads (roots), but
# their self.<attr> state is thread-local
_HANDLER_BASE_HINTS = ("RequestHandler", "StreamRequestHandler")


def _is_setup(fnkey):
    """Accesses inside __init__/__new__ are single-threaded construction:
    publication, not a race (the object is not yet shared)."""
    return fnkey[1].split(".")[-1] in ("__init__", "__new__")


class _Root:
    """One thread root: a label for messages/chains, the spawn site, and
    the entry function keys its thread runs."""

    __slots__ = ("label", "kind", "path", "line", "entries", "reach")

    def __init__(self, label, kind, path, line, entries):
        self.label = label
        self.kind = kind
        self.path = path
        self.line = line
        self.entries = tuple(entries)
        self.reach = set()

    def site(self):
        return "%s:%d" % (self.path, self.line)


def _local_ctor_types(scope, known_classes):
    """name -> bare class name for ``nm = SomeClass(...)`` assignments in
    ``scope`` (a function body or module) — resolves ``Thread(target=
    sup.run_loop)`` through the local the instance was bound to."""
    out = {}
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            cname = _dotted(n.value.func).rsplit(".", 1)[-1]
            if cname in known_classes:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = cname
    return out


class ConcurrencyModel:
    """Thread roots + per-function root sets + shared-state table over one
    lockgraph (``graph`` is shared with lock-order: one build per run)."""

    def __init__(self, graph):
        self.graph = graph
        self.roots = []
        self.roots_of = {}      # fnkey -> set of root labels
        self._by_label = {}
        self._discover()
        self._close()

    # ---------------------------------------------------------- discovery
    def _add_root(self, label, kind, path, line, entries):
        entries = [e for e in entries if e is not None]
        if not entries:
            return
        # one spawn site in a loop/helper yields one root; a second
        # DISTINCT site with the same label gets a site-suffixed label
        if label in self._by_label \
                and self._by_label[label].site() != "%s:%d" % (path, line):
            label = "%s@%s:%d" % (label, path, line)
        root = self._by_label.get(label)
        if root is None:
            root = _Root(label, kind, path, line, entries)
            self._by_label[label] = root
            self.roots.append(root)

    def _factory_ctor(self, ctx, info, scope, varname, enclosing):
        """Bare class name for ``nm = factory(...)`` in ``scope`` where
        the (file-level or nested) factory's return statement constructs
        a known class — serve.py's ``sup = build_supervisor(args)``."""
        for n in ast.walk(scope):
            if not (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)):
                continue
            if not any(isinstance(t, ast.Name) and t.id == varname
                       for t in n.targets):
                continue
            fn = n.value.func
            if not isinstance(fn, ast.Name):
                continue
            fdef = info.defs.get(fn.id)
            if fdef is None and enclosing is not None:
                fdef = info.defs.get(
                    ctx.qualnames[enclosing] + "." + fn.id)
            if fdef is None:
                continue
            for r in ast.walk(fdef):
                if isinstance(r, ast.Return) \
                        and isinstance(r.value, ast.Call):
                    cname = _dotted(r.value.func).rsplit(".", 1)[-1]
                    if cname in self.graph.known_classes:
                        return cname
        return None

    def _resolve_callable(self, ctx, info, expr, enclosing):
        """Function keys a Thread target / timer fn / atexit hook resolves
        to. ``enclosing`` is the spawn site's enclosing def (or None at
        module level)."""
        graph = self.graph
        if isinstance(expr, ast.Name):
            if enclosing is not None:
                nested = ctx.qualnames[enclosing] + "." + expr.id
                if nested in info.defs:
                    return [(ctx.path, nested)]
            if expr.id in info.defs:
                return [(ctx.path, expr.id)]
            return []
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if _dotted(base) == "self":
                encl_qn = (ctx.qualnames.get(enclosing, "")
                           if enclosing is not None else "")
                cls = next((c for c in reversed(encl_qn.split("."))
                            if c in info.class_names), None)
                if cls:
                    qn = info.method_index.get((cls, expr.attr))
                    if qn:
                        return [(ctx.path, qn)]
                return []
            if isinstance(base, ast.Name):
                # instance local: sup.run_loop via `sup = Supervisor(...)`
                # or via a factory (`sup = build_supervisor(args)` whose
                # return statement constructs the known class)
                scope = enclosing if enclosing is not None else ctx.tree
                owner = _local_ctor_types(
                    scope, graph.known_classes).get(base.id)
                if owner is None:
                    owner = self._factory_ctor(ctx, info, scope, base.id,
                                               enclosing)
                if owner:
                    m = graph._class_method(owner, expr.attr)
                    if m:
                        return [m]
                # module alias: mod.fn through the import map
                tpath = info.imports.get(base.id)
                if tpath and expr.attr in graph.infos[tpath].defs:
                    return [(tpath, expr.attr)]
            return []
        if isinstance(expr, ast.Lambda):
            out = []
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Call):
                    out.extend(self._resolve_callable(ctx, info, n.func,
                                                      enclosing))
            return out
        if isinstance(expr, ast.Call):
            # factory closure: target=make_loop(...) where the factory
            # returns a nested def
            fks = self._resolve_callable(ctx, info, expr.func, enclosing)
            out = []
            for fpath, fqn in fks:
                factory = self.graph.infos[fpath].defs.get(fqn)
                if factory is None:
                    continue
                for r in ast.walk(factory):
                    if isinstance(r, ast.Return) \
                            and isinstance(r.value, ast.Name):
                        nested = fqn + "." + r.value.id
                        if nested in self.graph.infos[fpath].defs:
                            out.append((fpath, nested))
            return out
        return []

    def _discover(self):
        graph = self.graph
        # spawner helpers: `def start(name, target): Thread(target=target)`
        # — the Thread target is a PARAMETER, resolved per call site below
        spawner_defs = {}  # fnkey -> (tpos, tparam, npos, nparam)
        for path, info in graph.infos.items():
            ctx = info.ctx
            for node in ctx.nodes:
                if isinstance(node, ast.ClassDef):
                    bases = [_dotted(b) for b in node.bases]
                    if any(h in b for b in bases
                           for h in _HANDLER_BASE_HINTS):
                        # qualnames, not bare names: serve.py's handler
                        # class is nested inside its factory function
                        entries = [
                            (path, ctx.qualnames[d])
                            for d in node.body
                            if isinstance(d, ast.FunctionDef)
                            and (d.name.startswith("do_")
                                 or d.name == "handle")]
                        self._add_root(
                            "http-handler(%s)" % node.name, "handler",
                            path, node.lineno, entries)
                    continue
                if not isinstance(node, ast.Call):
                    continue
                fname = _dotted(node.func)
                enclosing = next(
                    (p for p in ctx.ancestors(node)
                     if isinstance(p, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))), None)
                if fname in ("threading.Thread", "Thread"):
                    kwargs = {k.arg: k.value for k in node.keywords
                              if k.arg}
                    target = kwargs.get("target")
                    if target is None and len(node.args) >= 2:
                        target = node.args[1]  # Thread(group, target)
                    if target is None:
                        continue
                    if isinstance(target, ast.Name) \
                            and enclosing is not None:
                        params = [a.arg for a in enclosing.args.args]
                        if target.id in params:
                            namearg = kwargs.get("name")
                            nparam = (namearg.id if isinstance(
                                namearg, ast.Name)
                                and namearg.id in params else None)
                            spawner_defs[
                                (path, ctx.qualnames[enclosing])] = (
                                params.index(target.id), target.id,
                                params.index(nparam) if nparam else None,
                                nparam)
                            continue
                    entries = self._resolve_callable(ctx, info, target,
                                                     enclosing)
                    name = kwargs.get("name")
                    label = ("thread(%s)" % name.value
                             if isinstance(name, ast.Constant)
                             and isinstance(name.value, str)
                             else "thread(%s)" % (_dotted(target)
                                                  or "<lambda>"))
                    self._add_root(label, "thread", path, node.lineno,
                                   entries)
                elif fname in ("threading.Timer", "Timer"):
                    fn = (node.args[1] if len(node.args) >= 2
                          else next((k.value for k in node.keywords
                                     if k.arg == "function"), None))
                    if fn is not None:
                        entries = self._resolve_callable(ctx, info, fn,
                                                         enclosing)
                        self._add_root("timer(%s)" % (_dotted(fn)
                                                      or "<lambda>"),
                                       "timer", path, node.lineno,
                                       entries)
                elif fname == "atexit.register" and node.args:
                    entries = self._resolve_callable(
                        ctx, info, node.args[0], enclosing)
                    self._add_root(
                        "atexit(%s)" % (_dotted(node.args[0])
                                        or "<lambda>"),
                        "atexit", path, node.lineno, entries)
        if spawner_defs:
            self._resolve_spawner_sites(spawner_defs)

    def _resolve_spawner_sites(self, spawner_defs):
        """Pass 2 of spawner-helper discovery: every call into a spawner
        def contributes a root whose entry is the callable ARGUMENT (and
        whose label is the constant name argument when present)."""
        graph = self.graph
        leaves = {fk[1].split(".")[-1] for fk in spawner_defs}
        for path, info in graph.infos.items():
            ctx = info.ctx
            for node in ctx.nodes:
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                leaf = (f.id if isinstance(f, ast.Name)
                        else f.attr if isinstance(f, ast.Attribute)
                        else None)
                if leaf not in leaves:
                    continue
                enclosing = next(
                    (p for p in ctx.ancestors(node)
                     if isinstance(p, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))), None)
                for fk in self._resolve_callable(ctx, info, f, enclosing):
                    sp = spawner_defs.get(fk)
                    if sp is None:
                        continue
                    tpos, tparam, npos, nparam = sp
                    # bound-method call sites don't pass self explicitly
                    off = 1 if (isinstance(f, ast.Attribute)
                                and _dotted(f.value) in ("self", "cls")) \
                        else 0
                    kw = {k.arg: k.value for k in node.keywords if k.arg}
                    texpr = kw.get(tparam)
                    if texpr is None and 0 <= tpos - off < len(node.args):
                        texpr = node.args[tpos - off]
                    if texpr is None:
                        continue
                    entries = self._resolve_callable(ctx, info, texpr,
                                                     enclosing)
                    nexpr = kw.get(nparam) if nparam else None
                    if nexpr is None and npos is not None \
                            and 0 <= npos - off < len(node.args):
                        nexpr = node.args[npos - off]
                    label = ("thread(%s)" % nexpr.value
                             if isinstance(nexpr, ast.Constant)
                             and isinstance(nexpr.value, str)
                             else "thread(%s)" % (_dotted(texpr)
                                                  or "<fn>"))
                    self._add_root(label, "thread", path, node.lineno,
                                   entries)

    # --------------------------------------------------------- closure
    def _close(self):
        graph = self.graph
        # call edges WITH the locks held at the call site — reach closure
        # uses the targets, the caller-held fixpoint below uses the locks
        hedges = {}  # fn -> [(held frozenset, callee fnkey)]
        for fn, records in graph._calls.items():
            hedges.setdefault(fn, []).extend(
                (frozenset(h), c) for h, c, _s in records)
        # duck-typed fallback (CHA-lite): a method call on a receiver the
        # type pass could not name still reaches the repo method of that
        # name, PROVIDED the name is distinctive (<= 2 candidate classes).
        # This is the supervisor -> factory-built-engine hop and the
        # handler's `engine.draining` property read — both invisible to
        # constructor-assignment typing by design (resilience duck-types
        # its engine).  Over-approximate, lint-grade.
        methods = {}  # leaf method name -> set of fnkeys
        props = {}    # leaf @property name -> set of fnkeys
        for path, info in graph.infos.items():
            for (_cls, mname), qn in info.method_index.items():
                methods.setdefault(mname, set()).add((path, qn))
                if qn in info.properties:
                    props.setdefault(mname, set()).add((path, qn))
        for table, cands_of in ((graph.unresolved_calls, methods),
                                (graph.unresolved_attrs, props)):
            for fn, pairs in table.items():
                for nm, held in pairs:
                    cands = cands_of.get(nm, ())
                    if 0 < len(cands) <= 2:
                        hedges.setdefault(fn, []).extend(
                            (frozenset(held), c) for c in cands)
        adj = {fn: {c for _h, c in pairs}
               for fn, pairs in hedges.items()}
        self._hedges = hedges

        def reach_from(entries):
            seen, work = set(entries), list(entries)
            while work:
                fn = work.pop()
                for c in adj.get(fn, ()):
                    if c not in seen:
                        seen.add(c)
                        work.append(c)
            return seen

        spawned = set()
        for root in self.roots:
            root.reach = reach_from(root.entries)
            spawned |= root.reach
        # the MAIN root: anything a spawned thread cannot reach must be
        # main-thread code; whatever main-thread code calls (shared
        # helpers included) is main-reachable
        all_fns = set(graph._calls)
        main_entries = sorted(all_fns - spawned)
        main = _Root("main", "main", "<main>", 0, main_entries or all_fns)
        main.reach = reach_from(main.entries)
        self.roots.append(main)
        self._by_label["main"] = main
        for root in self.roots:
            for fn in root.reach:
                self.roots_of.setdefault(fn, set()).add(root.label)
        self._infer_caller_held()

    def _infer_caller_held(self):
        """``caller_held[fn]``: locks held on EVERY path into ``fn`` — the
        meet-over-callers fixpoint.  A helper that mutates shared state
        but is only ever called under the lock is guarded; one extra
        lock-free call path (a thread entry included) erases the guard.
        Accesses inherit this set on top of their lexical held-set."""
        val = {}   # fn -> frozenset (absent = not yet seen, i.e. TOP)
        work = []

        def meet(fn, s):
            old = val.get(fn)
            new = s if old is None else old & s
            if old is None or new != old:
                val[fn] = new
                work.append(fn)

        # seed lock-free ONLY at true entry points: spawned-root entries
        # and functions no static call site reaches.  Main's entry list is
        # every unspawned function (right for reach, wrong here — it
        # would seed helpers that are only ever called under a lock).
        called = set()
        for pairs in self._hedges.values():
            called.update(c for _h, c in pairs)
        for root in self.roots:
            if root.kind != "main":
                for e in root.entries:
                    meet(e, frozenset())
        for fn in self.graph._calls:
            if fn not in called:
                meet(fn, frozenset())
        while work:
            fn = work.pop()
            mine = val[fn]
            for held, callee in self._hedges.get(fn, ()):
                meet(callee, mine | held)
        self.caller_held = val

    # --------------------------------------------------------- queries
    def root(self, label):
        return self._by_label.get(label)

    def handler_classes(self):
        """(path, class) pairs whose instances are per-connection: their
        self-state is thread-local, not shared."""
        out = set()
        for root in self.roots:
            if root.kind == "handler":
                for path, qn in root.entries:
                    comps = qn.split(".")
                    if len(comps) >= 2:
                        out.add((path, comps[-2]))
        return out

    def dump_roots(self):
        """root -> reachable functions, for --dump-thread-roots."""
        lines = []
        for root in sorted(self.roots, key=lambda r: r.label):
            lines.append("%s  (spawned at %s, %d reachable)"
                         % (root.label, root.site(), len(root.reach)))
            for path, qn in sorted(root.reach):
                lines.append("    %s:%s" % (path, qn))
        return "\n".join(lines)


def build_model(ctxs, graph=None):
    """Build the ConcurrencyModel (reusing ``graph`` when the caller —
    the checker layer — already built the run's lockgraph)."""
    return ConcurrencyModel(graph if graph is not None
                            else _build_lock_graph(list(ctxs)))


# ---------------------------------------------------------------------------
# shared-state table
# ---------------------------------------------------------------------------

class _Shared:
    """One shared owner's access history: every access with its function,
    kind, lock set, and the roots that reach it."""

    __slots__ = ("owner", "accesses", "roots")

    def __init__(self, owner):
        self.owner = owner
        self.accesses = []  # (fnkey, kind, line, held, in_test)
        self.roots = set()


def _shared_table(model):
    graph, out = model.graph, {}
    handler_cls = model.handler_classes()
    for fn, accs in graph.accesses.items():
        roots = model.roots_of.get(fn, set())
        inherited = model.caller_held.get(fn, frozenset())
        for owner, kind, line, held, in_test in accs:
            parts = owner.rsplit(".", 2)
            if len(parts) == 3 \
                    and (fn[0], parts[1]) in handler_cls:
                continue  # per-connection handler instance state
            ent = out.setdefault(owner, _Shared(owner))
            eff = (tuple(sorted(set(held) | inherited))
                   if inherited else held)
            ent.accesses.append((fn, kind, line, eff, in_test))
            if not _is_setup(fn):
                ent.roots |= roots
    return out


def _dominant_lock(accesses):
    """(lock id, held count, total) for the most-held lock over the
    non-setup accesses; (None, 0, total) when no lock appears."""
    counts = {}
    total = 0
    for _fn, _kind, _line, held, _t in accesses:
        total += 1
        for h in set(held):
            counts[h] = counts.get(h, 0) + 1
    if not counts:
        return None, 0, total
    lock = max(sorted(counts), key=lambda k: counts[k])
    return lock, counts[lock], total


def _bare(lock_id):
    return lock_id.rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def run(ctxs, graph=None):
    """All four concurrency rules over one repo-scope pass."""
    ctxs = list(ctxs)
    model = build_model(ctxs, graph=graph)
    g = model.graph
    out = []
    shared = _shared_table(model)

    # ---- benign-by-design annotations -----------------------------------
    exempt_classes = set()  # (module, class)
    exempt_owners = set()   # full owner ids
    for ctx in ctxs:
        info = g.infos.get(ctx.path)
        if info is None:
            continue

        def _ann(line):
            # trailing comment, then the contiguous comment block above —
            # a multi-line justification keeps its marker on any line
            m = _EXEMPT_RE.search(ctx.comments.get(line, ""))
            above = line - 1
            while m is None and above in ctx.comments \
                    and ctx.line_text(above).startswith("#"):
                m = _EXEMPT_RE.search(ctx.comments[above])
                above -= 1
            return m

        for node in ctx.nodes:
            if isinstance(node, ast.ClassDef):
                if _ann(node.lineno):
                    exempt_classes.add((info.mod, node.name))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                if not _ann(node.lineno):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                qn = ctx.qualnames.get(node, "")
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and _dotted(t.value) == "self":
                        cls = next((c for c in reversed(qn.split("."))
                                    if c in info.class_names), None)
                        if cls:
                            exempt_owners.add(
                                "%s.%s.%s" % (info.mod, cls, t.attr))
                    elif isinstance(t, ast.Name) and qn == "<module>":
                        exempt_owners.add("%s.%s" % (info.mod, t.id))

    def _exempt(owner):
        if owner in exempt_owners:
            return True
        parts = owner.rsplit(".", 2)
        return len(parts) == 3 and (parts[0], parts[1]) in exempt_classes

    def _roots_pair(ent):
        labels = sorted(ent.roots, key=lambda l: (l == "main", l))
        return labels[:2] if len(labels) >= 2 else labels + ["main"]

    def _chain(ent, lock, guarded_site, write_sites):
        steps = []
        for label in sorted(ent.roots)[:4]:
            root = model.root(label)
            if root is not None:
                steps.append("root %s (spawned at %s) reaches this state"
                             % (label, root.site()))
        if lock and guarded_site:
            steps.append("guarded access under %s at %s:%d"
                         % (lock, guarded_site[0], guarded_site[1]))
        for fn, line in write_sites[:4]:
            steps.append("line %d: write in %s without the lock"
                         % (line, fn[1]))
        return steps

    # ---- unguarded-shared-write -----------------------------------------
    for owner in sorted(shared):
        ent = shared[owner]
        if len(ent.roots) < 2 or _exempt(owner):
            continue
        live = [a for a in ent.accesses if not _is_setup(a[0])]
        writes = [a for a in live if a[1] == "write"]
        if not writes:
            continue  # publish-once or read-only: setup writes + reads
        lock, nheld, total = _dominant_lock(live)
        if lock is not None and nheld == total:
            continue  # every live access holds the same lock: clean
        best, best_n = lock, nheld
        if lock is not None and (nheld * 2 <= total or nheld < 2):
            lock = None  # no clear majority
        if lock:
            # outliers: ANY access bypassing the dominant lock — an
            # unguarded READ racing guarded writes observes torn/stale
            # state (the stats()-snapshot class), not just unguarded
            # writes
            bad = [a for a in live if lock not in a[3]]
        else:
            bad = writes
        if not bad:
            continue
        bad.sort(key=lambda a: (a[0][0], a[2]))
        fn, _kind, line, _held, _t = bad[0]
        r1, r2 = _roots_pair(ent)
        guarded_site = None
        if lock:
            for afn, _k, aline, aheld, _it in live:
                if lock in aheld:
                    guarded_site = (afn[0], aline)
                    break
        if lock:
            msg = ("shared state %s is reached from roots %s and %s and "
                   "guarded by %s at %d of %d accesses — but this %s "
                   "bypasses it: wrap it in `with %s` (and annotate the "
                   "attribute `# guarded-by: %s`), or suppress with a "
                   "written reason if the bypass is provably safe"
                   % (owner, r1, r2, lock, nheld, total, bad[0][1],
                      _bare(lock), _bare(lock)))
        else:
            how = ("no lock held at any access" if best is None else
                   "no dominant lock (best: %s at %d of %d accesses)"
                   % (best, best_n, total))
            msg = ("shared mutable state %s is written from >= 2 thread "
                   "roots (%s, %s) with %s — guard it with one lock, "
                   "annotate `# guarded-by: <lock>`, or mark it "
                   "`# thread-confined: <reason>` / `# race-ok: <reason>` "
                   "if the access pattern is provably safe"
                   % (owner, r1, r2, how))
        out.append(Finding(
            "unguarded-shared-write", fn[0], line, 0, msg, context=fn[1],
            chain=_chain(ent, lock, guarded_site,
                         [(a[0], a[2]) for a in bad])))

    # ---- check-then-act -------------------------------------------------
    flagged = set()
    for owner in sorted(shared):
        ent = shared[owner]
        if len(ent.roots) < 2 or _exempt(owner):
            continue
        by_fn = {}
        for a in ent.accesses:
            if not _is_setup(a[0]):
                by_fn.setdefault(a[0], []).append(a)
        for fn, accs in sorted(by_fn.items()):
            if (fn, owner) in flagged:
                continue
            reads = [a for a in accs if a[4] and a[1] == "read"]
            writes = [a for a in accs if a[1] == "write" and a[3]]
            for _rfn, _rk, rline, rheld, _rt in sorted(
                    reads, key=lambda a: a[2]):
                w = next((a for a in writes
                          if a[2] > rline
                          and not set(a[3]) <= set(rheld)), None)
                if w is None:
                    continue
                missing = sorted(set(w[3]) - set(rheld))[0]
                flagged.add((fn, owner))
                out.append(Finding(
                    "check-then-act", fn[0], rline, 0,
                    "check-then-act on shared state %s: this test reads "
                    "it without %s but the write at line %d holds it — "
                    "another thread can change the value between the "
                    "check and the act; take `with %s` around the whole "
                    "test-and-set" % (owner, missing, w[2],
                                      _bare(missing)),
                    context=fn[1],
                    chain=["line %d: read in the test, locks held: %s"
                           % (rline, ", ".join(rheld) or "none"),
                           "line %d: write under %s" % (w[2], missing)]))
                break

    # ---- unbalanced-acquire ---------------------------------------------
    for lid, path, line, fn in sorted(g.unbalanced):
        releasers = g.release_sites.get(lid, set())
        # cross-function handoff (__enter__/__exit__-style): a sibling
        # function of the same class/file releasing the same lock is the
        # pairing, not a leak
        cls = fn[1].rsplit(".", 1)[0] if "." in fn[1] else None
        if any(r != fn and r[0] == fn[0]
               and (cls is None or r[1].startswith(cls + "."))
               for r in releasers):
            continue
        out.append(Finding(
            "unbalanced-acquire", path, line, 0,
            "%s.acquire() with no release() in %s: an exception between "
            "acquire and release leaves the lock held forever — use "
            "`with %s`, or release in a `finally`"
            % (_bare(lid), fn[1], _bare(lid)),
            context=fn[1],
            chain=["line %d: manual acquire of %s" % (line, lid),
                   "no release() in %s (releases elsewhere: %s)"
                   % (fn[1], ", ".join(sorted(r[1] for r in releasers))
                      or "none")]))

    # ---- guard-mismatch -------------------------------------------------
    for ctx in ctxs:
        info = g.infos.get(ctx.path)
        if info is None:
            continue
        for node in ctx.nodes:
            if not isinstance(node, ast.Assign):
                continue
            m = _GUARDED_BY_RE.search(ctx.comments.get(node.lineno, ""))
            if not m:
                continue
            annotated = m.group(1)
            for t in node.targets:
                owner = None
                if isinstance(t, ast.Attribute) \
                        and _dotted(t.value) == "self":
                    cls = ctx.qualnames.get(node, "").split(".")[0]
                    if cls in info.class_names:
                        owner = "%s.%s.%s" % (info.mod, cls, t.attr)
                elif isinstance(t, ast.Name) \
                        and ctx.qualnames.get(node) == "<module>":
                    owner = "%s.%s" % (info.mod, t.id)
                if owner is None or owner not in shared:
                    continue
                live = [a for a in shared[owner].accesses
                        if not _is_setup(a[0])]
                lock, nheld, total = _dominant_lock(live)
                if lock is None or nheld * 2 <= total or nheld < 2:
                    continue
                if _bare(lock) == annotated:
                    continue
                out.append(Finding(
                    "guard-mismatch", ctx.path, node.lineno, 0,
                    "%s is annotated `# guarded-by: %s` but %d of %d "
                    "accesses actually hold %s — lock-discipline is "
                    "enforcing the wrong contract; fix the annotation "
                    "or the code" % (owner, annotated, nheld, total,
                                     lock),
                    context=ctx.qualnames.get(node, ""),
                    chain=["declared guarded-by %s here" % annotated,
                           "inferred dominant lock: %s (%d/%d accesses)"
                           % (lock, nheld, total)]))
    return out
