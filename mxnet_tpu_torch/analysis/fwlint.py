"""fwlint core — AST lint driver, suppressions, fingerprints (the port's
copy of ``mxnet_tpu/analysis/fwlint.py``).

The driver parses each file once into a :class:`FileContext` (AST + parent
links + qualnames + comment map + inline suppressions) and hands it to every
selected checker (``checkers.py``). Checkers return :class:`Finding`s;
the driver resolves suppressions and assigns line-drift-stable fingerprints
used by the baseline ratchet (``baseline.py``).

Suppressions::

    x = os.environ.get("MXNET_X")  # fwlint: disable=env-raw-read — reason
    # fwlint: disable=thread-hygiene — reason (applies to the next line)

Stdlib-only by design — see the package docstring.
"""
from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize

__all__ = ["Finding", "FileContext", "RULES", "lint_source", "lint_paths",
           "run_lint", "iter_python_files", "load_contexts",
           "import_alias_map"]


def import_alias_map(ctx, known_paths):
    """alias -> repo-relative path for every import in ``ctx`` that
    resolves to a file in ``known_paths`` (absolute, relative, and
    ``as``-renamed forms). THE shared resolver: lock-order's call-graph
    and capture-impure's cross-file closure must agree on what an alias
    means, so there is exactly one implementation. Cached per context +
    path-set (lock-order and capture-impure resolve the same map)."""
    import posixpath

    key = frozenset(known_paths)
    cached = getattr(ctx, "_alias_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    out = {}
    pkg = posixpath.dirname(ctx.path)
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    base = alias.name.replace(".", "/")
                    for cand in (base + ".py", base + "/__init__.py"):
                        if cand in known_paths:
                            out[alias.asname] = cand
                            break
                else:
                    # `import a.b` (no asname) binds the ROOT package
                    # name `a`, not a.b — mapping `a` to a/b.py would
                    # resolve `a.<attr>` against the wrong file
                    root = alias.name.split(".")[0]
                    for cand in (root + ".py", root + "/__init__.py"):
                        if cand in known_paths:
                            out.setdefault(root, cand)
                            break
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = (node.module or "").replace(".", "/")
            else:
                base = pkg
                for _ in range(node.level - 1):
                    base = posixpath.dirname(base)
                if node.module:
                    base = posixpath.join(base,
                                          node.module.replace(".", "/"))
            for alias in node.names:
                for cand in (posixpath.join(base, alias.name + ".py"),
                             posixpath.join(base, alias.name,
                                            "__init__.py")):
                    if cand in known_paths:
                        out[alias.asname or alias.name] = cand
                        break
    ctx._alias_cache = (key, out)
    return out

# rule tokens separated by commas; capture stops at the first token that is
# not a rule name, so an ASCII-hyphen reason ("... disable=rule - why") does
# not corrupt the rule set
_SUPPRESS_RE = re.compile(r"#\s*fwlint:\s*disable="
                          r"([\w\-]+(?:\s*,\s*[\w\-]+)*)")


class Finding:
    """One lint violation: ``rule`` at ``path:line``, with the enclosing
    ``context`` (dotted class/function qualname), a ``fingerprint`` that
    survives unrelated line drift (it hashes rule + path + context +
    normalized source text + same-text ordinal, never the line number),
    and an optional provenance ``chain`` — the dataflow steps that tainted
    the flagged value (``fwlint --explain <fingerprint>`` prints
    it; never part of the fingerprint, so chain wording can improve
    without churning baselines)."""

    __slots__ = ("rule", "path", "line", "col", "message", "context",
                 "text", "fingerprint", "suppressed", "chain")

    def __init__(self, rule, path, line, col, message, context="", text="",
                 chain=()):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.context = context
        self.text = text
        self.fingerprint = None
        self.suppressed = False
        self.chain = tuple(chain)

    def __repr__(self):
        return "%s:%d: [%s] %s" % (self.path, self.line, self.rule,
                                   self.message)

    def as_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "context": self.context, "text": self.text,
                "fingerprint": self.fingerprint,
                "chain": list(self.chain)}


class FileContext:
    """Everything a checker needs about one source file."""

    def __init__(self, path, source):
        self.path = path  # repo-relative, posix separators
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.parents = {}
        self.qualnames = {}
        self.nodes = []  # every node, pre-order — checkers iterate this
        # instead of re-running ast.walk (one tree traversal per file,
        # however many rules consult it)
        self._link(self.tree, None, ())
        self.comments = self._comments(source)
        self.suppressions = self._suppressions()

    def _link(self, node, parent, stack):
        self.parents[node] = parent
        self.nodes.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            stack = stack + (node.name,)
        self.qualnames[node] = ".".join(stack) or "<module>"
        for child in ast.iter_child_nodes(node):
            self._link(child, node, stack)

    @staticmethod
    def _comments(source):
        out = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        return out

    def _suppressions(self):
        sup = {}
        for line, text in self.comments.items():
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            sup.setdefault(line, set()).update(rules)
            # ONLY a standalone pragma line covers the statement under it —
            # extending a trailing pragma to line+1 would silently exempt
            # whatever gets written there next (a ratchet soundness hole)
            src = self.lines[line - 1].strip() if line <= len(self.lines) \
                else ""
            if src.startswith("#"):
                sup.setdefault(line + 1, set()).update(rules)
        return sup

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def ancestors(self, node):
        node = self.parents.get(node)
        while node is not None:
            yield node
            node = self.parents.get(node)

    def suppressed(self, finding):
        rules = self.suppressions.get(finding.line, ())
        return "all" in rules or finding.rule in rules


def _finalize(findings):
    """Assign drift-stable fingerprints; the ordinal disambiguates textually
    identical findings in the same scope (file order is deterministic)."""
    seen = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.context, f.text)
        occ = seen.get(key, 0)
        seen[key] = occ + 1
        raw = "|".join([f.rule, f.path, f.context, f.text, str(occ)])
        f.fingerprint = hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]
    return findings


def _checker_registry():
    # attribute-form import: `from . import checkers` would make the import
    # system import the HEAD package (``mxnet_tpu_torch``, torch and all),
    # which the standalone CLI loader (``tools/fwlint.py``) leaves unimported
    from .checkers import CHECKERS

    return CHECKERS


def _repo_checker_registry():
    """Checkers that need EVERY file at once (lock-order's whole-repo
    acquisition graph, capture-impure's cross-file call closure). Signature:
    ``(list[FileContext]) -> [Finding]`` with a ``rules`` attribute."""
    from .checkers import REPO_CHECKERS

    return REPO_CHECKERS


def _rules():
    rules = []
    for chk in list(_checker_registry()) + list(_repo_checker_registry()):
        rules.extend(chk.rules)
    return tuple(sorted(set(rules)))


class _Rules:
    """Lazy tuple of every known rule name (avoids import cycles)."""

    def __iter__(self):
        return iter(_rules())

    def __contains__(self, item):
        return item in _rules()

    def __repr__(self):
        return repr(_rules())


RULES = _Rules()


def _file_findings(fctx, select):
    findings = []
    for chk in _checker_registry():
        if select is not None and not (set(chk.rules) & set(select)):
            continue
        # per-finding, not just per-checker: a multi-rule checker (the
        # concurrency pass carries four rules) must not leak findings for
        # rules outside the selection
        findings.extend(f for f in chk(fctx)
                        if select is None or f.rule in select)
    return findings


def _repo_findings(fctxs, select):
    findings = []
    for chk in _repo_checker_registry():
        if select is not None and not (set(chk.rules) & set(select)):
            continue
        findings.extend(f for f in chk(fctxs)
                        if select is None or f.rule in select)
    return findings


def _resolve(findings, by_path):
    """Fill context/text, apply each file's inline suppressions, and
    fingerprint whatever survives."""
    live = []
    for f in findings:
        fctx = by_path.get(f.path)
        f.context = f.context or ""
        if fctx is not None:
            f.text = f.text or fctx.line_text(f.line)
            f.suppressed = fctx.suppressed(f)
        if not f.suppressed:
            live.append(f)
    return _finalize(live)


def lint_source(source, path="<string>", select=None):
    """Lint one in-memory source blob; returns non-suppressed findings.

    The unit the tests drive: each checker gets a synthetic positive and
    negative case through here. Repo-scope rules (lock-order,
    capture-impure) see a one-file repo.
    """
    try:
        fctx = FileContext(path, source)
    except SyntaxError as err:
        f = Finding("parse-error", path, err.lineno or 1, 0,
                    "file does not parse: %s" % err.msg)
        return _finalize([f])
    findings = _file_findings(fctx, select) + _repo_findings([fctx], select)
    return _resolve(findings, {path: fctx})


def iter_python_files(paths, root):
    """Yield repo-relative posix paths of every .py under ``paths``.

    A nonexistent path raises: a gate tool that silently lints zero files
    for a typo'd argument would exit green while checking nothing.
    """
    for p in paths:
        ap = os.path.join(root, p) if not os.path.isabs(p) else p
        if not os.path.exists(ap):
            raise FileNotFoundError("fwlint: no such file or directory: %s"
                                    % ap)
        if os.path.isfile(ap):
            yield os.path.relpath(ap, root).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    yield rel.replace(os.sep, "/")


def load_contexts(paths, root):
    """Parse every .py under ``paths`` into FileContexts; returns
    ``(contexts, parse_error_findings)``."""
    ctxs, errors = [], []
    for rel in iter_python_files(paths, root):
        with open(os.path.join(root, rel), "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            ctxs.append(FileContext(rel, source))
        except SyntaxError as err:
            errors.append(Finding("parse-error", rel, err.lineno or 1, 0,
                                  "file does not parse: %s" % err.msg))
    return ctxs, errors


def lint_paths(paths, root, select=None):
    """Lint every .py file under ``paths`` (files or directories, relative
    to ``root``); returns the combined non-suppressed findings. Per-file
    checkers run per file; repo checkers (lock-order, capture-impure) run
    once over the whole context set."""
    ctxs, errors = load_contexts(paths, root)
    findings = list(errors)
    for fctx in ctxs:
        findings.extend(_file_findings(fctx, select))
    findings.extend(_repo_findings(ctxs, select))
    return _resolve(findings, {c.path: c for c in ctxs})


def run_lint(paths, root=None, select=None, baseline_path=None):
    """One-call API: lint ``paths`` and split against a baseline.

    Returns ``(new, known, stale)``: findings absent from the baseline (the
    ratchet fails on these), findings the baseline freezes, and baseline
    fingerprints that no longer fire (debt paid down — shrink with
    ``fwlint --update-baseline``).
    """
    # attr-form import — see _checker_registry
    from .baseline import diff as _diff, load as _load

    root = root or os.getcwd()
    findings = lint_paths(paths, root, select=select)
    if baseline_path and not os.path.isabs(baseline_path):
        baseline_path = os.path.join(root, baseline_path)
    base = _load(baseline_path) if baseline_path else {}
    return _diff(findings, base)
