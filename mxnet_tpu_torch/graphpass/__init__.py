"""graphpass — the graph-level optimization pipeline over Symbol
(counterpart of ``mxnet_tpu/graphpass``).

The executor and the fused step run the graph as it was built. Two
things need a pass over the Symbol itself:

* **identity**: two structurally-equal graphs built in different orders
  (operand order of commutative ops, construction order of towers) must
  hash to the same digest, or the compile registry counts a rebind of the
  same network as a new program and the compile cache
  (:mod:`..compile_cache`) misses on a cosmetic difference;
* **redundancy**: duplicate subexpressions, constant subgraphs and no-op
  scalar chains cost a kernel launch each, on every step.

Every pass is a pure ``Symbol -> Symbol`` function registered in
:data:`PASS_REGISTRY`; the default pipeline is
``canonicalize -> fold_constants -> eliminate_common_subexpr ->
fuse_elemwise``. ``MXNET_GRAPH_PASSES`` is the opt-out ladder:

* unset / ``default`` — the default pipeline;
* ``none`` / ``off`` / ``0`` — passes disabled (the graph runs as built);
* a comma list (``canonicalize,cse``) — exactly those passes, in order;
* ``default,-cse`` — the default pipeline minus the named passes;
* ``default,bucket_shapes`` — the default plus opt-in passes
  (``bucket_shapes`` changes declared bind shapes, so it never runs
  unless asked for).

The pipeline is contract-checked: a pass must preserve the argument /
auxiliary-state name sets and the output arity (the binding surface
Module and Executor key on). If any pass breaks the contract or raises,
:func:`optimize` falls back to the unoptimized graph and counts
``graphpass.fallbacks`` — graph optimization must never take down a fit.

Telemetry: ``graphpass.pass_seconds`` per pass (while
:func:`telemetry.enabled`), always-on ``graphpass.nodes_eliminated`` /
``graphpass.nodes_fused`` / ``graphpass.errors`` /
``graphpass.fallbacks`` counters.
"""
from __future__ import annotations

import logging
import time

from .. import telemetry
from ..base import env_str as _env_str

__all__ = [
    "PASS_REGISTRY", "DEFAULT_PIPELINE", "register_pass", "list_passes",
    "active_passes", "run_pass", "optimize", "structural_hash",
]

_log = logging.getLogger(__name__)

PASS_REGISTRY = {}  # name -> pure Symbol -> Symbol function

# passes outside DEFAULT_PIPELINE (bucket_shapes) are opt-in: they change
# observable behavior (declared bind shapes) rather than just the graph run
DEFAULT_PIPELINE = ("canonicalize", "fold_constants",
                    "eliminate_common_subexpr", "fuse_elemwise")

_PASS_ALIASES = {"cse": "eliminate_common_subexpr"}


def register_pass(name):
    """Decorator: register a pure ``Symbol -> Symbol`` pass under ``name``."""
    def _reg(fn):
        PASS_REGISTRY[name] = fn
        return fn
    return _reg


def list_passes():
    """Registered pass names (registry order)."""
    return list(PASS_REGISTRY)


def active_passes():
    """The pass list selected by ``MXNET_GRAPH_PASSES`` (see module doc)."""
    spec = _env_str("MXNET_GRAPH_PASSES", "default")
    if spec.strip().lower() in ("none", "off", "0", ""):
        return ()
    names = []
    removed = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("-"):
            removed.add(_PASS_ALIASES.get(tok[1:].strip(),
                                          tok[1:].strip()))
            continue
        if tok.lower() in ("default", "all"):
            names.extend(n for n in DEFAULT_PIPELINE if n not in names)
            continue
        tok = _PASS_ALIASES.get(tok, tok)
        if tok not in PASS_REGISTRY:
            _log.warning("MXNET_GRAPH_PASSES: unknown pass %r (have %s) — "
                         "skipped", tok, ",".join(PASS_REGISTRY))
            continue
        if tok not in names:
            names.append(tok)
    return tuple(n for n in names if n not in removed)


def run_pass(name, symbol):
    """Run one registered pass; returns the transformed Symbol (the input
    Symbol is never mutated — passes copy first)."""
    return PASS_REGISTRY[name](symbol)


def _binding_surface(symbol):
    """The contract every pass must preserve: arg/aux name SETS (order is
    re-imposed by the executor's name-keyed binding) + output arity."""
    return (frozenset(symbol.list_arguments()),
            frozenset(symbol.list_auxiliary_states()),
            len(symbol._entries))


def optimize(symbol, passes=None):
    """Run the active pass pipeline over ``symbol``; returns the optimized
    Symbol, or ``symbol`` itself when passes are disabled, a pass fails,
    or the pipeline breaks the binding surface (counted
    ``graphpass.fallbacks`` — never raises into the bind path)."""
    names = tuple(passes) if passes is not None else active_passes()
    if not names:
        return symbol
    try:
        surface = _binding_surface(symbol)
    except Exception:
        # a graph the introspection walk cannot classify is a graph the
        # passes have no business rewriting
        telemetry.counter("graphpass.fallbacks").inc()
        return symbol
    g = symbol
    timed = telemetry.enabled()
    for name in names:
        fn = PASS_REGISTRY.get(name)
        if fn is None:
            _log.warning("graphpass: unknown pass %r skipped", name)
            continue
        t0 = time.perf_counter() if timed else 0.0
        try:
            g = fn(g)
        except Exception:
            telemetry.counter("graphpass.errors", **{"pass": name}).inc()
            _log.exception("graphpass: pass %r failed — graph left as it "
                           "was before the pass", name)
            continue
        if timed:
            telemetry.histogram("graphpass.pass_seconds",
                                **{"pass": name}).observe(
                time.perf_counter() - t0)
    try:
        ok = _binding_surface(g) == surface
    except Exception:
        ok = False
    if not ok:
        telemetry.counter("graphpass.fallbacks").inc()
        _log.warning("graphpass: pipeline %s changed the binding surface — "
                     "falling back to the unoptimized graph", list(names))
        return symbol
    return g


# importing the pass implementations registers them
from . import passes as _passes  # noqa: E402,F401
from .passes import structural_hash  # noqa: E402
