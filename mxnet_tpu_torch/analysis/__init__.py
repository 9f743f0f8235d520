"""Static analysis and runtime checkers of the framework's invariants (the
port's copy of ``mxnet_tpu/analysis``).

Two halves:

* ``fwlint`` — an AST lint engine whose checkers each encode a bug class
  the framework has shipped (raw ``MXNET_*`` env parsing, fire-and-forget
  threads, swallowed exceptions, lock discipline and ordering, shared
  state written from two threads; and, where the JAX package checks its
  jit and trace hazards, the port's CUDA-graph hazards: host syncs in the
  step path, captures outside the compile registry, host effects inside a
  capture, per-step graph keys). The dataflow-aware checkers ride on
  ``dataflow.py`` (per-function device/per-step value tracking with
  ``--explain``-able provenance chains) and ``lockgraph.py`` (the
  whole-package lock-acquisition graph). CLI: ``python -m
  mxnet_tpu_torch.tools.fwlint``, which ratchets on
  ``fwlint_baseline.json`` beside this package so existing debt is frozen
  and only *new* violations fail.
* ``sanitizer`` — a runtime checker for the engine's dependency contracts
  (``MXNET_ENGINE_SANITIZER=warn|strict``): pushed functions are wrapped and
  their actual NDArray reads/writes compared against the declared
  ``const_vars``/``mutable_vars``. ``witness`` is its locking sibling
  (``MXNET_LOCK_WITNESS=warn|strict``): declared locks record observed
  acquisition order, hold time and contention, cross-checked against the
  static lock graph.

This package imports only the standard library at import time (no torch,
no numpy): the CLI loads it standalone so linting a tree never pays the
framework's import cost. The sanitizer and the witness pull their
framework dependencies lazily.
"""
from .fwlint import Finding, RULES, lint_paths, lint_source, run_lint

__all__ = ["Finding", "RULES", "lint_paths", "lint_source", "run_lint",
           "sanitizer", "witness"]


def __getattr__(name):
    # lazy: the sanitizer/witness submodules are runtime wiring
    # (engine/ndarray/telemetry); the lint half must stay importable
    # standalone (see module docstring)
    if name in ("sanitizer", "witness"):
        import importlib

        # NOT `from . import sanitizer`: the fromlist machinery consults
        # this very __getattr__ while the submodule is mid-import → recursion
        return importlib.import_module(__name__ + "." + name)
    raise AttributeError(name)
