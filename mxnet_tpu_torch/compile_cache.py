"""Persistent cross-process compile cache (counterpart of
``mxnet_tpu/compile_cache.py``).

A fresh process pays for every program it compiles. On this card the
compiled artifacts that can outlive a process are the kernels' ``nvcc``
shared libraries (``ops/_build.py``): a fresh tree (a checkout, a worker
relaunched by ``tools/launch.py --elastic``) rebuilds them all, tens of
seconds each. This module keeps them, keyed by the identity the compile
registry computes: ``(program, graph or source digest, input signature,
platform fingerprint)``.

Everything is rooted at ``MXNET_COMPILE_CACHE_DIR``:

* **artifacts** (``<dir>/aot/<key>``): an ``nvcc`` library, stored with a
  CRC32 footer (``utils/atomic_file.py``, written atomically: two workers
  under ``launch.py`` share one directory). With the cache on,
  ``_build.build`` looks here before it starts ``nvcc`` and copies a hit
  into the build directory before loading it; after a cold build it saves
  the library. A torn or corrupt artifact is counted
  (``compile.cache_errors``, always-on), removed, rebuilt and overwritten.
* **the marker index** (``<dir>/meta/<key>``): how the compile registry
  tells a warm compile from a cold one for every other program —
  ``compile.cache_hits{program}`` when a previous process compiled the
  key, ``compile.cache_misses{program}`` otherwise. A CUDA-graph capture
  or a first run at a new signature cannot outlive its process: those
  are classified but always repeated (``ROADMAP.md`` C18).

Invalidation is by construction: the key includes the platform
fingerprint (package, torch and CUDA versions, the nvcc version, the
card's name, capability and count, and a digest of ``csrc/`` and the
nvcc flags), so a toolchain upgrade or a kernel edit simply misses. Size
is bounded by ``MXNET_COMPILE_CACHE_MAX_MB`` (oldest-first eviction at
enable time, markers spared, ``compile.cache_evictions``).

The whole module is inert until :func:`enable` runs — importing it (or
the package) with the variable unset configures nothing and costs
nothing.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import subprocess
import threading
import time

from . import telemetry
from .base import env_bool as _env_bool
from .base import env_int as _env_int
from .base import env_str as _env_str

__all__ = [
    "enable", "disable", "enabled", "aot_enabled", "cache_dir",
    "maybe_enable_from_env", "fingerprint", "make_key",
    "classify_compile", "save_executable", "load_executable",
    "prune", "stats", "ENV_DIR",
]

_log = logging.getLogger(__name__)

ENV_DIR = "MXNET_COMPILE_CACHE_DIR"
_CACHE_FORMAT = 1  # bump to invalidate every existing entry

_lock = threading.Lock()
# race-ok: writes serialize under _lock; fast-path reads sample single
# dict slots (atomic under the GIL) and tolerate one stale configure()
_state = {"dir": None, "aot": False}
_fingerprint_cache = [None]


def maybe_enable_from_env():
    """Enable the cache when ``MXNET_COMPILE_CACHE_DIR`` is set (called
    once at package import)."""
    d = _env_str(ENV_DIR)
    if d:
        enable(d)
    return enabled()


def enable(directory, aot=None, max_mb=None):
    """Turn the cache on at ``directory`` (created if absent). ``aot``
    (keep artifacts, not only markers) defaults from
    ``MXNET_COMPILE_CACHE_AOT`` (on), ``max_mb`` from
    ``MXNET_COMPILE_CACHE_MAX_MB`` (2048)."""
    directory = os.path.abspath(directory)
    if aot is None:
        aot = _env_bool("MXNET_COMPILE_CACHE_AOT", True)
    if max_mb is None:
        max_mb = _env_int("MXNET_COMPILE_CACHE_MAX_MB", 2048)
    try:
        os.makedirs(os.path.join(directory, "aot"), exist_ok=True)
        os.makedirs(os.path.join(directory, "meta"), exist_ok=True)
    except OSError:
        telemetry.counter("compile.cache_errors").inc()
        _log.warning("compile cache: cannot create %s — cache disabled",
                     directory)
        return False
    with _lock:
        _state["dir"] = directory
        _state["aot"] = bool(aot)
    if max_mb and max_mb > 0:
        prune(max_mb)
    return True


def disable():
    """Forget the cache (test isolation)."""
    with _lock:
        _state.update(dir=None, aot=False)


def enabled():
    return _state["dir"] is not None


def aot_enabled():
    return _state["dir"] is not None and _state["aot"]


def cache_dir():
    return _state["dir"]


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def _csrc_fingerprint():
    """Digest of the kernel sources (``csrc/*.cu``, ``csrc/*.cuh``) and the
    nvcc flags: what shapes what a kernel library computes (the JAX
    package's lowering fingerprint hashes the code that lowers to
    programs)."""
    from .ops import _build

    h = hashlib.sha1()
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))
                       + glob.glob(os.path.join(_build.CSRC, "*.cuh"))):
        try:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode())
                h.update(f.read())
        except OSError:
            continue  # a file vanishing mid-walk: a different hash, a miss
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc_version():
    """The CUDA toolkit's nvcc version, read from its ``version.json``
    (nothing is run); ``none`` without a toolkit."""
    from .ops import _build

    try:
        nvcc = _build._nvcc()
    except Exception:
        return "none"
    root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    try:
        with open(os.path.join(root, "version.json")) as f:
            info = json.load(f)
        return str((info.get("cuda_nvcc") or info.get("cuda") or {})
                   .get("version", "?"))
    except (OSError, ValueError, AttributeError):
        try:
            return "%s:%d" % (os.path.basename(nvcc), os.path.getsize(nvcc))
        except OSError:
            return "?"


def _cards():
    """``(name, capability, count)`` of the cards, read with
    ``nvidia-smi`` and ``torch.cuda.device_count`` so that CUDA is not
    initialized in this process."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        return "none", "none", 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,compute_cap",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        first = out.stdout.strip().splitlines()[0]
        name, cap = (x.strip() for x in first.rsplit(",", 1))
        return name, cap, count
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return "?", "?", count


def fingerprint():
    """The platform fingerprint baked into every key: an artifact built
    by another torch, CUDA or nvcc, for another card or card count, by
    another package version or from other kernel sources must never
    load. Computed once per process, and only while the cache is used."""
    fp = _fingerprint_cache[0]
    if fp is None:
        import torch

        try:
            from mxnet_tpu_torch import __version__ as fw_ver
        except ImportError:   # mid-package-import: csrc still pins the code
            fw_ver = "?"
        name, cap, count = _cards()
        fp = ("v%d|torch=%s|cuda=%s|nvcc=%s|device=%s|cap=%s|n=%d"
              "|mxt=%s|csrc=%s" % (
                  _CACHE_FORMAT, torch.__version__, torch.version.cuda,
                  _nvcc_version(), name, cap, count, fw_ver,
                  _csrc_fingerprint()))
        _fingerprint_cache[0] = fp
    return fp


def make_key(program, graph_digest, signature):
    """Stable cache key: sha1 over (fingerprint, program, graph digest,
    input signature). ``signature`` is compileobs's per-leaf (name, kind,
    shape, dtype) tuple (``()`` for an nvcc library); ``graph_digest``
    any stable value describing the program (a symbol digest, a kernel
    library's source digest)."""
    h = hashlib.sha1()
    h.update(fingerprint().encode())
    h.update(("|%s|%r|%r" % (program, graph_digest, signature)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the marker index: cold-vs-warm classification
# ---------------------------------------------------------------------------


def classify_compile(program, key, seconds=None, hit=None):
    """Called by compileobs when a compile event lands: ``"hit"`` when
    this key was compiled by a previous process, ``"miss"`` on a cold
    compile (the marker is written so the NEXT process classifies warm).
    ``hit`` overrides the marker lookup where the caller knows (an nvcc
    library copied from the cache, or built after a corrupt artifact).
    Counted always-on: ``compile.cache_hits`` / ``compile.cache_misses``;
    None while the cache is off."""
    d = _state["dir"]
    if d is None:
        return None
    marker = os.path.join(d, "meta", key)
    try:
        if hit is None:
            hit = os.path.exists(marker)
        if hit:
            telemetry.counter("compile.cache_hits", program=program).inc()
            return "hit"
        tmp = marker + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            f.write("%s %.3f %s\n" % (program, seconds or 0.0,
                                      time.strftime("%Y-%m-%dT%H:%M:%S")))
        os.replace(tmp, marker)
    except OSError:
        telemetry.counter("compile.cache_errors").inc()
    telemetry.counter("compile.cache_misses", program=program).inc()
    return "miss"


# ---------------------------------------------------------------------------
# the artifact store
# ---------------------------------------------------------------------------


def _aot_path(key):
    return os.path.join(_state["dir"], "aot", key)


def save_executable(key, path, program="?"):
    """Store the file at ``path`` (an nvcc library) under ``key``,
    atomically and with a CRC32 footer. Returns True on success; an IO
    failure is an error-counted no-op, never a failure of the build that
    made the library."""
    if not aot_enabled():
        return False
    from .utils.atomic_file import atomic_write

    try:
        with open(path, "rb") as f:
            blob = f.read()
        with atomic_write(_aot_path(key), checksum=True,
                          fault_name=None) as w:
            w.write(blob)
        return True
    except OSError:
        telemetry.counter("compile.cache_errors").inc()
        _log.warning("compile cache: could not store program %r",
                     program, exc_info=True)
        return False


def load_executable(key, program="?", dest=None):
    """The artifact stored under ``key``, verified against its footer:
    copied to ``dest`` (atomically: a process that loaded an older file
    there keeps its own) and ``dest`` returned, or the payload's bytes
    without ``dest``. None when absent (a routine miss) or corrupt —
    counted ``compile.cache_errors``; the bad file is removed so the
    cold build that follows overwrites it."""
    if not aot_enabled():
        return None
    from .utils.atomic_file import ChecksumError, footer_crc, read_verified

    path = _aot_path(key)
    if not os.path.exists(path):
        return None
    try:
        if footer_crc(path) is None:
            raise ChecksumError("artifact has no checksum footer")
        blob = read_verified(path)
        if dest is None:
            return blob
        tmp = "%s.tmp.%d" % (dest, os.getpid())
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, dest)
        return dest
    except (OSError, ChecksumError):
        telemetry.counter("compile.cache_errors").inc()
        _log.warning("compile cache: corrupt artifact for program %r "
                     "(key %s) — removed, compiling cold", program, key[:12])
        try:
            os.unlink(path)
        except OSError:
            pass  # another process may have removed the same artifact
        return None


# ---------------------------------------------------------------------------
# size bound + stats
# ---------------------------------------------------------------------------


def prune(max_mb):
    """Evict oldest-mtime files until the cache fits ``max_mb``. Counted
    ``compile.cache_evictions``.

    The marker index is not a payload store: markers are tiny
    classification records whose eviction would corrupt the hit/miss split
    (a missing marker reads as a cold compile), so they are only reaped
    last — and evicting an artifact removes its paired marker, keeping key
    presence aligned with the artifact it classifies."""
    d = _state["dir"]
    if d is None or not max_mb:
        return 0
    meta_dir = os.path.join(d, "meta")
    aot_dir = os.path.join(d, "aot")
    payloads, markers = [], []
    total = 0
    for root, _dirs, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue  # removed meanwhile: nothing to prune
            (markers if root == meta_dir else payloads).append(
                (st.st_mtime, st.st_size, p))
            total += st.st_size
    budget = int(max_mb) * (1 << 20)
    evicted = 0
    if total > budget:
        payloads.sort()
        markers.sort()
        for _mtime, size, p in payloads + markers:
            if total <= budget:
                break
            try:
                os.unlink(p)
                total -= size
                evicted += 1
            except OSError:
                continue  # another process evicted it first
            if os.path.dirname(p) == aot_dir:
                try:
                    os.unlink(os.path.join(meta_dir, os.path.basename(p)))
                except OSError:
                    pass  # no paired marker
    if evicted:
        telemetry.counter("compile.cache_evictions").inc(evicted)
        _log.info("compile cache: evicted %d entries to fit %d MB",
                  evicted, max_mb)
    return evicted


def stats():
    """One snapshot for bench records and ``/stats`` endpoints: state,
    artifact counts/bytes, and the process's hit/miss/error totals."""
    d = _state["dir"]
    out = {"enabled": d is not None, "dir": d,
           "aot": aot_enabled(),
           "hits": telemetry.totals("compile.cache_hits")[1],
           "misses": telemetry.totals("compile.cache_misses")[1],
           "errors": telemetry.totals("compile.cache_errors")[1]}
    if d is not None:
        n = nbytes = 0
        try:
            for name in os.listdir(os.path.join(d, "aot")):
                try:
                    nbytes += os.path.getsize(os.path.join(d, "aot", name))
                    n += 1
                except OSError:
                    continue  # evicted mid-listing
        except OSError:
            telemetry.counter("compile.cache_errors").inc()
        out["aot_artifacts"] = n
        out["aot_bytes"] = nbytes
    return out
