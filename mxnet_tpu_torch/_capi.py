"""Build and locate the port's C API library, ``libmxtpu_predict.so``.

The library is the port's copy of the JAX package's C boundary
(``csrc/capi/``): the predict API ``c_predict_api.cc`` (reference:
``include/mxnet/c_predict_api.h``), the training, symbol, executor,
imperative, autograd, rtc, profiler, data-iterator and kvstore slice of
``c_api.h`` in ``c_api_train.cc``, and the pure C++ ``.params`` and
RecordIO codecs ``c_api_ndarray.cc`` and ``c_api_recordio.cc``. The first
two embed CPython and call :mod:`mxnet_tpu_torch.predict` and
:mod:`mxnet_tpu_torch.capi_train`, so a C or C++ program with no Python of
its own runs the port's executor, on the card unless the port's context
says otherwise (``MXNET_DEFAULT_CONTEXT=cpu``).

:func:`build` compiles the four sources with ``g++`` at first use into
``build/mxnet_tpu_torch/capi-<digest>/libmxtpu_predict.so`` (the digest
covers the sources, the headers and the flags), so a client links with
``-lmxtpu_predict`` as it does against the JAX package's library. Only
sources under ``csrc/capi/`` are compiled. Several processes may build at
once (test workers): the build runs under an exclusive file lock in its
directory, into a temporary name that is renamed into place
(``_cbuild.build_locked``).

The Python flags come from :mod:`sysconfig` of the running interpreter
(``INCLUDEPY``; ``LIBDIR``/``LIBPL``, ``LDLIBRARY``, ``Py_ENABLE_SHARED``)
and from its own ``python3.X-config --ldflags --embed`` where that
exists. Without ``g++`` or ``Python.h`` :func:`build` raises.

A compiled client::

    from mxnet_tpu_torch import _capi
    subprocess.run(["g++", "client.cpp", "-o", "client"] + _capi.client_flags())
    subprocess.run(["./client"], env=_capi.client_env())
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys
import sysconfig
import threading

from . import _cbuild
from .base import MXNetError

__all__ = ["build", "load", "library_dir", "include_dir", "client_flags",
           "client_env", "SRC_DIR", "SOURCES", "LIB_NAME"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
SRC_DIR = os.path.join(_PKG, "csrc", "capi")
BUILD_DIR = os.path.join(_ROOT, "build", "mxnet_tpu_torch")
SOURCES = ("c_predict_api.cc", "c_api_ndarray.cc", "c_api_train.cc",
           "c_api_recordio.cc")
LIB_NAME = "libmxtpu_predict.so"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_locks = {True: threading.Lock(), False: threading.Lock()}
# race-ok: each variant's slot is written under that variant's own lock in
# _locks; the dict holds one key per variant and a slot write is atomic
_built = {}
_loaded = None


def _python_config():
    """The running interpreter's own ``python3.X-config``, or None (a
    ``python3-config`` elsewhere on ``PATH`` may be another Python's)."""
    bindir = sysconfig.get_config_var("BINDIR") or ""
    ver = sysconfig.get_config_var("VERSION") or ""
    for name in ("python%s-config" % ver, "python3-config"):
        path = os.path.join(bindir, name)
        if os.access(path, os.X_OK):
            return path
    return None


def _python_flags(embed):
    """(compile flags, link flags) for ``Python.h`` and, when ``embed``,
    for linking libpython."""
    inc = sysconfig.get_config_var("INCLUDEPY")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        raise MXNetError("Python.h not found (INCLUDEPY=%r): the port's C "
                         "API library embeds CPython" % (inc,))
    cflags = ["-I" + inc]
    if not embed:
        return cflags, []
    cfg = _python_config()
    if cfg is not None:
        res = subprocess.run([cfg, "--ldflags", "--embed"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            lflags = res.stdout.split()
            libdirs = [f[2:] for f in lflags if f.startswith("-L")]
            return cflags, lflags + ["-Wl,-rpath," + d for d in libdirs]
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var(
        "VERSION")
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR")
    else:
        libdir = sysconfig.get_config_var("LIBPL")
    return cflags, ["-L" + libdir, "-Wl,-rpath," + libdir,
                    "-lpython" + ver, "-ldl", "-lm"]


def build(embed=True):
    """Compile the library unless it exists; returns its path. ``embed``
    links libpython (what a C client needs); without it the library
    resolves CPython's symbols from the process that loads it."""
    with _locks[bool(embed)]:
        if embed in _built and os.path.exists(_built[embed]):
            return _built[embed]
        if shutil.which("g++") is None:
            raise MXNetError("g++ not found: the port's C API library is "
                             "built from source at first use")
        cflags, lflags = _python_flags(embed)
        flags = list(CXXFLAGS) + cflags
        sources = (glob.glob(os.path.join(SRC_DIR, "*.cc"))
                   + glob.glob(os.path.join(SRC_DIR, "include", "*")))
        path = os.path.join(BUILD_DIR, "capi-%s" % _cbuild.digest(
            sources, flags + lflags), LIB_NAME)

        def make(tmp):
            cmd = (["g++"] + flags + ["-o", tmp]
                   + [os.path.join(SRC_DIR, s) for s in SOURCES] + lflags)
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
            if res.returncode != 0:
                raise MXNetError("building the port's C API library failed:"
                                 "\n%s" % res.stderr[-4000:])

        _cbuild.build_locked(path, make)
        _built[embed] = path
        return path


def _process_has_libpython():
    try:
        with open("/proc/self/maps") as f:
            return "libpython" in f.read()
    except OSError:
        return False


def load():
    """The library loaded into this interpreter with ``ctypes``
    (``RTLD_LOCAL``), its entry points then run on this process's
    interpreter and its port state (kernel launch counters included).
    Where this Python has no shared libpython, the variant that does not
    link one is loaded, so CPython's symbols come from this process.
    Never load it into a process that loaded the JAX package's library:
    both export the same ``MX*`` names."""
    global _loaded
    if _loaded is None:
        path = build(embed=_process_has_libpython())
        _loaded = ctypes.CDLL(path, mode=os.RTLD_LOCAL)
    return _loaded


def library_dir():
    """The directory holding ``libmxtpu_predict.so`` (built if needed)."""
    return os.path.dirname(build())


def include_dir():
    """The port's C and C++ headers (``c_predict_api.h``,
    ``c_train_api.h``, ``mxnet_predict.hpp``, ``mxnet_cpp.hpp``, ...)."""
    return os.path.join(SRC_DIR, "include")


def client_flags():
    """``g++``/``gcc`` flags that compile and link a client against the
    port's headers and library, with the library's directory as rpath."""
    lib = library_dir()
    return ["-I" + include_dir(), "-L" + lib, "-lmxtpu_predict",
            "-Wl,-rpath," + lib]


def client_env(env=None, cpu=False):
    """The environment for a compiled client: ``PYTHONPATH`` holding the
    checkout's root and this interpreter's import path (its embedded
    interpreter then finds the port and torch, inside a virtualenv too).
    ``cpu`` sets ``MXNET_DEFAULT_CONTEXT=cpu``; otherwise an inherited one
    is dropped, so the client runs on the card."""
    env = _cbuild.client_env(env, cpu)
    paths = [_ROOT] + [p for p in sys.path if p and os.path.isdir(p)]
    old = env.get("PYTHONPATH")
    if old:
        paths.append(old)
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env
