"""Build and locate the port's Python-free runtime,
``libmxtpu_predict_native.so`` (counterpart of the JAX package's
``mxnet_tpu/src/c_predict_pjrt.cc`` build).

The runtime (``csrc/native_rt/``) runs a ``.mxa`` artifact written by
:mod:`.export_artifact` through the C predict API and ``MXTrainNative*``
with no Python in the process: a C++ interpreter of the artifact's symbol
JSON over ATen, libtorch's C++ autograd for the training step, and the
port's own attention kernels (``csrc/flash_fwd.cu``,
``flash_bwd_dkv.cu``, ``flash_bwd_dq.cu``, ``flash_wide.cu``) through the
``extern "C"`` entry points their libraries export (``ROADMAP.md`` C34).
libtorch links no libpython, so neither does the runtime.

:func:`build` compiles the sources with ``g++`` at first use (one process
per source, all at once, then one link) into
``build/mxnet_tpu_torch/native-<digest>/libmxtpu_predict_native.so``
under an exclusive file lock, into a temporary name renamed into place
(``_cbuild.build_locked``, shared with ``_capi.py``).
The flags come from ``torch.utils.cpp_extension`` (its include and
library paths), ``torch.compiled_with_cxx11_abi()`` and C++20, the
standard torch's headers need. Against a CUDA torch the runtime links
``-Wl,--no-as-needed -ltorch_cuda`` (so the CUDA backend registers in a
process with no Python) and the kernel libraries that ``ops/_build.py``
builds, with an rpath; the digest covers the sources, the flags and those
libraries' names (which carry their own digests). Against a CPU torch
the kernels are not linked and attention runs the plain ATen version on
CPU tensors only. Each build is a ``compileobs`` compile of program
``g++.native_rt``; with the persistent compile cache on
(``MXNET_COMPILE_CACHE_DIR``) the library is kept there as the ``nvcc``
ones are.

A client::

    from mxnet_tpu_torch import _predict_native
    subprocess.run(["gcc", "client.c", "-o", "client"]
                   + _predict_native.client_flags())
    subprocess.run(["./client", ...], env=_predict_native.client_env(cpu=True))
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from . import _cbuild
from .base import MXNetError

__all__ = ["build", "load", "library_dir", "client_flags", "client_env",
           "kernel_launches", "SRC_DIR", "SOURCES", "LIB_NAME", "PROGRAM"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
SRC_DIR = os.path.join(_PKG, "csrc", "native_rt")
BUILD_DIR = os.path.join(_ROOT, "build", "mxnet_tpu_torch")
SOURCES = ("container.cc", "graph.cc", "ops.cc", "attention.cc", "dp.cc",
           "predict_api.cc", "train_api.cc")
LIB_NAME = "libmxtpu_predict_native.so"
PROGRAM = "g++.native_rt"
_SITE = "mxnet_tpu_torch/_predict_native.py:build"

_lock = threading.Lock()
_built = None
_loaded = None
#: seconds the last :func:`build` in this process spent compiling (0.0
#: when the library was already there)
build_seconds = 0.0


def _torch_flags():
    """(compile flags, link flags) for ATen and libtorch's autograd."""
    import torch
    from torch.utils import cpp_extension

    # torch's headers want C++20 (torch.utils.cpp_extension's own flag);
    # -O1: the runtime is host-side dispatch over ATen's compiled kernels,
    # and -O1 compiles its sources a quarter faster than -O2
    cflags = ["-O1", "-std=c++20", "-fPIC", "-pthread",
              "-D_GLIBCXX_USE_CXX11_ABI=%d"
              % int(torch.compiled_with_cxx11_abi())]
    cflags += ["-I" + p for p in cpp_extension.include_paths()]
    libdirs = cpp_extension.library_paths()
    # -Bsymbolic: the runtime's own MX* calls bind to itself, whatever
    # else in the process exports the same names
    lflags = ["-shared", "-pthread", "-Wl,-Bsymbolic"]
    lflags += ["-L" + d for d in libdirs]
    lflags += ["-Wl,-rpath," + d for d in libdirs]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    lflags += ["-Wl,--no-as-needed"] + libs + ["-Wl,--as-needed"]
    return cflags, lflags


def _kernels():
    """The port's attention kernels the runtime links (none against a CPU
    torch)."""
    import torch

    if not torch.version.cuda:
        return []
    from .ops import _build

    return [_build.FLASH_FWD, _build.FLASH_BWD_DKV, _build.FLASH_BWD_DQ,
            _build.FLASH_WIDE_FWD]


def _kernel_flags(kernels):
    """Compile and link flags for ``kernels``: their libraries are linked
    by name (which carries each one's digest) with an rpath."""
    if not kernels:
        return [], [], []
    from .ops import _build

    libs = [os.path.basename(k.library()) for k in kernels]
    lflags = ["-L" + _build.BUILD_DIR] + ["-l:" + n for n in libs] + [
        "-Wl,-rpath," + _build.BUILD_DIR]
    return ["-DMXT_NATIVE_KERNELS"], lflags, libs


def _compile(cflags, lflags, out, kernels):
    """g++ each source into an object beside ``out`` (all at once), build
    the kernel libraries meanwhile (``ops/_build.py``; the sources need
    only their C declarations), then link into ``out``."""
    objs, procs = [], []
    for src in SOURCES:
        obj = "%s.%s.o" % (out, os.path.splitext(src)[0])
        objs.append(obj)
        procs.append(subprocess.Popen(
            ["g++"] + cflags + ["-c", os.path.join(SRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    try:
        if kernels:
            from .ops import _build

            _build.build(kernels)
    finally:
        for src, proc in zip(SOURCES, procs):
            log, _ = proc.communicate(timeout=1800)
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (src, log[-4000:]))
    if not failed:
        res = subprocess.run(["g++", "-o", out] + objs + lflags,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            failed.append("link:\n%s" % res.stderr[-4000:])
    for obj in objs:
        if os.path.exists(obj):
            os.unlink(obj)
    if failed:
        raise MXNetError("building the port's native runtime failed:\n"
                         + "\n".join(failed))


def build():
    """Compile the runtime unless it exists; returns its path."""
    global _built, build_seconds
    with _lock:
        if _built is not None and os.path.exists(_built):
            return _built
        if shutil.which("g++") is None:
            raise MXNetError("g++ not found: the port's native runtime is "
                             "built from source at first use")
        from . import compile_cache, compileobs

        cflags, lflags = _torch_flags()
        kernels = _kernels()
        kc, kl, klibs = _kernel_flags(kernels)
        cflags += kc
        lflags += kl
        digest = _cbuild.digest(
            glob.glob(os.path.join(SRC_DIR, "*.cc"))
            + glob.glob(os.path.join(SRC_DIR, "*.h")), cflags + lflags + klibs)
        path = os.path.join(BUILD_DIR, "native-%s" % digest, LIB_NAME)
        key = compile_cache.make_key(PROGRAM, digest, ())
        cached = compile_cache.aot_enabled()
        build_seconds = 0.0

        def make(tmp):
            global build_seconds
            wall0, t0 = time.time(), time.perf_counter()
            if cached and compile_cache.load_executable(
                    key, PROGRAM, dest=tmp) is not None:
                compileobs.note_compile(
                    PROGRAM, time.perf_counter() - t0, site=_SITE,
                    wall0=wall0, cache_key=key, cached=True)
                return
            _compile(cflags, lflags, tmp, kernels)
            build_seconds = time.perf_counter() - t0
            compileobs.note_compile(
                PROGRAM, build_seconds, site=_SITE, wall0=wall0,
                cache_key=key if cached else None,
                cached=False if cached else None)

        _cbuild.build_locked(path, make)
        if kernels:  # the libraries its rpath names (built once)
            from .ops import _build

            _build.build(kernels)
        if cached and not os.path.exists(os.path.join(
                compile_cache.cache_dir(), "aot", key)):
            compile_cache.save_executable(key, path, PROGRAM)
        _built = path
        return path


def load():
    """The runtime loaded into this process with ``ctypes`` (it shares
    this process's libtorch). Never load it beside the JAX package's
    ``libmxtpu_predict_native.so`` or either package's
    ``libmxtpu_predict.so`` in one symbol scope: they export the same
    ``MX*`` names (``RTLD_LOCAL`` keeps them apart)."""
    global _loaded
    if _loaded is None:
        import torch  # noqa: F401 — libtorch resolved before the runtime

        lib = ctypes.CDLL(build(), mode=os.RTLD_LOCAL)
        lib.MXGetLastError.restype = ctypes.c_char_p
        lib.mxtpu_native_kernel_launches.restype = ctypes.c_longlong
        lib.mxtpu_native_kernel_launches.argtypes = [ctypes.c_char_p,
                                                     ctypes.c_int]
        _loaded = lib
    return _loaded


def kernel_launches(name, reset=False):
    """The runtime's launch count of kernel ``name`` in this process
    (``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq`` and their
    ``flash_wide_*`` twins); ``reset`` sets it to 0 after the read."""
    return int(load().mxtpu_native_kernel_launches(name.encode(),
                                                   int(bool(reset))))


def library_dir():
    """The directory holding ``libmxtpu_predict_native.so`` (built if
    needed)."""
    return os.path.dirname(build())


def client_flags():
    """``gcc``/``g++`` flags that link a client against the runtime, with
    its directory as rpath."""
    lib = library_dir()
    return ["-L" + lib, "-lmxtpu_predict_native", "-lm", "-Wl,-rpath," + lib]


def client_env(env=None, cpu=False):
    """The environment for a compiled client (:func:`_cbuild.client_env`:
    ``cpu`` sets ``MXNET_DEFAULT_CONTEXT=cpu``, the default device of a
    ``dev_type`` other than 1 and 2 and of ``MXTrainNative*``; otherwise
    the client runs on the card). No Python path: the client's process
    loads no Python."""
    return _cbuild.client_env(env, cpu)
