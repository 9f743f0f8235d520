"""Build, load and bind the port's native host stage (counterpart of
``mxnet_tpu/_native.py``).

The stage is the port's own copy of the JAX package's host runtime
sources (``csrc/native/``: the sharded RecordIO reader ``recordio.cc``,
the pooled host allocator ``allocator.cc``, and the
decode -> augment -> batch pipeline ``decode.cc``, ``augment.cc``,
``pipe.cc``). :func:`load` compiles them with ``g++`` at first use into
one library in ``build/mxnet_tpu_torch/``, named by a digest of the
sources and the flags, and binds it with ``ctypes``.

The JPEG decoder is chosen by the toolchain, as the JAX package's
Makefile probes it: libjpeg when ``jpeglib.h`` compiles and ``-ljpeg``
links (the decode is then bitwise the JAX package's), else the CUDA
toolkit's nvJPEG when ``nvjpeg.h`` and ``-lnvjpeg`` are there (the
decode runs on the card), else none (``decoder()`` is ``"none"`` and
the pipeline cannot be created). Without ``g++`` :func:`load` raises.

Several processes may build at once (test workers): the build runs
under an exclusive file lock, into a temporary name that is renamed into
place, so a process loads either nothing or a whole library.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["load", "decoder", "MXTPipeConfig", "SRC_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc", "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")
SOURCES = ("allocator.cc", "recordio.cc", "decode.cc", "augment.cc", "pipe.cc")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None


def _links(flags):
    """Whether a program including the given headers and libraries builds."""
    cmd = ["g++", "-x", "c++", "-", "-o", os.devnull] + list(flags)
    try:
        res = subprocess.run(cmd, input=b"int main(){return 0;}",
                             capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return res.returncode == 0


def _decoder_flags():
    """(name, compile flags, link flags) of the JPEG backend this
    toolchain has: libjpeg, nvJPEG or none."""
    if _links(["-include", "stdio.h", "-include", "jpeglib.h", "-ljpeg"]):
        return "libjpeg", ["-DMXT_HAS_LIBJPEG"], ["-ljpeg"]
    inc = os.path.join(CUDA_HOME, "include")
    lib = os.path.join(CUDA_HOME, "lib64")
    link = ["-L" + lib, "-Wl,-rpath," + lib, "-lnvjpeg", "-lcudart"]
    if _links(["-I" + inc, "-include", "cuda_runtime.h", "-include",
               "nvjpeg.h"] + link):
        return "nvjpeg", ["-DMXT_HAS_NVJPEG", "-I" + inc], link
    return "none", [], []


def _library_path(flags):
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(SRC_DIR, "*.cc"))
                       + glob.glob(os.path.join(SRC_DIR, "include", "*.h"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, "libmxt_native-%s.so" % h.hexdigest()[:16])


def _build():
    """Compile the library unless it exists; returns its path."""
    if shutil.which("g++") is None:
        raise MXNetError("g++ not found: the port's native host stage is "
                         "built from source at first use")
    name, cflags, lflags = _decoder_flags()
    flags = list(CXXFLAGS) + cflags
    path = _library_path(flags + lflags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):      # another process built it
                return path
            tmp = "%s.%d.tmp" % (path, os.getpid())
            cmd = (["g++"] + flags + ["-o", tmp]
                   + [os.path.join(SRC_DIR, s) for s in SOURCES] + lflags)
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise MXNetError("building the native host stage (%s decoder) "
                                 "failed:\n%s" % (name, res.stderr[-4000:]))
            os.replace(tmp, path)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return path


def _declare(lib):
    c = ctypes
    lib.mxt_alloc.restype = c.c_void_p
    lib.mxt_alloc.argtypes = [c.c_size_t]
    lib.mxt_free.argtypes = [c.c_void_p, c.c_size_t]
    lib.mxt_free.restype = None
    lib.mxt_rec_reader_open.restype = c.c_void_p
    lib.mxt_rec_reader_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.mxt_rec_reader_next.restype = c.c_int
    lib.mxt_rec_reader_next.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.c_char)), c.POINTER(c.c_size_t)]
    lib.mxt_rec_free.argtypes = [c.POINTER(c.c_char), c.c_size_t]
    lib.mxt_rec_free.restype = None
    lib.mxt_rec_reader_close.argtypes = [c.c_void_p]
    lib.mxt_rec_reader_close.restype = None
    lib.mxt_pipe_create.restype = c.c_void_p
    lib.mxt_pipe_create.argtypes = [c.POINTER(MXTPipeConfig)]
    lib.mxt_pipe_next.restype = c.c_int
    lib.mxt_pipe_next.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.POINTER(c.c_float),
        c.POINTER(c.c_int)]
    lib.mxt_pipe_pop.restype = c.c_int
    lib.mxt_pipe_pop.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.POINTER(c.c_float)), c.POINTER(c.c_int)]
    lib.mxt_pipe_release.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.POINTER(c.c_float)]
    lib.mxt_pipe_release.restype = None
    lib.mxt_pipe_error.restype = c.c_char_p
    lib.mxt_pipe_error.argtypes = [c.c_void_p]
    lib.mxt_pipe_stats.argtypes = [c.c_void_p, c.POINTER(c.c_double), c.c_int]
    lib.mxt_pipe_stats.restype = None
    lib.mxt_pipe_close.argtypes = [c.c_void_p]
    lib.mxt_pipe_close.restype = None
    lib.mxt_pipe_decode_available.restype = c.c_int
    lib.mxt_pipe_decode_available.argtypes = []
    lib.mxt_decoder_name.restype = c.c_char_p
    lib.mxt_decoder_name.argtypes = []
    lib.mxt_decode_jpeg.restype = c.c_int
    lib.mxt_decode_jpeg.argtypes = [
        c.c_char_p, c.c_size_t, c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.mxt_resize_bilinear.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int, c.POINTER(c.c_uint8),
        c.c_int, c.c_int]
    lib.mxt_resize_bilinear.restype = None
    return lib


def load():
    """The bound native library, built at first use. Raises
    :class:`MXNetError` when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(_build()))
        return _lib


def decoder():
    """The JPEG backend compiled into the library: ``"libjpeg"``,
    ``"nvjpeg"`` or ``"none"``."""
    return load().mxt_decoder_name().decode()


class MXTPipeConfig(ctypes.Structure):
    """Mirror of ``csrc/native/include/pipe_api.h`` ``MXTPipeConfig`` (the
    native decode -> augment -> batch stage's construction parameters)."""

    _fields_ = [
        ("path", ctypes.c_char_p),
        ("part_index", ctypes.c_int),
        ("num_parts", ctypes.c_int),
        ("num_threads", ctypes.c_int),
        ("batch_size", ctypes.c_int),
        ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int),
        ("out_c", ctypes.c_int),
        ("label_width", ctypes.c_int),
        ("seed", ctypes.c_longlong),
        ("epoch", ctypes.c_longlong),
        ("resize", ctypes.c_int),
        ("crop", ctypes.c_int),
        ("mirror_prob", ctypes.c_double),
        ("max_bad", ctypes.c_longlong),
        ("prefetch", ctypes.c_int),
    ]
