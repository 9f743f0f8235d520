"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library (the three wide flash kernels share
``flash_wide.cu``, so one library) with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries go to ``build/mxnet_tpu_torch/`` beside the package, named by a
digest of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source is rebuilt and an unchanged one is reused. Everything is built from the repository's own
sources at first use; :func:`build` starts one ``nvcc`` per missing
library, all at once.

Every C entry point returns the ``cudaGetLastError()`` of its launch; a
:class:`Kernel` raises :class:`MXNetError` when it is not 0, and counts
its successful launches in ``Kernel.launches``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["Kernel", "KERNELS", "FLASH_FWD", "FLASH_BWD_DKV", "FLASH_BWD_DQ",
           "FLASH_WIDE_FWD", "FLASH_WIDE_BWD_DKV", "FLASH_WIDE_BWD_DQ",
           "PAGED_DECODE", "PAGED_DECODE_MULTI", "build", "nvcc_command",
           "BUILD_DIR", "CSRC"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise MXNetError("nvcc not found: the port's CUDA kernels are built from "
                     "source with the CUDA toolkit at first use")


def nvcc_command(source, output, nvcc="nvcc"):
    """The ``nvcc`` command line that builds ``source`` into ``output``."""
    return [nvcc, *NVCC_FLAGS, "-o", output, source]


class Kernel:
    """One hand-written kernel: its source (``csrc/<source>.cu``, by
    default ``<name>.cu``), its C entry point, its argument types and the
    count of its launches."""

    def __init__(self, name, argtypes, source=None):
        self.name = name
        self.source = os.path.join(CSRC, (source or name) + ".cu")
        self.symbol = "mxt_" + name
        self.argtypes = list(argtypes)
        #: successful launches since the last reset (set it to 0 to reset)
        self.launches = 0
        #: ptxas report (registers, shared memory, spills) of the last build
        self.build_log = ""
        self._fn = None
        self._err = None

    def library(self):
        """Path of this kernel's shared library for the current source."""
        h = hashlib.sha1()
        for path in [self.source] + sorted(glob.glob(os.path.join(CSRC,
                                                                  "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, "%s-%s.so" % (stem,
                                                     h.hexdigest()[:16]))

    def _load(self):
        if self._fn is None:
            path = self.library()
            if not os.path.exists(path):
                build([self])
            lib = ctypes.CDLL(path)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, self.symbol + "_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args):
        """Launch the kernel (on the stream passed as the last argument)
        and count it; raises when the launch was refused."""
        code = self._load()(*args)
        if code != 0:
            raise MXNetError("CUDA kernel %s failed to launch: %s (error %d)"
                             % (self.name, self._err(code).decode(), code))
        self.launches += 1


FLASH_FWD = Kernel("flash_fwd", [
    _P, _P, _P, _P, _P,          # q, k, v, out, lse
    _I, _I, _I, _I, _I,          # b, h, sq, sk, d
    _F, _I, _I,                  # sm_scale, causal, dtype
    _P,                          # stream
])

FLASH_BWD_DKV = Kernel("flash_bwd_dkv", [
    _P, _P, _P, _P, _P, _P,      # q, k, v, dout, lse, delta
    _P, _P,                      # dk, dv
    _I, _I, _I, _I, _I,          # b, h, sq, sk, d
    _F, _I, _I,                  # sm_scale, causal, dtype
    _P,                          # stream
])

FLASH_BWD_DQ = Kernel("flash_bwd_dq", [
    _P, _P, _P, _P, _P, _P,      # q, k, v, dout, lse, delta
    _P,                          # dq
    _I, _I, _I, _I, _I,          # b, h, sq, sk, d
    _F, _I, _I,                  # sm_scale, causal, dtype
    _P,                          # stream
])

# the D > 256 route of the three flash kernels (csrc/flash_wide.cu), with
# their argument lists
FLASH_WIDE_FWD = Kernel("flash_wide_fwd", FLASH_FWD.argtypes, "flash_wide")
FLASH_WIDE_BWD_DKV = Kernel("flash_wide_bwd_dkv", FLASH_BWD_DKV.argtypes,
                            "flash_wide")
FLASH_WIDE_BWD_DQ = Kernel("flash_wide_bwd_dq", FLASH_BWD_DQ.argtypes,
                           "flash_wide")

PAGED_DECODE = Kernel("paged_decode", [
    _P, _P, _P, _P, _P, _P,      # q, k_pages, v_pages, tables, lens, out
    _I, _I, _I, _I, _I, _I,      # b, h, d, num_blocks, block_size, nb
    _F, _I,                      # sm_scale, page dtype (q, out float32)
    _P,                          # stream
])

PAGED_DECODE_MULTI = Kernel("paged_decode_multi", [
    _P, _P, _P, _P, _P, _P,      # q, k_pages, v_pages, tables, lens, out
    _I, _I, _I, _I, _I, _I, _I,  # b, t, h, d, num_blocks, block_size, nb
    _F, _I,                      # sm_scale, page dtype (q, out float32)
    _P,                          # stream
])

KERNELS = {k.name: k for k in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ,
                                FLASH_WIDE_FWD, FLASH_WIDE_BWD_DKV,
                                FLASH_WIDE_BWD_DQ, PAGED_DECODE,
                                PAGED_DECODE_MULTI)}


def build(kernels=None):
    """Build the shared library of every kernel in ``kernels`` (default:
    all) that is missing, one ``nvcc`` per source, all started together
    (kernels that share a source share its one build).
    Raises :class:`MXNetError` with the compiler's output on failure."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    with _lock:
        todo = {}
        for k in kernels:
            if not os.path.exists(k.library()):
                todo.setdefault(k.library(), []).append(k)
        if not todo:
            return
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for out, ks in todo.items():
            tmp = "%s.tmp%d" % (out, os.getpid())
            procs.append((ks, out, tmp, subprocess.Popen(
                nvcc_command(ks[0].source, tmp, nvcc), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for ks, out, tmp, proc in procs:
            log, _ = proc.communicate()
            for k in ks:
                k.build_log = log
            if proc.returncode != 0:
                failed.append("%s (exit %d):\n%s" % (ks[0].source,
                                                     proc.returncode, log))
                continue
            os.replace(tmp, out)
        if failed:
            raise MXNetError("nvcc failed for " + "\n".join(failed))
