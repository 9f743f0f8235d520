"""Runtime-compiled custom kernels (counterpart of ``mxnet_tpu/rtc.py``;
reference: python/mxnet/rtc.py Rtc:7, src/common/mxrtc.cc, C API
MXRtcCreate/MXRtcPush).

The reference compiles CUDA C source at runtime with NVRTC and launches
it on NDArrays. The JAX package compiles a *kernel source string* with
jax instead: the body is Python text over ``jnp``/``lax``, compiled at
the first push. The port keeps that contract: the body is Python text
executed with the named input tensors in scope, with ``torch`` where the
JAX package offers ``jnp``, ``lax`` and ``jax`` (so an arithmetic body
such as ``"y = x * 2 + 1"`` is the same text in both packages), and
``pl``/``pltpu`` None, as in the JAX package without Pallas. No CUDA
source is compiled (``ROADMAP.md`` C19).

Example::

    x = mx.nd.ones((10,))
    y = mx.nd.zeros((10,))
    rtc = mx.rtc.Rtc("mykernel", [("x", x)], [("y", y)], "y = x * 2 + 1")
    rtc.push([x], [y], grid_dims=None, block_dims=None)

The kernel body assigns each output name from the input names; it runs
on the device its inputs lie on. ``grid_dims``/``block_dims`` are
accepted for API compatibility and ignored, as in the JAX package. The
first push at each input signature is a ``compileobs`` compile of
program ``rtc.<name>``; later ones are its runs.
"""
from __future__ import annotations

import time

from .base import MXNetError

__all__ = ["Rtc"]


class Rtc:
    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self._input_names = [i[0] for i in inputs]
        self._output_names = [o[0] for o in outputs]
        if not self._output_names:
            raise MXNetError("Rtc kernel needs at least one output")
        self._source = kernel
        self._compiled = None
        self._program = None

    def _compile(self):
        import torch

        from . import compileobs

        src = "\n".join("    " + line for line in self._source.splitlines())
        fn_src = "def __kernel__(%s):\n%s\n    return (%s)" % (
            ", ".join(self._input_names), src or "    pass",
            ", ".join(self._output_names) + ("," if len(self._output_names) == 1 else ""),
        )
        scope = {"torch": torch, "jnp": torch, "lax": torch, "jax": torch,
                 "pl": None, "pltpu": None}
        try:
            exec(compile(fn_src, "<mx.rtc:%s>" % self.name, "exec"), scope)
        except SyntaxError as e:
            raise MXNetError("Rtc kernel '%s' failed to compile: %s" % (self.name, e)) from e
        self._compiled = scope["__kernel__"]
        self._program = compileobs.Program(
            "rtc.%s" % self.name, site="mxnet_tpu_torch/rtc.py:Rtc._compile",
            graph_key=self._source, digest=self._source)

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Run the kernel (reference: rtc.py push -> MXRtcPush). grid/block
        dims are part of the reference signature and ignored here."""
        from . import compileobs
        from . import ndarray as nd

        if len(inputs) != len(self._input_names) or len(outputs) != len(self._output_names):
            raise MXNetError(
                "Rtc kernel '%s' expects %d inputs / %d outputs, got %d / %d"
                % (self.name, len(self._input_names), len(self._output_names),
                   len(inputs), len(outputs)))
        if self._compiled is None:
            self._compile()
        args = [a.data if isinstance(a, nd.NDArray) else a for a in inputs]
        t0 = time.perf_counter()
        wall0 = time.time()
        try:
            outs = self._compiled(*args)
        except Exception as e:  # surface body errors with the kernel name
            raise MXNetError("Rtc kernel '%s' failed: %s" % (self.name, e)) from e
        for name, dst, val in zip(self._output_names, outputs, outs):
            if tuple(val.shape) != tuple(dst.shape):
                raise MXNetError(
                    "Rtc kernel '%s' output '%s' computed shape %s but the "
                    "bound array is %s" % (self.name, name, tuple(val.shape),
                                           tuple(dst.shape)))
            dst._set_data(val.to(device=dst.data.device, dtype=dst.data.dtype))
        self._program.charge(
            compileobs.signature(zip(self._input_names, args)),
            time.perf_counter() - t0, wall0)
        return outputs
