"""NDArray of the port (counterpart of ``mxnet_tpu/ndarray.py``).

An :class:`NDArray` holds one ``torch.Tensor`` on one device (a
:mod:`~.context` ``torch.device``): shape, dtype, context, ``asnumpy``,
full-slice assignment, basic slicing, ``copyto``/``as_in_context``/
``copy``, ``astype``/``reshape``/``broadcast_to``/``T``, the constructors,
and ``save``/``load`` of ``.params`` files in the reference's binary
format with the JAX package's CRC footer, byte for byte.
Every registered op is also an imperative function here
(``nd.take``, ``nd.softmax``, ``nd.contrib.PagedAttention``, ...), made
on first use: its inputs are NDArrays (positional, or by keyword for the
trailing inputs), its attrs keywords; it runs the op's forward once
without autograd on the inputs' device (an op without inputs on
``ctx=``, the card by default; the sampling ops of :mod:`.ops.sample`
draw from that device's :mod:`.random` generator), and an op's updated
aux states are written back into the aux NDArrays passed in (as the JAX
package does), and an op that mutates its inputs (the ``*_update``
optimizer ops) writes them in place. The Python operators dispatch as
the JAX package's do: an NDArray operand takes the ``broadcast_*`` op, a
number the ``*_scalar`` op (``+ - * / % **``, the comparisons, which
give 0/1 in the input's dtype, and ``==``/``!=`` against ``None``, which
give False/True); an NDArray hashes by identity, so it can key a dict.
The module functions ``add`` ... ``lesser_equal`` take a number on
either side. Inside a ``contrib.autograd`` ``train_section`` the ops run
in training mode and torch autograd records them on the marked
variables (:func:`imperative_invoke`).

Writes replace or update the held tensor: an executor, an optimizer and
a module that share one NDArray object all see the newest value.
"""
from __future__ import annotations

import builtins
import math
import struct
import sys

import numpy as np
import torch

from . import context as _context
from . import random as _random
from .base import MXNetError, torch_dtype
from .ops.registry import OpContext, get_op, has_op

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "onehot_encode", "add", "subtract",
           "multiply", "divide", "true_divide", "power", "maximum", "minimum",
           "equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "save", "load", "imperative_invoke"]


def _np_dtype(dtype):
    """The numpy name of a torch dtype (bfloat16 has none: its name)."""
    name = str(dtype).replace("torch.", "")
    return name if name == "bfloat16" else np.dtype(name)


class NDArray:
    """An n-dimensional array on a device context, over one torch tensor."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray holds a torch.Tensor, got %s" % type(data))
        self._data = data

    # ---- buffer access --------------------------------------------------
    @property
    def data(self):
        """The held ``torch.Tensor``."""
        return self._data

    def _set_data(self, value):
        self._data = value

    # ---- basic properties ----------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._data.device

    ctx = context

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)), self.context)

    def __len__(self):
        return self.shape[0]

    # ---- host ----------------------------------------------------------
    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    # ---- conversion / copy ----------------------------------------------
    def copyto(self, other):
        """Copy into another NDArray (keeping its device and dtype) or onto
        a device."""
        if isinstance(other, NDArray):
            other[:] = self
            return other
        if isinstance(other, torch.device):
            return NDArray(self._data.to(other, copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if torch.device(context) == self.context:
            return self
        return self.copyto(torch.device(context))

    # ---- indexing --------------------------------------------------------
    def __getitem__(self, key):
        """A basic slice or integer index: a view of the held tensor."""
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """``a[:] = v`` (or any index) writes ``v`` into the held tensor in
        place, cast to its dtype and moved to its device; a scalar fills."""
        if isinstance(value, NDArray):
            value = value.data
        if isinstance(value, torch.Tensor):
            src = value.detach().to(self._data.device, self._data.dtype)
        elif isinstance(value, (builtins.int, builtins.float, np.generic)):
            src = value
        else:
            arr = np.asarray(value)
            if self._data.dtype == torch.bfloat16:
                arr = arr.astype(np.float32)
            src = torch.as_tensor(arr).to(self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[key] = src


    # ---- views and conversions ------------------------------------------
    @property
    def T(self):
        return imperative_invoke("transpose", [self], {})

    def copy(self):
        return NDArray(self._data.detach().clone())

    def astype(self, dtype):
        return imperative_invoke("Cast", [self], {"dtype": np.dtype(dtype)})

    def reshape(self, shape, **kwargs):
        if isinstance(shape, builtins.int):
            shape = (shape,)
        return imperative_invoke("Reshape", [self], {"shape": tuple(shape)})

    def broadcast_to(self, shape):
        return imperative_invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    # ---- arithmetic (the JAX package's dispatch) --------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return imperative_invoke(op, [a, b], {})
        if isinstance(other, (builtins.int, builtins.float, np.generic)):
            return imperative_invoke(scalar_op, [self], {"scalar": builtins.float(other)})
        return NotImplemented

    def _rscalar(self, other, rscalar_op, op, scalar_op):
        if isinstance(other, (builtins.int, builtins.float, np.generic)):
            return imperative_invoke(rscalar_op, [self], {"scalar": builtins.float(other)})
        return self._binary(other, op, scalar_op, reverse=True)

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._rscalar(o, "_rminus_scalar", "broadcast_sub", "_minus_scalar")

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._rscalar(o, "_rdiv_scalar", "broadcast_div", "_div_scalar")

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return imperative_invoke("negative", [self], {})

    def __abs__(self):
        return imperative_invoke("abs", [self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace(self, result):
        """``a op= b``: the result written into the held tensor where its
        shape and dtype allow (so whoever holds the tensor sees it), else
        the array rebound to it."""
        if result is NotImplemented:
            return result
        r = result.data
        if r.shape == self._data.shape and r.dtype == self._data.dtype:
            with torch.no_grad():
                self._data.copy_(r)
        else:
            self._set_data(r)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")


# ---- creation -----------------------------------------------------------
def _device(ctx):
    return _context.resolve(ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from an array-like on ``ctx`` (default: the card).
    numpy arrays keep their dtype except float64, which narrows to
    float32 as in the JAX package; other array-likes become float32."""
    if isinstance(source_array, NDArray):
        src = source_array.asnumpy()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
        dev = _device(ctx)
        if dtype is not None:
            return NDArray(src.to(dev, torch_dtype(dtype), copy=True))
        return NDArray(src.to(dev, copy=True))
    else:
        src = source_array
    if dtype is None:
        if isinstance(src, np.ndarray):
            dtype = src.dtype if src.dtype != np.float64 else np.float32
        else:
            dtype = np.float32
    # torch.tensor copies: the array never shares the caller's memory
    return NDArray(torch.tensor(np.asarray(src, dtype=np.dtype(dtype)),
                                device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _full(shape, value, ctx, dtype):
    if isinstance(shape, int):
        shape = (shape,)
    dt = torch.float32 if dtype is None else torch_dtype(dtype)
    return NDArray(torch.full(tuple(shape), value, dtype=dt, device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _full(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype=None):
    return _full(shape, builtins.float(val), ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """The ``_arange`` op on ``ctx`` (default: the card)."""
    return imperative_invoke("_arange", [], {
        "start": builtins.float(start),
        "stop": None if stop is None else builtins.float(stop),
        "step": builtins.float(step), "repeat": builtins.int(repeat),
        "dtype": np.dtype(dtype) if dtype else None}, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return imperative_invoke("Concat", list(arrays),
                             {"num_args": len(arrays), "dim": axis})


def moveaxis(tensor, source, destination):
    """``tensor`` with axis ``source`` moved to ``destination`` (numpy's
    rule: a negative axis counts from the end, one out of range raises)."""
    nd_ = tensor.ndim

    def _norm(ax, what):
        if not -nd_ <= ax < nd_:
            raise ValueError("%s %d out of bounds for %d-d array" % (what, ax, nd_))
        return ax + nd_ if ax < 0 else ax

    source = _norm(source, "source")
    destination = _norm(destination, "destination")
    axes = list(range(nd_))
    axes.pop(source)
    axes.insert(destination, source)
    return imperative_invoke("transpose", [tensor], {"axes": tuple(axes)})


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` (depth ``out.shape[1]``) into
    ``out``."""
    res = imperative_invoke("one_hot", [indices], {"depth": out.shape[1]})
    out._set_data(res.data.to(out.data.dtype))
    return out


# ---- module-level binary functions: an NDArray or a number on each side --
def _module_binary(lhs, rhs, op, scalar_op, rscalar_op=None):
    if isinstance(lhs, NDArray):
        if isinstance(rhs, NDArray):
            return imperative_invoke(op, [lhs, rhs], {})
        return imperative_invoke(scalar_op, [lhs], {"scalar": builtins.float(rhs)})
    if isinstance(rhs, NDArray):
        # a commutative op takes the scalar op itself
        return imperative_invoke(rscalar_op or scalar_op, [rhs],
                                 {"scalar": builtins.float(lhs)})
    raise TypeError("at least one operand must be an NDArray")


def add(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_add", "_plus_scalar")


def subtract(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_sub", "_minus_scalar", "_rminus_scalar")


def multiply(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_mul", "_mul_scalar")


def divide(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_div", "_div_scalar", "_rdiv_scalar")


true_divide = divide


def power(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_power", "_power_scalar", "_rpower_scalar")


def maximum(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_maximum", "_maximum_scalar")


def minimum(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_minimum", "_minimum_scalar")


def equal(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_equal", "_equal_scalar")


def not_equal(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_not_equal", "_not_equal_scalar")


def greater(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_greater", "_greater_scalar",
                          "_lesser_scalar")


def greater_equal(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_greater_equal",
                          "_greater_equal_scalar", "_lesser_equal_scalar")


def lesser(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_lesser", "_lesser_scalar",
                          "_greater_scalar")


def lesser_equal(lhs, rhs):
    return _module_binary(lhs, rhs, "broadcast_lesser_equal",
                          "_lesser_equal_scalar", "_greater_equal_scalar")



# ---- serialization (reference: src/ndarray/ndarray.cc:618-717) -----------
_NDARRAY_MAGIC = 0xF993FAC8  # NDArray V1 magic, ndarray.cc:618
_LIST_MAGIC = 0x112  # dict-of-arrays magic, ndarray.cc:695

#: the reference's type flags (mshadow) for the dtypes it can store; the
#: JAX package's flags 7-10 (bfloat16, bool, uint32, uint64) are TPU-build
#: extensions that neither package writes (bfloat16 is widened to float32
#: on save), so the port reads them as unknown
_DTYPE_NP_TO_MX = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                   np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
                   np.dtype(np.int32): 4, np.dtype(np.int8): 5,
                   np.dtype(np.int64): 6}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}


def _write_ndarray(f, arr):
    # byte-for-byte the reference's NDArray::Save (ndarray.cc:620-643):
    # u32 magic | TShape [u32 ndim, u32 dims...] | Context [i32 dev_type,
    # i32 dev_id] | i32 type_flag | raw contiguous data
    shape = arr.shape
    if len(shape) == 0:
        # the reference cannot represent 0-dim arrays (an ndim-0 record
        # means is_none and carries no data)
        raise MXNetError("cannot save a 0-dim NDArray in the reference "
                         ".params format; reshape to (1,) first")
    np_arr = arr.asnumpy()   # bfloat16 arrives widened to float32
    flag = _DTYPE_NP_TO_MX.get(np.dtype(np_arr.dtype))
    if flag is None:
        raise MXNetError("cannot save dtype %s: not a reference NDArray dtype"
                         % np_arr.dtype)
    f.write(struct.pack("<I", _NDARRAY_MAGIC))
    f.write(struct.pack("<I", len(shape)))
    for n in shape:
        f.write(struct.pack("<I", n))
    f.write(struct.pack("<ii", 1, 0))  # saved as cpu ctx, like the reference
    f.write(struct.pack("<i", flag))
    f.write(np.ascontiguousarray(np_arr).tobytes())


def _read_ndarray(f):
    (magic,) = struct.unpack("<I", f.read(4))
    if magic != _NDARRAY_MAGIC:
        # legacy pre-V1 files: the "magic" is ndim (LegacyTShapeLoad,
        # ndarray.cc:645-660); the implausible-ndim guard rejects corrupt ones
        ndim = magic
    else:
        (ndim,) = struct.unpack("<I", f.read(4))
    if ndim > 64:  # a corrupt header must not drive EOF-long reads
        raise MXNetError("Invalid NDArray file format (implausible ndim %d)"
                         % ndim)
    shape = tuple(struct.unpack("<I", f.read(4))[0] for _ in range(ndim))
    if ndim == 0:
        return array(np.zeros(0, np.float32), ctx=_context.cpu())
    n_elem = math.prod(shape)
    if any(n > 2**31 for n in shape) or n_elem > 2**40:
        raise MXNetError("Invalid NDArray file format (implausible shape %s)"
                         % (shape,))
    f.read(8)  # context: arrays load onto the host, as the reference's do
    (flag,) = struct.unpack("<i", f.read(4))
    if flag not in _DTYPE_MX_TO_NP:
        raise MXNetError("Invalid NDArray file format (unknown type flag %d)"
                         % flag)
    dt = _DTYPE_MX_TO_NP[flag]
    data = np.frombuffer(f.read(n_elem * dt.itemsize), dtype=dt).reshape(shape)
    return array(data, ctx=_context.cpu(), dtype=dt)


def save(fname, data):
    """Save an NDArray, a list of them or a str->NDArray dict in the
    reference's binary format (src/ndarray/ndarray.cc:695-717): u64 0x112
    magic, u64 reserved, [u64 count, NDArray blobs], [u64 count, names].
    The write is crash-safe (temp + fsync + rename) and ends with the JAX
    package's CRC32 footer, which the reference's loader never reads — the
    file is byte-identical to the JAX package's for the same arrays."""
    from .utils.atomic_file import atomic_write

    if isinstance(data, NDArray):
        data = [data]
    names = []
    arrays = []
    if isinstance(data, dict):
        for k, v in data.items():
            names.append(k)
            arrays.append(v)
    else:
        arrays = list(data)
    with atomic_write(fname) as f:
        f.write(struct.pack("<Q", _LIST_MAGIC))
        f.write(struct.pack("<Q", 0))  # reserved
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            _write_ndarray(f, arr)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            nb = n.encode("utf-8")
            f.write(struct.pack("<Q", len(nb)))
            f.write(nb)


def load(fname):
    """Load arrays saved by :func:`save` (by either package, or by the
    reference) onto the host: a list, or a dict when the file names them.
    Accepts a path or a binary file-like object. Verifies the CRC32 footer
    when present; raises :class:`MXNetError` on a corrupt file."""
    from .utils.atomic_file import ChecksummingReader, PushbackReader

    def _load_verified(f):
        reader = ChecksummingReader(f)
        try:
            out = _load_stream(reader)
        except Exception:
            # when the CRC proves the file corrupt, report that (the root
            # cause) instead of the parser's downstream symptom
            reader.verify()
            raise
        reader.verify()
        return out

    if hasattr(fname, "read"):
        if getattr(fname, "seekable", lambda: False)():
            if fname.tell() != 0:
                # positioned at an embedded blob: no file-scoped footer
                return _load_stream(fname)
            return _load_verified(fname)
        # non-seekable: parse exactly the blob, no CRC verification
        return _load_stream(PushbackReader(fname))
    with open(fname, "rb") as f:
        return _load_verified(f)


def _load_stream(f):
    (magic,) = struct.unpack("<Q", f.read(8))
    if magic != _LIST_MAGIC:
        raise MXNetError("Invalid NDArray list file")
    f.read(8)  # reserved
    (n_arr,) = struct.unpack("<Q", f.read(8))
    # reject the JAX package's pre-release layout (n_names as a second u64
    # up front, then per-array magic) instead of misparsing it
    peek = f.read(12)
    if (len(peek) == 12
            and struct.unpack("<I", peek[8:12])[0] == _NDARRAY_MAGIC
            and struct.unpack("<Q", peek[:8])[0] <= n_arr):
        raise MXNetError(
            "this .params file uses a pre-release layout; re-save it with the "
            "current version (load with the old build, then save)")
    f.seek(-len(peek), 1)
    arrays = [_read_ndarray(f) for _ in range(n_arr)]
    (n_names,) = struct.unpack("<Q", f.read(8))
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", f.read(8))
        names.append(f.read(ln).decode("utf-8"))
    if n_names:
        return dict(zip(names, arrays))
    return arrays


# ---- the imperative op namespace ------------------------------------------
#: training mode of imperative calls: set by ``contrib.autograd``'s
#: ``train_section``/``set_is_training`` (thread-confined, as the JAX
#: package's: the imperative tape records on the user's training thread)
_TRAIN_MODE = [False]


def _refuse_marked(dst, what):
    """Raise when ``dst`` (a tensor) is a variable that
    ``contrib.autograd`` marked and a train section is recording: the
    graph recorded so far holds its old value, and a gradient over a value
    overwritten after its use is undefined."""
    if dst.requires_grad and _autograd_recording():
        raise MXNetError(
            "%s: cannot write into a variable marked for autograd inside a "
            "train_section (write into another array, or outside the "
            "section)" % what)


def _autograd_recording():
    from .contrib import autograd as _ag

    return _ag.is_recording()


def imperative_invoke(op_name, ndargs, attrs, out=None, ctx=None):
    """Run registered op ``op_name`` once on NDArrays ``ndargs`` (its
    arguments, then optionally its aux states) with ``attrs``: returns the
    visible output NDArray (a list when there are several). Updated aux
    states are written into the aux NDArrays given. An op runs on its
    inputs' device; one without inputs on ``ctx`` (default: the card). A
    stochastic op draws from that device's :mod:`.random` generator.

    Inside a ``contrib.autograd`` ``train_section`` the op runs in
    training mode (``Dropout`` draws its mask) and torch autograd records
    it on the variables that ``mark_variables`` marked; elsewhere it runs
    in inference mode without autograd. Writes are never recorded: aux
    states, the states of the ``*_update`` ops and ``out=`` receive
    detached values, so a later op reads them as constants, as the JAX
    package's replay does (a write into a marked variable raises)."""
    op = get_op(op_name)
    attrs, _extra = op.canonicalize_attrs(attrs)
    n_args = len(op.arg_names(attrs))
    n_aux = len(op.aux_names(attrs))
    if len(ndargs) not in (n_args, n_args + n_aux) or not all(
            isinstance(a, NDArray) for a in ndargs):
        raise MXNetError("op %s expects %d NDArray args (+%d aux), got %d"
                         % (op_name, n_args, n_aux, len(ndargs)))
    tensors = [a.data for a in ndargs]
    if len(ndargs) == n_args and n_aux:
        raise MXNetError("op %s needs its %d aux states passed in"
                         % (op_name, n_aux))
    device = tensors[0].device if tensors else _device(ctx)
    is_train = _TRAIN_MODE[0]
    recording = is_train and _autograd_recording()
    octx = OpContext(is_train=is_train, device=device,
                     rng=(_random.generator(device) if op.stochastic(attrs)
                          else None))
    with torch.enable_grad() if recording else torch.no_grad():
        outs, new_auxs = op.forward(octx, attrs, tensors[:n_args],
                                    tensors[n_args:])
    n_vis = builtins.max(op.num_visible_outputs(attrs), 1)
    # the reference's FMutateInputs: states written in place
    for pos, new in zip(op.mutate_inputs, outs[n_vis:]):
        _refuse_marked(ndargs[pos].data, op_name)
        with torch.no_grad():
            ndargs[pos].data.copy_(new)
    for nda, new in zip(ndargs[n_args:], new_auxs):
        nda._set_data(new.detach())
    # an output that is a view of an input (transpose, broadcast_to, a
    # slice) gets its own memory, as every JAX array has
    held = {t.untyped_storage().data_ptr() for t in tensors}
    results = [NDArray(o.clone() if o.untyped_storage().data_ptr() in held
                       else o) for o in outs[:n_vis]]
    if recording:
        from .contrib import autograd as _ag

        _ag.record_op(op_name, attrs, ndargs, results)
    if out is not None:
        outs_nd = [out] if isinstance(out, NDArray) else list(out)
        for dst, src in zip(outs_nd, results):
            _refuse_marked(dst.data, op_name)
            dst[:] = src
        return out
    return results[0] if len(results) == 1 else results


def _make_ndarray_function(op_name):
    op = get_op(op_name)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)
        nd_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
        attrs = {k: v for k, v in kwargs.items() if k not in nd_kwargs}
        ndargs = list(args)
        if nd_kwargs:
            cattrs, _ = op.canonicalize_attrs(attrs)
            names = op.arg_names(cattrs) + op.aux_names(cattrs)
            want = names[len(ndargs):len(ndargs) + len(nd_kwargs)]
            if sorted(nd_kwargs) != sorted(want):
                raise MXNetError(
                    "op %s: NDArray keyword(s) %s must fill exactly the "
                    "inputs after the %d positional one(s) (%s)"
                    % (op_name, sorted(nd_kwargs), len(ndargs), want))
            ndargs += [nd_kwargs[n] for n in want]
        if op.key_var_num_args and op.key_var_num_args not in attrs:
            attrs[op.key_var_num_args] = len(ndargs)
        return imperative_invoke(op_name, ndargs, attrs, out=out, ctx=ctx)

    fn.__name__ = op_name
    fn.__doc__ = "Imperative form of operator ``%s``." % op_name
    return fn


class _Contrib:
    """``nd.contrib.<name>``: the registered ``_contrib_<name>`` ops."""

    def __getattr__(self, name):
        if has_op("_contrib_" + name):
            return _make_ndarray_function("_contrib_" + name)
        raise AttributeError("no contrib op %r" % name)


contrib = _Contrib()


def __getattr__(name):
    # registered ops resolve on first use (the op modules register when
    # the symbol module is imported, after this one)
    if not name.startswith("__") and has_op(name):
        from . import op_doc

        fn = _make_ndarray_function(name)
        globals()[name] = fn
        op_doc.attach_docs(sys.modules[__name__], [name], "imperative")
        return fn
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
