"""NDArray of the port (counterpart of ``mxnet_tpu/ndarray.py``).

An :class:`NDArray` holds one ``torch.Tensor`` on one device (a
:mod:`~.context` ``torch.device``). This slice carries what binding and
training touch: shape, dtype, context, ``asnumpy``, full-slice
assignment, basic slicing, ``copyto``/``as_in_context`` and the
constructors, and ``save``/``load`` of ``.params`` files in the
reference's binary format with the JAX package's CRC footer, byte for byte.
The imperative op namespace (``nd.dot``, ``nd.exp``, ...) waits for a later
slice (``ROADMAP.md`` A4).

Writes replace or update the held tensor: an executor, an optimizer and
a module that share one NDArray object all see the newest value.
"""
from __future__ import annotations

import builtins
import math
import struct

import numpy as np
import torch

from . import context as _context
from .base import MXNetError, torch_dtype

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "save", "load"]


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
