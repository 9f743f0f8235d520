"""RecordIO files of the port (counterpart of ``mxnet_tpu/recordio.py``;
reference: python/mxnet/recordio.py — MXRecordIO :19, MXIndexedRecordIO
:153, IRHeader, pack/unpack/pack_img :400; binary layout from dmlc-core
recordio: [kMagic uint32][lrecord uint32][data][pad to 4B]).

A file either package writes is byte for byte the other's (same magic
0xced7230a, continuation encoding, padding and ``.idx`` text), so
datasets packed by the reference's im2rec load here unchanged.
``RecReader`` reads a byte-range shard on the native host stage's
background thread (:mod:`._native`, ``csrc/native/recordio.cc``).
Images encode and decode through cv2 when it imports, else PIL.
"""
from __future__ import annotations

import ctypes
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "RecReader", "IRHeader", "pack", "unpack", "unpack_img", "pack_img"]

_kMagic = 0xCED7230A


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return (lrec >> 29) & 7, lrec & ((1 << 29) - 1)


# thread-confined: a record file object belongs to a single thread —
# concurrent use of one reader is unsupported (reference semantics), and
# io_image opens a private reader per pipeline stage
class MXRecordIO:
    """Sequential .rec reader/writer (reference: recordio.py:19).

    Corrupt-stream handling (docs/fault_tolerance.md): by default a bad
    magic word or a truncated payload raises — strict, the reference's
    behavior. With ``MXNET_IO_MAX_BAD_RECORDS=N`` the reader instead
    quarantines up to N corrupt records per file: it scans forward to the
    next magic-aligned record boundary, counts the loss in the always-on
    ``io.bad_records{source=stream}`` telemetry counter, and keeps
    serving; past the budget it fails fast.
    """

    def __init__(self, uri, flag):
        from .base import env_int

        self.uri = uri
        self.flag = flag
        self.fid = None
        # unset behaves as 0 here (strict — the legacy stream behavior);
        # ImageRecordIter's decode layer maps unset to unlimited instead
        # (its legacy behavior): see docs/env_var.md
        self._max_bad = env_int("MXNET_IO_MAX_BAD_RECORDS", 0) or 0
        self._bad = 0
        self.open()

    def open(self):
        self._bad = 0  # the quarantine budget is per pass over the file
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self.fid is not None:
            self.fid.close()
            self.fid = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["fid"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fid.tell()

    def write(self, buf):
        assert self.writable
        # split into ≤2^29-1 chunks with continuation flags like dmlc recordio
        max_len = (1 << 29) - 1
        n = len(buf)
        if n <= max_len:
            self.fid.write(struct.pack("<II", _kMagic, _encode_lrec(0, n)))
            self.fid.write(buf)
            pad = (4 - n % 4) % 4
            self.fid.write(b"\x00" * pad)
            return
        off = 0
        nchunk = (n + max_len - 1) // max_len
        for i in range(nchunk):
            chunk = buf[off : off + max_len]
            cflag = 1 if i == 0 else (2 if i == nchunk - 1 else 3)
            self.fid.write(struct.pack("<II", _kMagic, _encode_lrec(cflag, len(chunk))))
            self.fid.write(chunk)
            pad = (4 - len(chunk) % 4) % 4
            self.fid.write(b"\x00" * pad)
            off += len(chunk)

    def _bad_record(self, why):
        """Count one corrupt record against the budget and try to resync,
        or raise when strict / budget exhausted. Returns True when the
        stream is positioned at a plausible next record."""
        self._bad += 1
        from . import telemetry

        telemetry.counter("io.bad_records", source="stream").inc()
        if self._bad > self._max_bad:
            raise MXNetError(
                "Corrupt record in %s (%s): %d bad record(s) exceed "
                "MXNET_IO_MAX_BAD_RECORDS=%d"
                % (self.uri, why, self._bad, self._max_bad))
        import logging

        logging.warning("MXRecordIO: skipping corrupt record in %s (%s); "
                        "%d quarantined so far", self.uri, why, self._bad)
        return self._resync()

    def _resync(self):
        """Scan forward (4-byte aligned, the writer's padding grid) for the
        next magic word and position the stream on it. False at EOF."""
        magic_bytes = struct.pack("<I", _kMagic)
        pos = self.fid.tell()
        pos += (4 - pos % 4) % 4
        self.fid.seek(pos)
        window = b""
        while True:
            chunk = self.fid.read(1 << 16)
            if not chunk:
                return False
            window += chunk
            for off in range(0, len(window) - 3, 4):
                if window[off:off + 4] == magic_bytes:
                    self.fid.seek(pos + off)
                    return True
            keep = len(window) % 4 + 4
            pos += len(window) - keep
            window = window[-keep:]

    def read(self):
        assert not self.writable
        parts = []
        while True:
            header = self.fid.read(8)
            if len(header) < 8:
                return None if not parts else b"".join(parts)
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                if not self._bad_record("invalid magic"):
                    return None  # resync hit EOF
                parts = []  # drop any half-assembled multi-chunk record
                continue
            cflag, length = _decode_lrec(lrec)
            data = self.fid.read(length)
            if len(data) < length:
                # truncated payload: strict mode raises (silently returning
                # the short record was never loadable downstream anyway)
                if not self._bad_record(
                        "truncated payload: %d of %d bytes"
                        % (len(data), length)):
                    return None
                parts = []
                continue
            pad = (4 - length % 4) % 4
            if pad:
                self.fid.read(pad)
            parts.append(data)
            if cflag in (0, 2):
                return b"".join(parts)


# thread-confined: same single-owner contract as MXRecordIO
class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via .idx file (reference: recordio.py:153)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        # random access must stay strict regardless of the quarantine
        # budget: a resync past a corrupt record would silently return the
        # NEXT physical record's bytes as if they were the requested index
        # (and serve that record twice). Only sequential streams can skip.
        self._max_bad = 0
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.fid is None:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self.fid.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


class RecReader:
    """Native threaded sharded .rec reader (``csrc/native/recordio.cc``
    via ctypes).

    The analog of the reference's dmlc::InputSplit + background parser thread
    (src/io/iter_image_recordio_2.cc:67): owns a byte-range shard
    [part_index/num_parts) of the file, scans to the first magic-aligned
    record, and produces records from a background thread into a bounded
    queue. Iterate to get bytes objects. Without ``g++`` (the native
    stage cannot be built) it reads through MXRecordIO and takes every
    ``num_parts``-th record, as the JAX package's fallback does.
    """

    def __init__(self, uri, part_index=0, num_parts=1, queue_size=64):
        from . import _native

        self.uri = uri
        self._handle = None
        self._fallback = None
        self._fallback_i = 0
        self.part_index = part_index
        self.num_parts = num_parts
        try:
            self._lib = _native.load()
        except MXNetError:
            self._lib = None
        if self._lib is not None:
            self._handle = self._lib.mxt_rec_reader_open(
                uri.encode(), part_index, num_parts, queue_size)
        if self._handle is None:
            self._fallback = MXRecordIO(uri, "r")

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is not None:
            data = ctypes.POINTER(ctypes.c_char)()
            length = ctypes.c_size_t()
            if not self._lib.mxt_rec_reader_next(
                    self._handle, ctypes.byref(data), ctypes.byref(length)):
                raise StopIteration
            buf = ctypes.string_at(data, length.value)
            self._lib.mxt_rec_free(data, length)
            return buf
        # python fallback: round-robin record sharding
        while True:
            s = self._fallback.read()
            if s is None:
                raise StopIteration
            i = self._fallback_i
            self._fallback_i += 1
            if self.num_parts <= 1 or i % self.num_parts == self.part_index:
                return s

    next = __next__

    def close(self):
        if self._handle is not None:
            self._lib.mxt_rec_reader_close(self._handle)
            self._handle = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None

    def __del__(self):
        self.close()


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack header+payload into a record string (reference: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id, header.id2)
        packed += label.tobytes()
    return packed + s


def unpack(s):
    """(reference: recordio.py unpack)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4 :]
    return header, s


def unpack_img(s, iscolor=-1):
    """(reference: recordio.py unpack_img). Uses cv2 if available, else PIL/raw."""
    header, s = unpack(s)
    img = _imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """(reference: recordio.py:400 pack_img)"""
    encoded = _imencode(img, quality, img_fmt)
    return pack(header, encoded)


def _imdecode(buf, iscolor=-1):
    try:
        import cv2

        return cv2.imdecode(buf, iscolor)
    except ImportError:
        pass
    from io import BytesIO

    from PIL import Image

    img = np.array(Image.open(BytesIO(buf.tobytes())))
    if img.ndim == 3:
        img = img[:, :, ::-1]  # RGB->BGR to match cv2 convention
    return img


def _imencode(img, quality=95, img_fmt=".jpg"):
    try:
        import cv2

        ret, buf = cv2.imencode(img_fmt, img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ret, "failed to encode image"
        return buf.tobytes()
    except ImportError:
        pass
    from io import BytesIO

    from PIL import Image

    arr = img[:, :, ::-1] if img.ndim == 3 else img
    bio = BytesIO()
    fmt = "JPEG" if "jpg" in img_fmt or "jpeg" in img_fmt else "PNG"
    Image.fromarray(arr).save(bio, format=fmt, quality=quality)
    return bio.getvalue()
