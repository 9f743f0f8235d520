"""Crash-safe file writes with end-to-end checksums — the port's own copy
of what ``nd.save``/``nd.load``, ``Symbol.save`` and the checkpoint
functions use from ``mxnet_tpu/utils/atomic_file.py``.

Every checkpoint-shaped write goes through the classic crash-safe
protocol:

1. write to ``<path>.tmp.<pid>.<seq>`` in the same directory (same
   filesystem, so the rename below is atomic; the per-process counter keeps
   concurrent same-path writers on separate temp files),
2. append a 16-byte CRC32 footer over the payload,
3. ``fsync`` the file, ``os.replace`` onto the final path, ``fsync`` the
   directory (so the rename itself survives power loss).

Footer layout (little-endian), byte-identical to the JAX package's:
``b"MXCR"`` magic, u32 crc32 of the payload, u64 payload length. Files
without the footer (written by the reference, or before the footer
existed) verify as legacy and load unchanged.

The whole-buffer helpers ``verify_and_strip`` and ``read_verified`` read
``.states`` files; ``footer_crc`` is the ``.resume`` sidecar's binding
token.

Fault injection: writers take a ``fault_name`` consulted through
:mod:`mxnet_tpu_torch.fault` (default ``checkpoint_write``);
``crash_after_bytes=N`` aborts the stream after exactly N payload bytes
with an :class:`~mxnet_tpu_torch.fault.InjectedCrash`, leaving the torn
temp file behind, as a real crash would, and the final path untouched.
"""
from __future__ import annotations

import io
import itertools
import os
import struct
import zlib
from contextlib import contextmanager

from .. import fault
from ..base import MXNetError

__all__ = ["atomic_write", "ChecksumError", "ChecksummingReader",
           "PushbackReader", "FOOTER_LEN", "verify_and_strip", "footer_crc",
           "read_verified"]

_FOOTER_MAGIC = b"MXCR"
FOOTER_LEN = 16  # magic(4) + crc32(4) + payload_len(8)
_tmp_counter = itertools.count()


class ChecksumError(MXNetError):
    """Payload bytes do not match the file's CRC32 footer."""


# thread-confined: wraps one open temp file for the duration of a single
# atomic_write, owned end-to-end by the writing thread
class _ChecksummedWriter:
    """File-like wrapper keeping a running CRC32 of what it writes, with the
    byte budget of an armed ``crash_after_bytes`` fault."""

    def __init__(self, f, fault_name):
        self._f = f
        self._crc = 0
        self.nbytes = 0
        self._fault_name = fault_name
        self._budget = (None if fault_name is None
                        else fault.crash_after_bytes(fault_name))

    def write(self, data):
        if isinstance(data, str):
            data = data.encode("utf-8")
        if self._budget is not None and self.nbytes + len(data) > self._budget:
            allowed = self._budget - self.nbytes
            self._f.write(data[:allowed])
            self.nbytes += allowed
            fault.consume(self._fault_name)
            raise fault.InjectedCrash("injected crash at %s after %d bytes"
                                      % (self._fault_name, self.nbytes))
        self._f.write(data)
        self._crc = zlib.crc32(data, self._crc)
        self.nbytes += len(data)
        return len(data)

    def footer(self):
        return struct.pack("<4sIQ", _FOOTER_MAGIC, self._crc & 0xFFFFFFFF,
                           self.nbytes)


@contextmanager
def atomic_write(path, checksum=True, fault_name="checkpoint_write"):
    """Yield a writer whose output reaches ``path`` atomically.

    On clean exit the CRC footer (when ``checksum``) is appended, the file is
    fsynced and renamed over ``path``, and the directory entry is fsynced.
    On an ordinary exception the temp file is removed and ``path`` is left
    untouched; on a ``BaseException`` (``KeyboardInterrupt``) the torn temp
    file is left behind, as a process death would leave it (an injected
    ``crash_after_bytes`` fault at ``fault_name`` is one).
    """
    path = os.fspath(path)
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_tmp_counter))
    f = open(tmp, "wb")
    writer = _ChecksummedWriter(f, fault_name)
    try:
        yield writer
        if checksum:
            f.write(writer.footer())
        f.flush()
        os.fsync(f.fileno())
    except Exception:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    except BaseException:
        f.close()
        raise
    f.close()
    try:
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def _fsync_dir(dirname):
    # the rename is durable once the directory entry is on disk; some
    # filesystems refuse to open directories — best effort there
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def verify_and_strip(data):
    """``data`` without its CRC footer, the checksum verified. Bytes
    without a well-formed footer are legacy and come back unchanged;
    :class:`ChecksumError` when a footer is there and the payload does
    not match it."""
    if len(data) < FOOTER_LEN:
        return data
    magic, crc, length = struct.unpack("<4sIQ", data[-FOOTER_LEN:])
    if magic != _FOOTER_MAGIC or length != len(data) - FOOTER_LEN:
        return data
    payload = data[:-FOOTER_LEN]
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    if actual != crc:
        raise ChecksumError(
            "checksum mismatch: footer says crc32=0x%08x over %d bytes, "
            "payload has crc32=0x%08x — file is corrupt" % (crc, length, actual))
    return payload


def footer_crc(path):
    """The CRC32 in ``path``'s footer, or None for a legacy (footer-less)
    or missing file: a sidecar that names another CRC belongs to an older
    write of the same path."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < FOOTER_LEN:
                return None
            f.seek(size - FOOTER_LEN)
            tail = f.read(FOOTER_LEN)
    except OSError:
        return None
    magic, crc, length = struct.unpack("<4sIQ", tail)
    if magic != _FOOTER_MAGIC or length != size - FOOTER_LEN:
        return None
    return crc


def read_verified(path):
    """Read ``path`` whole and :func:`verify_and_strip` it."""
    with open(path, "rb") as f:
        return verify_and_strip(f.read())


# thread-confined: wraps one stream for one parser
class PushbackReader:
    """The one seek shape self-delimiting parsers use to peek — a backward
    relative seek within the most recent read — emulated with a pushback
    buffer, so it works over any readable stream (sockets, pipes).
    Subclasses hook :meth:`_read_fresh` to bound or observe bytes from the
    underlying file."""

    def __init__(self, f):
        self._f = f
        self._nread = 0  # fresh bytes consumed from the underlying file
        self._last = b""  # most recent chunk served (seek-back window)
        self._pushback = b""  # already-served bytes awaiting re-serve

    def _read_fresh(self, n):
        return self._f.read(-1 if n is None or n < 0 else n)

    def read(self, n=-1):
        out = b""
        if self._pushback:
            if n is None or n < 0:
                out, self._pushback = self._pushback, b""
            else:
                out, self._pushback = self._pushback[:n], self._pushback[n:]
                n -= len(out)
        if n is None or n < 0 or n > 0:
            data = self._read_fresh(n)
            self._nread += len(data)
            out += data
        # the seek-back window is THIS read's result, re-served bytes
        # included
        self._last = out
        return out

    def seek(self, offset, whence=1):
        if whence != 1 or not -len(self._last) <= offset <= 0:
            raise io.UnsupportedOperation(
                "only backward seeks within the last read are supported")
        if offset:
            self._pushback = self._last[offset:] + self._pushback
            self._last = self._last[:offset]
        return self._nread - len(self._pushback)


class ChecksummingReader(PushbackReader):
    """Read-through CRC verification for a seekable binary stream.

    Wraps an open file positioned at 0 and accumulates the CRC32 of every
    byte the parser reads, in the same pass. The footer (when well-formed;
    otherwise the file is legacy and unverified) is located up front and
    hidden: reads are clamped to the payload. Call :meth:`verify` after
    parsing — it drains any unread payload into the CRC and raises
    :class:`ChecksumError` on a mismatch."""

    def __init__(self, f):
        super().__init__(f)
        f.seek(0, os.SEEK_END)
        size = f.tell()
        self._expected = None
        self._payload_len = size
        if size >= FOOTER_LEN:
            f.seek(size - FOOTER_LEN)
            magic, crc, length = struct.unpack("<4sIQ", f.read(FOOTER_LEN))
            if magic == _FOOTER_MAGIC and length == size - FOOTER_LEN:
                self._expected = crc
                self._payload_len = length
        f.seek(0)
        self._crc = 0

    def _read_fresh(self, n):
        remaining = self._payload_len - self._nread  # hide the footer
        n = remaining if n is None or n < 0 else min(n, remaining)
        data = self._f.read(n) if n > 0 else b""
        self._crc = zlib.crc32(data, self._crc)
        return data

    def verify(self):
        """Drain any unread payload through the CRC and check the footer."""
        if self._expected is None:
            return
        while self._nread < self._payload_len:
            if not self.read(1 << 20):
                break
        if self._crc & 0xFFFFFFFF != self._expected:
            raise ChecksumError(
                "checksum mismatch: footer says crc32=0x%08x over %d bytes, "
                "payload has crc32=0x%08x — file is corrupt"
                % (self._expected, self._payload_len,
                   self._crc & 0xFFFFFFFF))
