"""What the port's ``g++`` builds share (``_native.py``, ``_capi.py``,
``_predict_native.py``): the digest that names a library, the locked
build that puts it in place, and a compiled client's device environment.

Several processes may build one library at once (test workers):
:func:`build_locked` runs the build under an exclusive file lock, into a
temporary name that is renamed into place, so a process loads either
nothing or a whole library, and only one process compiles it.
"""
from __future__ import annotations

import fcntl
import hashlib
import os

__all__ = ["digest", "build_locked", "client_env"]


def digest(paths, flags):
    """16 hex digits over each file's name and bytes (in sorted order)
    and the flags: what names a library's build."""
    h = hashlib.sha256()
    for path in sorted(paths):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_locked(path, make, lock=None):
    """Makes ``path`` unless it exists: ``make(tmp)`` writes the file
    ``tmp``, renamed to ``path`` once it returns, all under an exclusive
    lock on ``lock`` (by default ``build.lock`` beside ``path``). Returns
    True when this call made it."""
    if os.path.exists(path):
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lock = lock or os.path.join(os.path.dirname(path), "build.lock")
    with open(lock, "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):      # another process built it
                return False
            tmp = "%s.%d.tmp" % (path, os.getpid())
            make(tmp)
            os.replace(tmp, path)
            return True
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def client_env(env=None, cpu=False):
    """A copy of ``env`` (default this process's) for a compiled client:
    ``cpu`` sets ``MXNET_DEFAULT_CONTEXT=cpu``; otherwise an inherited one
    is dropped, so the client runs on the card."""
    env = dict(os.environ if env is None else env)
    if cpu:
        env["MXNET_DEFAULT_CONTEXT"] = "cpu"
    else:
        env.pop("MXNET_DEFAULT_CONTEXT", None)
    return env
