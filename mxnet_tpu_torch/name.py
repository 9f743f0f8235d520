"""Automatic symbol naming (reference: python/mxnet/name.py).

``NameManager`` hands out ``op_name + counter`` names for anonymous symbols;
``Prefix`` prepends a scope prefix — identical user-visible behavior so symbol
JSON produced here names nodes the same way the reference does.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Manages automatic naming of symbols; with-scope stacked."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """Return ``name`` if given, else generate ``hint%d``."""
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        v = getattr(NameManager._current, "value", None)
        if v is None:
            v = NameManager()
            NameManager._current.value = v
        return v


class Prefix(NameManager):
    """Name manager that always attaches a prefix to all names."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


NameManager._current.value = NameManager()
