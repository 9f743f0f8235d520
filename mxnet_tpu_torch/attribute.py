"""Attribute scoping (reference: python/mxnet/attribute.py).

``AttrScope`` carries graph-node attributes like ``ctx_group`` (model-parallel
placement, consumed by executor device assignment — reference
src/executor/graph_executor.cc:245-334) and ``__force_mirroring__`` (activation
recompute hints) onto symbols created inside the scope.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    """Attribute manager for local-scoped attributes on symbols."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """Merge user-supplied attrs with the scope's attrs (user wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope is not None
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        v = getattr(AttrScope._current, "value", None)
        if v is None:
            v = AttrScope()
            AttrScope._current.value = v
        return v


AttrScope._current.value = AttrScope()
