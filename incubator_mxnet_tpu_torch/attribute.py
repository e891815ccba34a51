"""Attribute scoping for symbols (counterpart of
``incubator_mxnet_tpu/attribute.py``; reference python/mxnet/attribute.py:
AttrScope), the port's own copy: ``with mx.AttrScope(ctx_group='dev1'):``
attaches user attributes to every symbol created in scope, as
``__key__``-style entries of its attribute dict that survive JSON save
and load.  ``ctx_group`` places the group's arguments at bind time
(``Executor(group2ctx=...)``), on the one card of the port."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_state = threading.local()


class AttrScope:
    """Attach user attributes to all symbols created in scope
    (reference attribute.py:AttrScope)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old = None

    @classmethod
    def current(cls):
        scope = getattr(_state, "scope", None)
        if scope is None:
            scope = _state.scope = AttrScope()
        return scope

    def get(self, attr=None):
        """Merge scope attrs with explicit ones (explicit wins)."""
        if not self._attr:
            return attr or {}
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        self._old = AttrScope.current()
        merged = dict(self._old._attr)
        merged.update(self._attr)
        new = AttrScope.__new__(AttrScope)
        new._attr = merged
        new._old = None
        _state.scope = new
        return self

    def __exit__(self, *exc):
        _state.scope = self._old
        return False
