"""Automatic naming of blocks (counterpart of
``incubator_mxnet_tpu/name.py``; reference python/mxnet/name.py),
kept as the port's own copy: ``NameManager`` hands out ``<hint><n>``
names from per-hint counters, ``Prefix`` prepends a prefix to them.
``NameManager.current`` is the innermost scope of the process, as in
the JAX package."""
from __future__ import annotations

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Scope-based unique name assignment (reference
    name.py:NameManager)."""

    current = None  # the innermost scope; set below

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """``name`` when given, else ``hint`` with its next count."""
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"

    def __enter__(self):
        self._old_manager = NameManager.current
        NameManager.current = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager.current = self._old_manager
        return False


class Prefix(NameManager):
    """Prepend ``prefix`` to every name handed out in scope (reference
    name.py:Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


NameManager.current = NameManager()
