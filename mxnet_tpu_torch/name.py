"""Automatic symbol naming (reference: python/mxnet/name.py NameManager)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Assigns auto names like ``convolution0`` to anonymous symbols."""

    _local = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        if not hasattr(NameManager._local, "stack"):
            NameManager._local.stack = []
        NameManager._local.stack.append(self)
        return self

    def __exit__(self, *args):
        NameManager._local.stack.pop()


class Prefix(NameManager):
    """Prepends a prefix to every auto name. reference: name.py Prefix."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


_DEFAULT = NameManager()


def current():
    stack = getattr(NameManager._local, "stack", None)
    if stack:
        return stack[-1]
    return _DEFAULT
