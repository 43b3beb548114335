"""Attribute scoping (reference: python/mxnet/attribute.py AttrScope).

``with mx.AttrScope(ctx_group='dev1'):`` tags every symbol created inside
with the given attributes — the mechanism behind model-parallel layer
placement (reference: example/model-parallel-lstm/lstm.py:48-112). The
tags ride the symbol JSON unchanged.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _local = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs
        self._old = None

    @classmethod
    def _current(cls):
        return getattr(cls._local, "scope", None)

    def get(self, attr):
        """Merge scope attrs into user attrs (user wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        current = AttrScope._current()
        if current is not None and current._attr:
            merged = current._attr.copy()
            merged.update(self._attr)
            self._attr = merged
        self._old = current
        AttrScope._local.scope = self
        return self

    def __exit__(self, *args):
        AttrScope._local.scope = self._old


def current_attrs(attr=None):
    scope = AttrScope._current()
    if scope is None:
        return attr if attr else {}
    return scope.get(attr)
