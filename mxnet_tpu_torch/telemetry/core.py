"""Span tracer: named, nested intervals over a thread-local stack.

The port's copy of the span half of ``mxnet_tpu/telemetry/core.py``.
Off by default: while disabled, ``span()`` returns one shared no-op
context manager, so an instrumented site costs a call and a branch. An
enabled span is measured with ``time.perf_counter_ns`` (microseconds,
chrome://tracing's unit), buffered until ``clear()``, and mirrored into
the flight-recorder ring. The serving server wraps each model's warmup
in ``serve.warmup``.

Pure stdlib.
"""
from __future__ import annotations

import os
import threading
import time

from . import flightrec as _flightrec

__all__ = ["span", "enable", "disable", "enabled", "clear", "get_spans",
           "null_span"]

_lock = threading.Lock()
_local = threading.local()
_spans = []        # finished Span objects, completion order
_enabled = False


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _NullSpan:
    """Shared do-nothing span for the disabled fast path."""

    __slots__ = ()
    dur = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kwargs):
        return self


null_span = _NullSpan()


class Span:
    """One named interval; ``ts``/``dur`` in perf_counter microseconds."""

    __slots__ = ("name", "args", "ts", "dur", "pid", "tid", "parent",
                 "depth")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self.ts = 0
        self.dur = 0
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self.parent = None
        self.depth = 0

    def set(self, **kwargs):
        self.args.update(kwargs)
        return self

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1].name
            self.depth = len(st)
        st.append(self)
        self.ts = time.perf_counter_ns() // 1000
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = time.perf_counter_ns() // 1000 - self.ts
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        with _lock:
            _spans.append(self)
        _flightrec.note_span(self)
        return False


def span(name, **args):
    """Context manager measuring a named interval; the shared no-op span
    while telemetry is disabled."""
    if not _enabled:
        return null_span
    return Span(name, args)


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def clear():
    """Drop buffered spans (metrics have their own reset)."""
    with _lock:
        del _spans[:]


def get_spans():
    with _lock:
        return list(_spans)
