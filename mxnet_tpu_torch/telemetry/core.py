"""Span tracer: named, nested intervals over a thread-local stack, and
instant events.

The port's copy of ``mxnet_tpu/telemetry/core.py``'s spans and events.
Off by default: while disabled, ``span()`` returns one shared no-op
context manager and ``event()`` returns at once, so an instrumented site
costs a call and a branch. An enabled span is measured with
``time.perf_counter_ns`` (microseconds, chrome://tracing's unit),
buffered until ``clear()``, mirrored into the flight-recorder ring, and
— given ``_hist`` — observed in seconds by that histogram. The serving
server wraps each model's warmup in ``serve.warmup``; ``Module.fit``
wraps each batch in ``module.fit.batch`` and records a ``batch_end``
event.

Pure stdlib.
"""
from __future__ import annotations

import os
import threading
import time

from . import flightrec as _flightrec

__all__ = ["span", "event", "record_event", "enable", "disable", "enabled",
           "clear", "get_spans", "get_events", "null_span"]

_lock = threading.Lock()
_local = threading.local()
_spans = []        # finished Span objects, completion order
_events = []       # instant events: dicts with kind/ts_us/pid/tid/payload
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
                 "depth", "_hist")

    def __init__(self, name, args, hist=None):
        self.name = name
        self.args = args
        self.ts = 0
        self.dur = 0
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self.parent = None
        self.depth = 0
        self._hist = hist

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
        if self._hist is not None:
            from .metrics import histogram
            histogram(self._hist).observe(self.dur / 1e6)
        return False


def span(name, _hist=None, **args):
    """Context manager measuring a named interval; the shared no-op span
    while telemetry is disabled. ``_hist`` names a histogram that also
    receives the duration in seconds."""
    if not _enabled:
        return null_span
    return Span(name, args, hist=_hist)


def event(kind, **payload):
    """Record an instant event (no-op while telemetry is disabled)."""
    if not _enabled:
        return
    rec = {"kind": kind, "ts_us": time.perf_counter_ns() // 1000,
           "pid": os.getpid(), "tid": threading.get_ident(),
           "payload": payload}
    with _lock:
        _events.append(rec)
    _flightrec.note_event(rec)


# the JAX package's structured-log spelling of the same record
record_event = event


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def clear():
    """Drop buffered spans and events (metrics have their own reset)."""
    with _lock:
        del _spans[:]
        del _events[:]


def get_spans():
    with _lock:
        return list(_spans)


def get_events():
    with _lock:
        return list(_events)
