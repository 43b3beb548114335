"""Request-scoped trace plane: trace ids, span trees, bounded buffer.

The port's copy of ``mxnet_tpu/telemetry/trace.py``. A served request
carries a ``Trace`` (one ``trace_id``) from ``submit`` to its
``ResponseHandle``; every stage it crosses records a ``(trace, span,
parent)`` triple, so the request reconstructs to one parented span tree
(``tree(trace_id)``) after the fact.

* Spans are recorded at finish with explicit start/end times from the
  caller's clock (the serving scheduler's ``MonotonicClock`` or
  ``FakeClock`` seconds), so traces under the fake clock are exact.
* A span id recorded more than once keeps its last record in
  ``spans()``/``tree()``.
* Batched requests share ONE dispatch span id, mirrored into each
  member's trace under that member's root.

Storage is a bounded deque (``MXNET_TRACE_CAPACITY``, default 4096
records), and every record is mirrored into the flight-recorder ring.
Sampling (``MXNET_TRACE_SAMPLE``, default 1.0) is counter-based: request
k is traced iff ``floor(k*rate) > floor((k-1)*rate)`` — the same
decisions every run. Records carry no rank: the port runs one process
per card until the multi-GPU slice tags them.

Pure stdlib.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading

from . import flightrec as _flightrec

__all__ = ["Trace", "new_trace", "next_span_id", "record", "sample",
           "spans", "tree", "clear", "configure"]

_DEFAULT_CAPACITY = 4096

_lock = threading.Lock()


def _env_capacity():
    try:
        return max(1, int(os.environ.get("MXNET_TRACE_CAPACITY", "")
                          or _DEFAULT_CAPACITY))
    except ValueError:
        return _DEFAULT_CAPACITY


def _env_sample():
    try:
        rate = float(os.environ.get("MXNET_TRACE_SAMPLE", "") or 1.0)
    except ValueError:
        rate = 1.0
    return min(1.0, max(0.0, rate))


_buf = collections.deque(maxlen=_env_capacity())
_sample_rate = _env_sample()
_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)
_sample_count = 0


class Trace:
    """One trace identity: ``trace_id`` plus the root span id once the
    root has been recorded."""

    __slots__ = ("trace_id", "root")

    def __init__(self, trace_id):
        self.trace_id = trace_id
        self.root = None

    def __repr__(self):
        return f"Trace({self.trace_id!r}, root={self.root})"


def new_trace():
    """A fresh trace identity (one counter bump)."""
    return Trace(f"t{next(_trace_seq):06x}")


def next_span_id():
    """Process-wide unique span id."""
    return next(_span_seq)


def sample():
    """Deterministic sampling decision for the next request at
    ``MXNET_TRACE_SAMPLE``: rate 1.0 always samples, 0.0 never."""
    global _sample_count
    rate = _sample_rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    with _lock:
        k = _sample_count = _sample_count + 1
    return int(k * rate) > int((k - 1) * rate)


def record(trace, name, start_s, end_s, span_id=None, parent=None,
           **args):
    """Record one finished span into the buffer and the flight ring.

    ``trace``: a Trace or a bare trace-id string; ``start_s``/``end_s``
    are caller-clock seconds. Returns the span id used (allocating one
    when not given)."""
    tid = trace.trace_id if isinstance(trace, Trace) else str(trace)
    sid = span_id if span_id is not None else next_span_id()
    rec = {"trace": tid, "span": sid, "parent": parent, "name": name,
           "ts_us": round(start_s * 1e6),
           "dur_us": max(0, round((end_s - start_s) * 1e6)), **args}
    _buf.append(rec)
    if isinstance(trace, Trace) and parent is None and trace.root is None:
        trace.root = sid
    _flightrec.note("trace.span", **rec)
    return sid


def spans(trace_id=None):
    """Recorded spans (last record per (trace, span) wins), optionally
    of one trace, in record order."""
    with _lock:
        raw = list(_buf)
    out = {}
    for rec in raw:
        if trace_id is not None and rec["trace"] != trace_id:
            continue
        out[(rec["trace"], rec["span"])] = rec
    return list(out.values())


def tree(trace_id):
    """One trace as a nested tree: the root node ``{.., "children":
    [...]}`` (children in start order), or None without spans or root.
    Orphans (parent evicted from the buffer) attach under the root."""
    recs = spans(trace_id)
    if not recs:
        return None
    nodes = {r["span"]: dict(r, children=[]) for r in recs}
    root = None
    for r in recs:
        node = nodes[r["span"]]
        if r["parent"] is None and root is None:
            root = node
        elif r["parent"] in nodes and r["parent"] != r["span"]:
            nodes[r["parent"]]["children"].append(node)
    if root is None:
        return None
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["ts_us"])
    attached = set()

    def mark(n):
        attached.add(n["span"])
        for c in n["children"]:
            mark(c)
    mark(root)
    for r in recs:
        if r["span"] not in attached and r["parent"] is not None:
            root["children"].append(nodes[r["span"]])
            mark(nodes[r["span"]])
    return root


def clear():
    """Drop buffered trace records (ids keep counting)."""
    _buf.clear()


def configure(capacity=None, sample=None, reset_ids=False):
    """Resize the buffer (newest kept), override the sample rate, or
    rewind the trace/span id counters (deterministic-id tests)."""
    global _buf, _sample_rate, _trace_seq, _span_seq, _sample_count
    if capacity is not None:
        _buf = collections.deque(_buf, maxlen=max(1, int(capacity)))
    if sample is not None:
        _sample_rate = min(1.0, max(0.0, float(sample)))
        _sample_count = 0
    if reset_ids:
        _trace_seq = itertools.count(1)
        _span_seq = itertools.count(1)
        _sample_count = 0
