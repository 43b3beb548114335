"""Dynamic-batch assembly: bucket ladder, pad/slice, admission queue.

A request carries one or more *rows* (examples): its inputs have a
leading row dimension. The one-shot server coalesces queued requests FIFO
into one batch of N rows, pads it (``pad_rows``: zero rows appended —
compute waste, never numerics, since every inference op downstream of the
data is row-independent) up to the smallest ladder bucket B >= N, runs
the bucket's bound module, and slices rows back per request
(``slice_rows``). ``AdmissionQueue`` owns the per-model FIFO and the
deadline bookkeeping the scheduler's flush decision reads: waiting past
``flush_at`` for a fuller bucket is the pad-vs-wait break-even the
scheduler never crosses. The decode scheduler uses the ladder and
``QueueFullError`` alone.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading

import numpy as np

from ..base import MXNetError

__all__ = ["QueueFullError", "ShedError", "BucketLadder",
           "default_ladder", "bucket_for", "pad_rows", "slice_rows",
           "Request", "ResponseHandle", "AdmissionQueue"]

_req_ids = itertools.count()


class QueueFullError(MXNetError):
    """Admission rejected: the queue is at its bound
    (``MXNET_SERVE_MAX_QUEUE``, or ``MXNET_SERVE_DECODE_MAX_QUEUE`` for
    decode). The server sets ``retry_after_ms``, a drain-time hint."""

    retry_after_ms = None


class ShedError(MXNetError):
    """An ADMITTED request was dropped by load shedding: queue depth
    crossed the watermark and the request could no longer meet its
    deadline even if dispatched immediately. Counted under
    ``serve.shed``, distinct from ``serve.rejected``."""

    retry_after_ms = None
    trace_id = None


def default_ladder():
    """The bucket ladder from ``MXNET_SERVE_BUCKETS`` (default
    ``1,2,4,8,16,32``): comma-separated batch sizes, sorted ascending,
    duplicates dropped."""
    raw = os.environ.get("MXNET_SERVE_BUCKETS", "1,2,4,8,16,32")
    try:
        sizes = sorted({int(tok) for tok in raw.split(",") if tok.strip()})
    except ValueError:
        raise MXNetError(f"MXNET_SERVE_BUCKETS={raw!r}: expected "
                         "comma-separated batch sizes")
    if not sizes or sizes[0] < 1:
        raise MXNetError(f"MXNET_SERVE_BUCKETS={raw!r}: bucket sizes "
                         "must be >= 1")
    return sizes


class BucketLadder:
    """Sorted batch-size (slot-count) rungs one model serves at."""

    def __init__(self, sizes):
        sizes = list(sizes)
        if not sizes:
            raise MXNetError("empty bucket ladder")
        self.sizes = sorted({int(s) for s in sizes})
        if self.sizes[0] < 1:
            raise MXNetError("bucket sizes must be >= 1")

    @property
    def max(self):
        return self.sizes[-1]

    def bucket_for(self, rows):
        """Smallest rung >= rows, or None past the top."""
        for s in self.sizes:
            if s >= rows:
                return s
        return None

    def __iter__(self):
        return iter(self.sizes)

    def __repr__(self):
        return f"BucketLadder({self.sizes})"


def bucket_for(rows, ladder):
    """Module-level convenience over ``BucketLadder.bucket_for``."""
    ladder = ladder if isinstance(ladder, BucketLadder) \
        else BucketLadder(ladder)
    return ladder.bucket_for(rows)


def pad_rows(arr, bucket):
    """Pad ``arr`` (rows leading) with zero rows up to ``bucket``: numpy
    in, numpy out — the batch is assembled on the host and copied to the
    device once per dispatch."""
    arr = np.asarray(arr)
    rows = arr.shape[0]
    if rows > bucket:
        raise MXNetError(f"{rows} rows cannot pad down to bucket {bucket}")
    if rows == bucket:
        return arr
    pad = np.zeros((bucket - rows,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def slice_rows(outputs, start, rows):
    """Rows ``[start, start+rows)`` of every output (NDArray, tensor or
    numpy) as NDArrays on the outputs' device — views, no copy."""
    from ..ndarray import NDArray
    out = []
    for o in outputs:
        val = o.astorch() if isinstance(o, NDArray) else o
        out.append(NDArray(val[start:start + rows]))
    return out


class Request:
    """One admitted unit of work: inputs (name -> rows-leading numpy
    array), row count, arrival/deadline in scheduler-clock seconds, and
    its trace identity when sampled (``trace``/``root_sid``)."""

    __slots__ = ("id", "model", "inputs", "rows", "arrival", "deadline",
                 "handle", "trace", "root_sid")

    def __init__(self, model, inputs, rows, arrival, deadline,
                 trace=None):
        self.id = next(_req_ids)
        self.model = model
        self.inputs = inputs
        self.rows = rows
        self.arrival = arrival
        self.deadline = deadline
        self.trace = trace
        self.root_sid = None
        self.handle = ResponseHandle(self)


class ResponseHandle:
    """Thread-safe sync+async result of one request.

    ``result(timeout)`` blocks until the dispatch thread (or a
    ``pump()``) completes the request and returns the sliced output
    NDArrays or raises the dispatch error; ``done()`` polls;
    ``add_done_callback(fn)`` runs ``fn(handle)`` at completion (at once
    if already complete). ``latency``/``bucket``/``completed_at`` carry
    what the load generator aggregates.
    """

    def __init__(self, request):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks = []
        self._outputs = None
        self._error = None
        self.request = request
        self.bucket = None          # set at dispatch
        self.completed_at = None    # scheduler-clock seconds

    def done(self):
        return self._event.is_set()

    @property
    def trace_id(self):
        """The request's trace id (None when sampling skipped it)."""
        tr = self.request.trace
        return tr.trace_id if tr is not None else None

    @property
    def latency(self):
        """Admission-to-completion seconds (None until done)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.request.arrival

    def missed_deadline(self):
        return (self.completed_at is not None
                and self.completed_at > self.request.deadline)

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise MXNetError(
                f"request {self.request.id} not complete within "
                f"{timeout}s (queue stuck or server stopped?)")
        if self._error is not None:
            raise self._error
        return self._outputs

    def exception(self):
        return self._error if self._event.is_set() else None

    def add_done_callback(self, fn):
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _complete(self, outputs=None, error=None, bucket=None, now=None):
        with self._lock:
            self._outputs = outputs
            self._error = error
            self.bucket = bucket
            self.completed_at = now
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:       # a client callback must not kill
                pass                # the dispatch thread


class AdmissionQueue:
    """Per-model FIFO with the scheduler's flush bookkeeping. Not
    self-locking: the server serializes admission, flush decisions and
    draining under its own lock."""

    def __init__(self, model, max_requests):
        self.model = model
        self.max_requests = max_requests
        self._q = collections.deque()
        self.rows_pending = 0

    def __len__(self):
        return len(self._q)

    def admit(self, request):
        if len(self._q) >= self.max_requests:
            raise QueueFullError(
                f"model {self.model!r}: queue depth {len(self._q)} at "
                f"MXNET_SERVE_MAX_QUEUE={self.max_requests}")
        self._q.append(request)
        self.rows_pending += request.rows

    def oldest_deadline(self):
        """Earliest deadline among queued requests."""
        if not self._q:
            return None
        return min(r.deadline for r in self._q)

    def flush_at(self, exec_est):
        """Latest dispatch start that still meets the earliest queued
        deadline, given ``exec_est`` seconds of bucket execution."""
        d = self.oldest_deadline()
        return None if d is None else d - exec_est

    def shed_doomed(self, now, exec_est_fn):
        """Remove and return every queued request that cannot meet its
        deadline even if dispatched now (``deadline < now +
        exec_est_fn(rows)``)."""
        doomed, keep = [], collections.deque()
        for r in self._q:
            if r.deadline < now + exec_est_fn(r.rows):
                doomed.append(r)
                self.rows_pending -= r.rows
            else:
                keep.append(r)
        self._q = keep
        return doomed

    def drain(self, max_rows):
        """Pop FIFO-prefix requests whose rows fit in ``max_rows``."""
        took, rows = [], 0
        while self._q and rows + self._q[0].rows <= max_rows:
            r = self._q.popleft()
            rows += r.rows
            took.append(r)
        self.rows_pending -= rows
        return took, rows

    def fail_all(self, error, now=None):
        """Complete every queued request with ``error`` (server stop)."""
        while self._q:
            r = self._q.popleft()
            self.rows_pending -= r.rows
            r.handle._complete(error=error, now=now)
