"""The slot-rung ladder and the admission error of the decode scheduler."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["QueueFullError", "BucketLadder"]


class QueueFullError(MXNetError):
    """Admission rejected: the queue is at its bound
    (``MXNET_SERVE_DECODE_MAX_QUEUE``)."""

    retry_after_ms = None


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
