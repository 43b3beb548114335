"""Prefix store: cache rows of shared prompt prefixes, for reuse.

Requests that share a system prompt would re-prefill it, and the cache
rows they compute are the same bytes every time. When a sequence
submitted with ``prefix_id=`` finishes its prefill, the scheduler copies
its first ``len(prompt)`` cache positions (every layer's K and V rows, of
the target engine and, with speculative decoding, of the draft engine)
plus the token ids they encode into a ``PrefixStore``. A later
``submit(prefix_id=...)`` whose prompt starts with those tokens *joins at
cursor C*: the rows are written back into its slot and its cursor set to
C, so it skips the shared prefix and its cache holds what a cold prefill
would have written.

One ``prefix_id`` names one token prefix. The store checks that the
stored tokens head the new prompt: a mismatch is a miss (and counts in
``mismatches``), never a wrong join. Entries are evicted least recently
used first under a byte budget (``MXNET_SERVE_PREFIX_CACHE_MB``, default
64). The JAX package's store, unchanged; the rows are host tensors here.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

__all__ = ["PrefixStore", "default_prefix_budget_bytes"]


def default_prefix_budget_bytes():
    """``MXNET_SERVE_PREFIX_CACHE_MB``, default 64 MiB; 0 disables
    reuse."""
    try:
        mb = float(os.environ.get("MXNET_SERVE_PREFIX_CACHE_MB", "64"))
    except ValueError:
        mb = 64.0
    return int(max(0.0, mb) * (1 << 20))


class _Entry:
    __slots__ = ("tokens", "payloads", "nbytes", "hits")

    def __init__(self, tokens, payloads):
        self.tokens = np.asarray(tokens, np.int64).reshape(-1)
        self.payloads = payloads     # engine tag -> {cell name: rows}
        self.nbytes = self.tokens.nbytes + sum(
            arr.nbytes for rows in payloads.values()
            for arr in rows.values())
        self.hits = 0


class PrefixStore:
    """LRU byte-budgeted map ``prefix_id -> (tokens, cache rows)``."""

    def __init__(self, budget_bytes=None):
        self.budget_bytes = int(budget_bytes
                                if budget_bytes is not None
                                else default_prefix_budget_bytes())
        self._entries = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.mismatches = 0
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    @property
    def used_bytes(self):
        return sum(e.nbytes for e in self._entries.values())

    def lookup(self, prefix_id, prompt, tags=()):
        """Hit test for one admission: ``(C, entry)`` — the usable cursor,
        at most ``len(prompt) - 1`` so that the join keeps one token to
        feed (the first dispatch samples from it) — or ``(0, None)`` on a
        miss. ``tags`` names the engine payloads the caller needs (the
        draft's rows when speculation is armed): an entry without one is a
        miss, not a half join."""
        entry = self._entries.get(prefix_id)
        if entry is None:
            self.misses += 1
            return 0, None
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        c = min(entry.tokens.shape[0], prompt.shape[0] - 1)
        if c < 1 or not np.array_equal(entry.tokens[:c], prompt[:c]):
            self.mismatches += 1
            self.misses += 1
            return 0, None
        if any(tag not in entry.payloads for tag in tags):
            self.misses += 1
            return 0, None
        self._entries.move_to_end(prefix_id)
        entry.hits += 1
        self.hits += 1
        return c, entry

    def put(self, prefix_id, tokens, payloads):
        """Store (or refresh) one prefix. An entry larger than the budget
        is dropped whole; otherwise the least recently used entries go
        until it fits. Returns True when stored."""
        entry = _Entry(tokens, payloads)
        if self.budget_bytes <= 0 or entry.nbytes > self.budget_bytes:
            return False
        self._entries.pop(prefix_id, None)
        while self._entries and \
                self.used_bytes + entry.nbytes > self.budget_bytes:
            self._entries.popitem(last=False)
            self.evictions += 1
        self._entries[prefix_id] = entry
        return True

    def stats(self):
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self.used_bytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "mismatches": self.mismatches,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / total, 4) if total else None,
        }
