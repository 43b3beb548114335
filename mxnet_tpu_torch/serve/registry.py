"""Multi-tenant model registry + deadline-aware fair scheduling.

The port's copy of ``mxnet_tpu/serve/registry.py``. Several models share
one card (engines run serially on the dispatch thread); per model the
registry owns the engine, the admission queue, a circuit breaker and a
fairness serial. A model is *ready* when its queued rows fill the largest
bucket or when the scheduler clock reaches its ``flush_at`` (the earliest
queued deadline minus the execution estimate of the bucket that would
serve the queue now); among ready models the least recently dispatched
wins (round robin under saturation).

``next_action`` is a pure decision over (queues, clock): ``("dispatch",
model)`` or ``("wait", seconds|None)``, mutating nothing.
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from ..faults import CircuitBreaker
from .batching import AdmissionQueue

__all__ = ["ModelRegistry"]


class _Entry:
    __slots__ = ("engine", "queue", "breaker", "last_dispatch_seq")

    def __init__(self, engine, max_queue, breaker_threshold,
                 breaker_cooldown_s):
        self.engine = engine
        self.queue = AdmissionQueue(engine.name, max_queue)
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            site=f"serve:{engine.name}", labels={"model": engine.name},
            metric_prefix="serve.breaker")
        self.last_dispatch_seq = 0


class ModelRegistry:
    """name -> (engine, admission queue, breaker, fairness serial)."""

    def __init__(self, max_queue, breaker_threshold=5,
                 breaker_cooldown_s=1.0):
        self._entries = {}
        self._max_queue = max_queue
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._seq = 0
        self._lock = threading.Lock()   # registration only; the server
                                        # lock serializes scheduling

    def add(self, engine):
        with self._lock:
            if engine.name in self._entries:
                raise MXNetError(
                    f"model {engine.name!r} already registered")
            self._entries[engine.name] = _Entry(
                engine, self._max_queue, self._breaker_threshold,
                self._breaker_cooldown_s)
        return engine

    def remove(self, name):
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is None:
            raise MXNetError(f"no model {name!r} registered")
        return entry

    def names(self):
        return list(self._entries)

    def engine(self, name):
        entry = self._entries.get(name)
        if entry is None:
            raise MXNetError(
                f"no model {name!r} registered "
                f"(have: {sorted(self._entries)})")
        return entry.engine

    def entry(self, name):
        """The model's record, or None."""
        return self._entries.get(name)

    def entries(self):
        return list(self._entries.values())

    def sole_name(self):
        """The single registered model's name (``serve(model)`` lets
        ``submit()`` omit it)."""
        names = list(self._entries)
        if len(names) != 1:
            raise MXNetError(
                "submit() needs an explicit model name with "
                f"{len(names)} models registered (have: {sorted(names)})")
        return names[0]

    # ---------------------------------------------------------- scheduling
    def _flush_at(self, entry):
        """The model's pad-vs-wait break-even instant (None if idle)."""
        q = entry.queue
        if not len(q):
            return None
        bucket = entry.engine.ladder.bucket_for(
            min(q.rows_pending, entry.engine.ladder.max))
        return q.flush_at(entry.engine.exec_estimate(bucket))

    def next_action(self, now):
        """('dispatch', name) | ('wait', seconds|None), mutating nothing.

        Ready = bucket full or past flush_at, AND the model's breaker
        permits a dispatch at ``now``; ties go to the least recently
        dispatched model. An open breaker with queued work contributes
        its probe instant to the wait bound; with no work at all the wait
        is unbounded (None).
        """
        ready, soonest = [], None
        for name, entry in self._entries.items():
            q = entry.queue
            if not len(q):
                continue
            if not entry.breaker.can_dispatch(now):
                probe_in = entry.breaker.retry_after(now)
                if probe_in > 0:
                    soonest = now + probe_in if soonest is None \
                        else min(soonest, now + probe_in)
                continue
            if q.rows_pending >= entry.engine.ladder.max:
                ready.append((entry.last_dispatch_seq, name))
                continue
            flush_at = self._flush_at(entry)
            if flush_at is not None and now >= flush_at:
                ready.append((entry.last_dispatch_seq, name))
            elif flush_at is not None:
                soonest = flush_at if soonest is None \
                    else min(soonest, flush_at)
        if ready:
            ready.sort()
            return "dispatch", ready[0][1]
        if soonest is not None:
            return "wait", max(0.0, soonest - now)
        return "wait", None

    def note_dispatch(self, name):
        """Bump the fairness serial for a dispatched model."""
        self._seq += 1
        self._entries[name].last_dispatch_seq = self._seq
