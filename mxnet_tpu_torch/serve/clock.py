"""Scheduler time source: real monotonic clock or a scripted fake.

Every deadline decision in the decode scheduler reads time through this
one seam, so tests can script arrivals with zero wall-clock sleeps
(``FakeClock`` + ``DecodeScheduler.pump()``), while serving uses
``time.monotonic``. The fake clock never blocks: ``sleep`` advances
virtual time instantly, which also makes warmup timing measure 0 s.
"""
from __future__ import annotations

import time

__all__ = ["MonotonicClock", "FakeClock"]


class MonotonicClock:
    """Real time: ``time.monotonic`` seconds."""

    def now(self):
        return time.monotonic()

    def sleep(self, seconds):
        if seconds > 0:
            time.sleep(seconds)


class FakeClock:
    """Virtual time under test control.

    ``advance``/``sleep`` move time forward instantly; nothing blocks.
    Use with ``InferenceServer.pump()`` (no dispatch thread): the
    dispatch thread's condition-variable waits are real-time and would
    spin against a clock that only moves when the test says so.
    """

    def __init__(self, start=0.0):
        self._now = float(start)

    def now(self):
        return self._now

    def advance(self, seconds):
        if seconds < 0:
            raise ValueError("time only moves forward")
        self._now += float(seconds)
        return self._now

    def sleep(self, seconds):
        self.advance(max(0.0, seconds))
