"""Continuous-batching decode serving: ``serve_decoder(decode_symbol,
params).submit(prompt)``."""
from __future__ import annotations

from .clock import MonotonicClock, FakeClock
from .batching import BucketLadder, QueueFullError
from .decode import (DecodeEngine, DecodeHandle, DecodeScheduler,
                     default_slot_ladder, serve_decoder)
from .sampling import SamplingParams

__all__ = ["MonotonicClock", "FakeClock", "BucketLadder", "QueueFullError",
           "DecodeEngine", "DecodeScheduler", "DecodeHandle",
           "default_slot_ladder", "SamplingParams", "serve_decoder"]
