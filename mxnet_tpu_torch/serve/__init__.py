"""Serving: the one-shot continuous-batching server and decode serving.

* ``InferenceServer`` / ``serve`` (server.py) — ``serve(module).submit(
  inputs)`` returns a thread-safe ``ResponseHandle``; a dispatch thread
  (or a deterministic ``pump()``) batches queued requests onto a
  batch-size bucket ladder (``BucketEngine``, engine.py), float32 or a
  quantized tier (``compute_dtype="int8"``/``"fp8"``);
* ``ModelRegistry`` (registry.py) — several models on one card,
  deadline-aware fair scheduling, a circuit breaker per model;
* batching.py — ladder, pad/slice, admission queue;
* ``PoissonLoadGen`` / ``run_scripted`` (loadgen.py) — open-loop load;
* ``serve_decoder`` (decode.py) — continuous-batching KV-cache decode,
  with chunked prefill, speculative decoding (``speculative_verify``,
  sampling.py) and the prefix store (``PrefixStore``, prefix.py).

Config: ``MXNET_SERVE_BUCKETS`` (default ladder), ``MXNET_SERVE_MAX_QUEUE``,
``MXNET_SERVE_DEADLINE_MS``, ``MXNET_SERVE_QUANTIZE``; for decode
``MXNET_SERVE_DECODE_SLOTS``, ``MXNET_SERVE_PREFILL_CHUNK``,
``MXNET_SERVE_SPEC_K``, ``MXNET_SERVE_PREFIX_CACHE_MB``.

* ``PredictorEngine`` (engine.py) — serves an artifact of
  ``predict.export_model`` at its exported batch;
* warm restarts (warm.py) — ``InferenceServer.checkpoint_to(manager)`` /
  ``save_server`` commit the registry through ``checkpoint/``,
  ``restore_server(directory)`` rebuilds it.
"""
from __future__ import annotations

from ..faults import CircuitOpenError
from .clock import MonotonicClock, FakeClock
from .batching import (BucketLadder, QueueFullError, ResponseHandle,
                       ShedError, bucket_for, default_ladder, pad_rows,
                       slice_rows)
from .engine import BucketEngine, PredictorEngine
from .registry import ModelRegistry
from .server import InferenceServer, serve
from .loadgen import PoissonLoadGen, run_scripted
from .decode import (DecodeEngine, DecodeHandle, DecodeScheduler,
                     default_prefill_chunk, default_slot_ladder,
                     default_spec_k, serve_decoder)
from .prefix import PrefixStore, default_prefix_budget_bytes
from .sampling import SamplingParams
from .warm import save_server, restore_server, server_payload

__all__ = ["MonotonicClock", "FakeClock", "BucketLadder",
           "QueueFullError", "ShedError", "CircuitOpenError",
           "ResponseHandle", "bucket_for",
           "default_ladder", "pad_rows", "slice_rows", "BucketEngine",
           "PredictorEngine", "ModelRegistry", "InferenceServer",
           "serve", "PoissonLoadGen", "run_scripted", "DecodeEngine",
           "DecodeScheduler", "DecodeHandle", "default_slot_ladder",
           "default_prefill_chunk", "default_spec_k", "PrefixStore",
           "default_prefix_budget_bytes",
           "SamplingParams", "serve_decoder", "save_server",
           "restore_server", "server_payload"]
