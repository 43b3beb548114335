"""Continuous decode batching: iteration-level scheduling over a
slot-pooled KV cache.

A KV-cache decoder serves *sequences* — hundreds of single-token steps
carrying device state between them. This module serves up to SLOTS
sequences through one bound graph per iteration:

* ``DecodeEngine`` — a slot-capacity rung ladder (``MXNET_SERVE_DECODE_
  SLOTS``, default ``1,4,8``) over ``get_decode_symbol(per_slot=True)``:
  every rung is a Module bound at ``(slots, 1)``, all sharing ONE set of
  parameter cells through a ``BucketingModule`` leader, each owning its
  ``(slots, H, C, Dh)`` KV-cache pool. ``warmup`` runs every rung twice
  (kernels build and load on the first step). Rung switches migrate the
  live slots' cache rows and cursors between pools in place.
* ``DecodeScheduler`` — continuous batching on the ``submit`` seam:
  admission into free slots, per-iteration retirement (EOS / max-new-
  tokens / deadline / per-slot cache overflow — an overflowing slot fails
  ALONE), sampling per request (``SamplingParams``; default greedy), and
  streaming delivery through ``DecodeHandle`` callbacks. Two drive modes:
  ``start()`` (dispatch thread, real clock) and ``pump()`` (explicit
  iterations, FakeClock-deterministic).

Not ported yet, and refused with an error rather than ignored: chunked-
prefill windows (``symbol_gen``), speculative decoding
(``draft_symbol_gen``) and the prefix store (``submit(prefix_id=)``).
Telemetry metrics and trace spans are a later slice too; ``stats()``
reports the scheduler's own counters.
"""
from __future__ import annotations

import collections
import itertools
import logging
import os
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..io import DataDesc
from .batching import BucketLadder, QueueFullError
from .clock import MonotonicClock
from .sampling import SamplingParams, sample_token

__all__ = ["DecodeEngine", "DecodeScheduler", "DecodeHandle",
           "default_slot_ladder", "serve_decoder"]

log = logging.getLogger(__name__)

_seq_ids = itertools.count()

_GREEDY = SamplingParams()

_LATER = {
    "symbol_gen": "chunked-prefill windows",
    "draft_symbol_gen": "speculative decoding",
    "prefix_id": "the prefix store",
}


def _not_ported(what):
    return MXNetError(f"{what}= arms {_LATER[what]}, which the PyTorch "
                      "port does not have yet (a later slice); leave it "
                      "unset")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_slot_ladder():
    """The slot-capacity rung ladder from ``MXNET_SERVE_DECODE_SLOTS``
    (default ``1,4,8``), sorted ascending, duplicates dropped."""
    raw = os.environ.get("MXNET_SERVE_DECODE_SLOTS", "1,4,8")
    try:
        sizes = sorted({int(tok) for tok in raw.split(",") if tok.strip()})
    except ValueError:
        raise MXNetError(f"MXNET_SERVE_DECODE_SLOTS={raw!r}: expected "
                         "comma-separated slot counts") from None
    if not sizes or sizes[0] < 1:
        raise MXNetError(f"MXNET_SERVE_DECODE_SLOTS={raw!r}: slot "
                         "counts must be >= 1")
    return sizes


class _Sequence:
    """One admitted decode request's scheduling state. The *stream* is
    ``prompt ++ generated``; ``fed`` counts stream tokens whose cache rows
    are written (= the slot's device cursor)."""

    __slots__ = ("id", "prompt", "max_new", "eos_id", "arrival",
                 "deadline", "handle", "fed", "generated", "slot",
                 "finish_reason", "sampling", "rng")

    def __init__(self, prompt, max_new, eos_id, arrival, deadline,
                 sampling=None):
        self.id = next(_seq_ids)
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.arrival = arrival
        self.deadline = deadline          # absolute clock s, or None
        self.fed = 0
        self.generated = []
        self.slot = None
        self.finish_reason = None
        self.sampling = sampling if sampling is not None else _GREEDY
        self.rng = self.sampling.make_rng()
        self.handle = DecodeHandle(self)

    def stream_len(self):
        return len(self.prompt) + len(self.generated)

    def stream_token(self, i):
        if i < len(self.prompt):
            return int(self.prompt[i])
        return int(self.generated[i - len(self.prompt)])

    def remaining(self):
        """Stream tokens not yet fed (1 in steady state; more while the
        prompt is being prefilled)."""
        return self.stream_len() - self.fed


class DecodeHandle:
    """Streaming sync+async result surface for one decode request.

    ``done()``/``result()``/``add_done_callback``/``latency``, plus
    ``add_token_callback(fn)``: ``fn(handle, token, index)`` per generated
    token, already-emitted tokens replayed on registration. ``result()``
    returns the generated ids as int32 numpy (EOS excluded);
    ``finish_reason`` is ``"eos"``, ``"length"``, ``"deadline"`` or None
    when the sequence errored (``exception()`` carries it)."""

    def __init__(self, request):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._done_callbacks = []
        self._token_callbacks = []
        self._tokens = []
        self._error = None
        self.request = request
        self.completed_at = None        # scheduler-clock seconds

    def done(self):
        return self._event.is_set()

    @property
    def tokens(self):
        with self._lock:
            return list(self._tokens)

    @property
    def finish_reason(self):
        return self.request.finish_reason

    @property
    def latency(self):
        """Admission-to-completion seconds (None until done)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.request.arrival

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise MXNetError(
                f"decode request {self.request.id} not complete within "
                f"{timeout}s (scheduler stopped or stuck?)")
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int32)

    def exception(self):
        return self._error if self._event.is_set() else None

    def add_done_callback(self, fn):
        with self._lock:
            if not self._event.is_set():
                self._done_callbacks.append(fn)
                return
        fn(self)

    def add_token_callback(self, fn):
        with self._lock:
            replay = list(enumerate(self._tokens))
            self._token_callbacks.append(fn)
        for i, tok in replay:
            self._safe(fn, tok, i)

    def _safe(self, fn, *args):
        try:
            fn(self, *args)
        except Exception:       # a client callback must not kill the
            log.exception("decode callback raised")   # scheduler thread

    def _emit(self, token):
        with self._lock:
            index = len(self._tokens)
            self._tokens.append(int(token))
            cbs = list(self._token_callbacks)
        for fn in cbs:
            self._safe(fn, int(token), index)

    def _complete(self, error=None, now=None):
        with self._lock:
            self._error = error
            self.completed_at = now
            callbacks, self._done_callbacks = self._done_callbacks, []
            self._event.set()
        for fn in callbacks:
            self._safe(fn)


class DecodeEngine:
    """Slot-capacity rung ladder over a slot-pooled decode graph.

    ``symbol`` is a per-slot stateful decode graph
    (``models.transformer.get_decode_symbol(per_slot=True)``) whose batch
    dim is the slot count; the same symbol binds at every rung. Runs on
    ``context`` (default: the current context, ``gpu(0)``)."""

    def __init__(self, name, symbol, arg_params, aux_params=None,
                 capacity=None, ladder=None, context=None, logger=None):
        from ..context import current_context
        from ..models.transformer import BatchedKVCacheDecoder
        from ..module import BucketingModule

        self.name = name
        self.ladder = ladder if isinstance(ladder, BucketLadder) \
            else BucketLadder(ladder if ladder is not None
                              else default_slot_ladder())
        self.exec_est = {}              # rung -> EMA'd step seconds
        self._context = context if context is not None \
            else current_context()
        self._context.torch_device()    # raises at once without CUDA
        self.pos_embed = "learned" \
            if "pos_ids" in symbol.list_arguments() else "rotary"
        self.data_names = ("data",) + (
            ("pos_ids",) if self.pos_embed == "learned" else ())
        if not any(n.opdef().stateful_infer
                   for n in symbol._topo_nodes() if not n.is_variable):
            raise MXNetError(
                f"DecodeEngine({name!r}): the symbol has no stateful "
                "decode op (build it with get_decode_symbol(per_slot=True))")

        self._bm = BucketingModule(
            sym_gen=lambda slots: (symbol, list(self.data_names), []),
            default_bucket_key=self.ladder.max,
            logger=logger or log, context=self._context)
        self._bm.bind(self._provide_data(self.ladder.max),
                      label_shapes=None, for_training=False)
        # the decode graph's aux states (KV caches + cursors) are absent
        # from any trained parameter set and stay their bound zeros
        self._bm.init_params(initializer=None,
                             arg_params=dict(arg_params or {}),
                             aux_params=dict(aux_params or {}),
                             allow_missing=True)
        self._bm.warm_buckets(
            [(s, self._provide_data(s), None) for s in self.ladder])

        if capacity is None:
            exe = self._bm._leader._exec_group.executor
            caches = [cell for nm, cell in exe.aux_dict.items()
                      if nm.endswith("k_cache")]
            if not caches:
                raise MXNetError(f"DecodeEngine({name!r}): no KV-cache "
                                 "aux state in the bound graph")
            capacity = caches[0].shape[2]
        self.capacity = int(capacity)
        self._drivers = {
            s: BatchedKVCacheDecoder(self._bm._buckets[s], self.capacity,
                                     slots=s, pos_embed=self.pos_embed)
            for s in self.ladder}

    def _provide_data(self, slots):
        descs = [DataDesc("data", (slots, 1), np.int32)]
        if self.pos_embed == "learned":
            descs.append(DataDesc("pos_ids", (slots, 1), np.float32))
        return descs

    def driver(self, rung):
        """The rung's ``BatchedKVCacheDecoder``."""
        return self._drivers[rung]

    def warmup(self, clock):
        """Run every rung twice (the first step builds and loads the
        kernels and warms the allocator; the second is timed on
        ``clock``), then free every slot and rewind every cursor."""
        for rung in self.ladder:
            drv = self._drivers[rung]
            zeros = np.zeros((rung, 1), np.int32)
            drv.step(zeros).asnumpy()
            t0 = clock.now()
            drv.step(zeros).asnumpy()
            self.exec_est[rung] = max(0.0, clock.now() - t0)
            drv.active[:] = False
            drv.rewind_many(list(range(rung)), [0] * rung)
        return dict(self.exec_est)

    def note_exec(self, rung, seconds):
        prev = self.exec_est.get(rung)
        self.exec_est[rung] = seconds if prev is None else \
            0.7 * prev + 0.3 * seconds

    def migrate(self, src_rung, dst_rung, pairs):
        """Carry live slots between rung pools: for every (src_row,
        dst_row) pair the slot's cache rows and cursor are copied from the
        ``src_rung`` aux cells into ``dst_rung``'s, in place, and the host
        mirrors follow."""
        if src_rung == dst_rung:
            return
        sdrv, ddrv = self._drivers[src_rung], self._drivers[dst_rung]
        s_exe = self._bm._buckets[src_rung]._exec_group.executor
        d_exe = self._bm._buckets[dst_rung]._exec_group.executor
        ddrv.active[:] = False
        if pairs:
            si = np.asarray([p[0] for p in pairs], np.int64)
            di = np.asarray([p[1] for p in pairs], np.int64)
            for nm, cell in s_exe.aux_dict.items():
                src, dst = cell.astorch(), d_exe.aux_dict[nm].astorch()
                dst[torch.as_tensor(di, device=dst.device)] = \
                    src[torch.as_tensor(si, device=src.device)]
            for s_row, d_row in pairs:
                ddrv.pos[d_row] = sdrv.pos[s_row]
                ddrv.active[d_row] = True
        sdrv.active[:] = False


class DecodeScheduler:
    """Iteration-level continuous batching over one ``DecodeEngine``.

    ``submit(prompt)`` admits a sequence (``QueueFullError`` past
    ``MXNET_SERVE_DECODE_MAX_QUEUE``) and returns a streaming
    ``DecodeHandle``. Each iteration retires finished sequences (EOS /
    max-new / deadline / per-slot overflow), admits queued ones into free
    slots (growing the rung when the ladder allows), migrates live slots
    on rung switches, then advances every slot by one token through the
    rung's bound graph and streams the sampled tokens. A prompt is fed one
    token per iteration."""

    def __init__(self, engine, clock=None, max_queue=None,
                 default_max_new=None, logger=None):
        self.engine = engine
        self._clock = clock if clock is not None else MonotonicClock()
        self._max_queue = max_queue if max_queue is not None else \
            _env_int("MXNET_SERVE_DECODE_MAX_QUEUE", 256)
        self._default_max_new = default_max_new if default_max_new \
            is not None else _env_int("MXNET_SERVE_DECODE_MAX_NEW", 64)
        self.logger = logger or log
        # reentrant: completion/token callbacks run with the scheduler
        # lock held and may legitimately submit a follow-up sequence
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._rung = self.engine.ladder.sizes[0]
        self._slots = [None] * self._rung
        self._thread = None
        self._running = False
        self.iterations = 0
        self.migrations = 0
        self._counts = collections.Counter()
        self._latencies = collections.deque(maxlen=4096)
        self._step_seconds = collections.deque(maxlen=4096)
        est = self.engine.warmup(self._clock)
        self.logger.info("decode %r warmed — slot ladder %s, step est %s",
                         self.engine.name, self.engine.ladder.sizes,
                         {r: f"{s * 1e3:.2f}ms" for r, s in est.items()})

    # ------------------------------------------------------------ admission
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, sampling=None, prefix_id=None):
        """Admit one sequence: ``prompt`` is a 1-D int id sequence (1 <=
        len <= cache capacity). ``max_new_tokens`` caps generation
        (``MXNET_SERVE_DECODE_MAX_NEW`` default); ``eos_id`` retires the
        sequence when sampled (not emitted); ``deadline_ms`` (relative to
        now) retires it mid-decode with a partial result; ``sampling`` is
        a ``SamplingParams`` (default greedy). Returns the streaming
        ``DecodeHandle``."""
        if prefix_id is not None:
            raise _not_ported("prefix_id")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise MXNetError("empty prompt")
        if prompt.size > self.engine.capacity:
            raise MXNetError(
                f"prompt of {prompt.size} tokens exceeds the decode "
                f"cache capacity {self.engine.capacity}")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self._default_max_new)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        now = self._clock.now()
        deadline = None if deadline_ms is None \
            else now + deadline_ms / 1000.0
        seq = _Sequence(prompt, max_new, eos_id, now, deadline,
                        sampling=sampling)
        with self._cond:
            if len(self._queue) >= self._max_queue:
                self._counts["rejected"] += 1
                raise QueueFullError(
                    f"decode {self.engine.name!r}: queue depth "
                    f"{len(self._queue)} at MXNET_SERVE_DECODE_"
                    f"MAX_QUEUE={self._max_queue}")
            self._queue.append(seq)
            self._counts["requests"] += 1
            self._cond.notify_all()
        return seq.handle

    # ----------------------------------------------------------- scheduling
    def _active(self):
        return [s for s in self._slots if s is not None]

    def _finish(self, seq, reason=None, error=None, now=None):
        """Complete a sequence's handle and free its slot (caller holds
        the lock)."""
        now = now if now is not None else self._clock.now()
        seq.finish_reason = reason
        if seq.slot is not None:
            self.engine.driver(self._rung).leave(seq.slot)
            self._slots[seq.slot] = None
            seq.slot = None
            self._counts["leaves"] += 1
        self._counts["errors" if error is not None else "responses"] += 1
        if error is None:
            self._latencies.append(max(0.0, now - seq.arrival))
        seq.handle._complete(error=error, now=now)

    def _switch_rung(self, target):
        """Migrate live slots into the ``target`` rung pool, compacting
        them into the lowest rows (caller holds the lock)."""
        pairs = []
        new_slots = [None] * target
        dst = 0
        for row, seq in enumerate(self._slots):
            if seq is None:
                continue
            pairs.append((row, dst))
            seq.slot = dst
            new_slots[dst] = seq
            dst += 1
        self.engine.migrate(self._rung, target, pairs)
        self._rung = target
        self._slots = new_slots
        self.migrations += 1
        self._counts["migrations"] += 1

    def _admit_locked(self, now):
        """Retire expired queued requests, grow the rung if the backlog
        wants it, and fill free slots FIFO."""
        for seq in [s for s in self._queue
                    if s.deadline is not None and now > s.deadline]:
            self._queue.remove(seq)
            self._finish(seq, reason="deadline", now=now)
        if not self._queue:
            return
        want = min(len(self._active()) + len(self._queue),
                   self.engine.ladder.max)
        target = self.engine.ladder.bucket_for(max(want, 1))
        if target is not None and target > self._rung:
            self._switch_rung(target)
        drv = self.engine.driver(self._rung)
        for row in range(self._rung):
            if self._slots[row] is not None or not self._queue:
                continue
            seq = self._queue.pop(0)
            drv.join(row)
            seq.slot = row
            self._slots[row] = seq
            self._counts["joins"] += 1

    def _iterate(self):
        """One scheduling iteration; returns tokens emitted (0 = no work
        was ready)."""
        with self._lock:
            now = self._clock.now()
            # retirement BEFORE dispatch: deadline-expired sequences
            # complete with their partial output; a slot whose next token
            # would overflow its cache slice fails ALONE
            for seq in list(self._active()):
                if seq.deadline is not None and now > seq.deadline:
                    self._finish(seq, reason="deadline", now=now)
            for row in self.engine.driver(self._rung).overflowing():
                seq = self._slots[row]
                if seq is None:          # retired row still advancing
                    continue
                self._finish(seq, error=MXNetError(
                    f"decode {self.engine.name!r}: sequence {seq.id} "
                    f"overflowed its KV-cache slice (slot {row}, "
                    f"capacity {self.engine.capacity}); shorten the "
                    "prompt/max_new_tokens or re-bind with a larger "
                    "capacity"), now=now)
            self._admit_locked(now)
            if not self._active():
                return 0
            # shrink to the smallest rung covering the live set
            target = self.engine.ladder.bucket_for(len(self._active()))
            if target is not None and target < self._rung:
                self._switch_rung(target)
            drv = self.engine.driver(self._rung)
            tokens = np.zeros((self._rung, 1), np.int32)
            meta = []
            for row, seq in enumerate(self._slots):
                if seq is None:
                    continue
                tokens[row, 0] = seq.stream_token(seq.fed)
                meta.append((row, seq))
            t0 = now

        # dispatch outside the lock: submits stay non-blocking while the
        # step runs (only pump()/the dispatch thread iterates)
        logits = drv.step(tokens).asnumpy()        # (rung, 1, V)

        with self._lock:
            end = self._clock.now()
            step_s = max(0.0, end - t0)
            self._step_seconds.append(step_s)
            self.engine.note_exec(self._rung, step_s)
            emitted = 0
            for row, seq in meta:
                if seq.slot is None:
                    continue
                samples = seq.fed + 1 == seq.stream_len()
                tok = sample_token(logits[row, 0], seq.sampling, seq.rng) \
                    if samples else None
                seq.fed += 1
                if not samples:
                    continue              # still feeding the prompt
                if seq.eos_id is not None and tok == seq.eos_id:
                    self._finish(seq, reason="eos", now=end)
                    continue            # EOS retires, not emitted
                seq.generated.append(tok)
                seq.handle._emit(tok)
                emitted += 1
                if len(seq.generated) >= seq.max_new:
                    self._finish(seq, reason="length", now=end)
            # retired rows keep advancing one position per dispatch; pull
            # any at capacity back to 0 so no dispatch writes past a slice
            rew = [row for row in range(self._rung)
                   if self._slots[row] is None and
                   drv.pos[row] + 1 > self.engine.capacity]
            if rew:
                drv.rewind_many(rew, [0] * len(rew))
            self.iterations += 1
            self._counts["iterations"] += 1
            self._counts["tokens"] += emitted
        return max(1, emitted)

    # ----------------------------------------------------------- drive modes
    def _has_work(self):
        return bool(self._queue) or any(s is not None for s in self._slots)

    def pump(self, max_iterations=None):
        """Deterministic drive: run iterations until nothing is active or
        queued (or ``max_iterations``). No thread, no sleeps. Returns the
        iterations run."""
        done = 0
        while max_iterations is None or done < max_iterations:
            with self._lock:
                if not self._has_work():
                    break
            emitted = self._iterate()
            with self._lock:
                if emitted == 0 and not self._queue:
                    break
            done += 1
        return done

    def _loop(self):
        while True:
            with self._cond:
                if not self._running:
                    return
                if not self._has_work():
                    # bounded wait so queued-request deadlines are
                    # noticed; a submit notifies sooner
                    self._cond.wait(timeout=0.05)
                    continue
            self._iterate()

    def start(self):
        """Spawn the decode dispatch thread (idempotent)."""
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet-serve-decode",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the thread; ``drain`` finishes in-flight and queued
        sequences first, else they fail with MXNetError."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if drain:
            self.pump()
        else:
            with self._lock:
                now = self._clock.now()
                for seq in list(self._active()) + self._queue:
                    self._finish(seq, error=MXNetError(
                        "decode scheduler stopped"), now=now)
                self._queue = []

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------------------- stats
    def stats(self):
        """Snapshot: slot occupancy, queue depth, token/iteration
        counters, request latency and step time percentiles (scheduler
        clock), per-rung step estimates."""

        def pct(values):
            if not values:
                return None
            arr = np.asarray(values, np.float64) * 1e3
            return {"p50": float(np.percentile(arr, 50)),
                    "p99": float(np.percentile(arr, 99)),
                    "mean": float(arr.mean())}

        with self._lock:
            n_active = len(self._active())
            counts = dict(self._counts)
            its = counts.get("iterations", 0)
            out = {
                "model": self.engine.name,
                "ladder": self.engine.ladder.sizes,
                "rung": self._rung,
                "active": n_active,
                "occupancy": round(n_active / self._rung, 4),
                "queue_depth": len(self._queue),
                "capacity": self.engine.capacity,
                "tokens_per_iteration":
                    round(counts.get("tokens", 0) / its, 3) if its else None,
                "latency_ms": pct(self._latencies),
                "step_ms": pct(self._step_seconds),
                "exec_est_ms": {str(k): round(s * 1e3, 3) for k, s in
                                sorted(self.engine.exec_est.items())},
            }
            for key in ("requests", "responses", "errors", "rejected",
                        "iterations", "tokens", "joins", "leaves",
                        "migrations"):
                out[key] = counts.get(key, 0)
        return out


def serve_decoder(symbol, arg_params, name="decoder", capacity=None,
                  ladder=None, clock=None, start=True, max_queue=None,
                  default_max_new=None, context=None, logger=None,
                  symbol_gen=None, draft_symbol_gen=None):
    """One-call front end for continuous decode batching:
    ``serve_decoder(decode_symbol, params).submit([ids...])``.

    ``symbol`` is a per-slot decode graph
    (``get_decode_symbol(per_slot=True)``); builds the slot-rung
    ``DecodeEngine`` on ``context`` (default ``gpu(0)``; without CUDA that
    raises unless ``context=mx.cpu()``), warms every rung and, by default,
    starts the dispatch thread — ``start=False`` + ``pump()`` with a
    FakeClock is the deterministic test path. ``symbol_gen`` (chunked
    prefill) and ``draft_symbol_gen`` (speculative decoding) are not
    ported yet and raise."""
    if symbol_gen is not None:
        raise _not_ported("symbol_gen")
    if draft_symbol_gen is not None:
        raise _not_ported("draft_symbol_gen")
    engine = DecodeEngine(name, symbol, arg_params, capacity=capacity,
                          ladder=ladder, context=context, logger=logger)
    sched = DecodeScheduler(engine, clock=clock, max_queue=max_queue,
                            default_max_new=default_max_new, logger=logger)
    if start:
        sched.start()
    return sched
