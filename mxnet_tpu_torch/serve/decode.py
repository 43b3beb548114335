"""Continuous decode batching: iteration-level scheduling over a
slot-pooled KV cache.

A KV-cache decoder serves *sequences* — hundreds of single-token steps
carrying device state between them. This module serves up to SLOTS
sequences through one bound graph per iteration:

* ``DecodeEngine`` — a slot-capacity rung ladder (``MXNET_SERVE_DECODE_
  SLOTS``, default ``1,4,8``) over ``get_decode_symbol(per_slot=True)``:
  every rung is a Module bound at ``(slots, 1)``, all sharing ONE set of
  parameter cells through a ``BucketingModule`` leader, each owning its
  ``(slots, H, C, Dh)`` KV-cache pool. ``warmup`` runs every rung and
  window twice (kernels build and load on the first step). Rung switches
  migrate the live slots' cache rows and cursors between pools in place.
* ``DecodeScheduler`` — continuous batching on the ``submit`` seam:
  admission into free slots, per-iteration retirement (EOS / max-new-
  tokens / deadline / per-slot cache overflow — an overflowing slot fails
  ALONE), sampling per request (``SamplingParams``; default greedy), and
  streaming delivery through ``DecodeHandle`` callbacks. Two drive modes:
  ``start()`` (dispatch thread, real clock) and ``pump()`` (explicit
  iterations, FakeClock-deterministic).

Three fast paths ride the same rungs, as in the JAX package:

* **Chunked prefill** — each rung carries an S-token *window* module
  (``MXNET_SERVE_PREFILL_CHUNK``, default 64) beside its S=1 module, bound
  over the same parameter and cache cells, so a T-token prompt prefills in
  ⌈T/S⌉ dispatches instead of T. Slots mid-decode ride a chunk dispatch
  with one real token plus pads and rewind their cursor afterwards.
* **Prefix store** — ``submit(prefix_id=...)`` names a shared prompt
  prefix; the first completion copies its cache rows into a
  ``PrefixStore`` (LRU under ``MXNET_SERVE_PREFIX_CACHE_MB``) and later
  submits *join at cursor C* with the rows written back, bit for bit what
  a cold prefill writes.
* **Speculative decoding** — a draft engine proposes
  ``MXNET_SERVE_SPEC_K`` tokens per iteration (K cheap S=1 dispatches) and
  the target verifies them in ONE S=K window dispatch over the per-slot
  cursors; exact rejection sampling keeps the output distributed as
  target-only decode and identical to it under greedy, and rejected tails
  are rolled back by cursor rewinds on both engines.

Telemetry (the JAX package's names): the ``serve.decode.slots`` /
``active`` / ``occupancy`` / ``queue.depth`` gauges; the
``serve.decode.requests`` / ``responses`` / ``errors`` / ``iterations`` /
``tokens`` / ``joins`` / ``leaves`` / ``migrations`` / ``prefill.chunks``
/ ``prefix.hits`` / ``prefix.misses`` / ``prefix.captures`` /
``spec.proposed`` / ``spec.accepted`` counters; the
``serve.decode.step.seconds`` and ``serve.decode.request.latency.seconds``
histograms; one flight-recorder note per iteration. Every sequence keeps
its own trace (root span ``serve.decode.sequence``, with
``serve.decode.queue.wait``, ``serve.decode.prefix.join``,
``serve.decode.prefill`` per chunk and one shared ``serve.decode.step``
span id per iteration mirrored into every active sequence's trace).
``stats()`` reads the scheduler's own counters.
"""
from __future__ import annotations

import collections
import itertools
import logging
import os
import threading

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..io import DataDesc
from ..telemetry import trace as _trace
from .batching import BucketLadder, QueueFullError
from .clock import MonotonicClock
from .engine import compile_count
from .prefix import PrefixStore
from .sampling import SamplingParams, sample_token, speculative_verify

__all__ = ["DecodeEngine", "DecodeScheduler", "DecodeHandle",
           "default_slot_ladder", "default_prefill_chunk",
           "default_spec_k", "serve_decoder"]

log = logging.getLogger(__name__)

_seq_ids = itertools.count()

_GREEDY = SamplingParams()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_prefill_chunk():
    """``MXNET_SERVE_PREFILL_CHUNK``, default 64: prompt tokens per
    prefill dispatch. 1 disables chunking (token-at-a-time prefill)."""
    return max(1, _env_int("MXNET_SERVE_PREFILL_CHUNK", 64))


def default_spec_k():
    """``MXNET_SERVE_SPEC_K``, default 4: draft tokens proposed (and
    verified in one window dispatch) per speculative iteration."""
    return max(2, _env_int("MXNET_SERVE_SPEC_K", 4))


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
    are written (= the slot's device cursor). An iteration feeds
    ``stream[fed : fed + n]`` in one dispatch and advances ``fed`` by the
    tokens it committed: in steady state ``fed == stream_len() - 1``,
    while prefilling ``stream_len() - fed > 1``."""

    __slots__ = ("id", "prompt", "max_new", "eos_id", "arrival",
                 "deadline", "trace", "root_sid", "handle", "fed",
                 "generated", "slot", "finish_reason", "sampling", "rng",
                 "first_dispatch_at", "prefix_id", "prefix_cold")

    def __init__(self, prompt, max_new, eos_id, arrival, deadline,
                 trace=None, sampling=None, prefix_id=None):
        self.id = next(_seq_ids)
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.arrival = arrival
        self.deadline = deadline          # absolute clock s, or None
        self.trace = trace
        self.root_sid = None
        self.fed = 0
        self.generated = []
        self.slot = None
        self.finish_reason = None
        self.sampling = sampling if sampling is not None else _GREEDY
        self.rng = self.sampling.make_rng()
        self.first_dispatch_at = None     # the first dispatch covering it
        self.prefix_id = prefix_id
        self.prefix_cold = False          # a store miss: capture after prefill
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

    def window(self, n):
        """The next ``n`` stream tokens to feed."""
        return [self.stream_token(self.fed + j) for j in range(n)]


class DecodeHandle:
    """Streaming sync+async result surface for one decode request.

    ``done()``/``result()``/``add_done_callback``/``latency``, plus
    ``add_token_callback(fn)``: ``fn(handle, token, index)`` per generated
    token, already-emitted tokens replayed on registration. ``result()``
    returns the generated ids as int32 numpy (EOS excluded);
    ``finish_reason`` is ``"eos"``, ``"length"``, ``"deadline"`` or None
    when the sequence errored (``exception()`` carries it). ``ttft`` is
    submit to first token (queue wait included), ``ttft_exec`` first
    dispatch to first token (the prefill the engine paid)."""

    def __init__(self, request):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._done_callbacks = []
        self._token_callbacks = []
        self._tokens = []
        self._error = None
        self.request = request
        self.completed_at = None        # scheduler-clock seconds
        self.first_token_at = None

    def done(self):
        return self._event.is_set()

    @property
    def trace_id(self):
        tr = self.request.trace
        return tr.trace_id if tr is not None else None

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

    @property
    def ttft(self):
        """Submit-to-first-token seconds, queue wait included (None before
        the first token)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.request.arrival

    @property
    def ttft_exec(self):
        """First-dispatch-to-first-token seconds: the prefill cost the
        engine paid, queue wait excluded."""
        if self.first_token_at is None or \
                self.request.first_dispatch_at is None:
            return None
        return self.first_token_at - self.request.first_dispatch_at

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

    def _emit(self, token, now=None):
        with self._lock:
            index = len(self._tokens)
            self._tokens.append(int(token))
            cbs = list(self._token_callbacks)
        if index == 0:
            self.first_token_at = now
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
    ``context`` (default: the current context, ``gpu(0)``).

    ``symbol_gen`` (``step_len -> symbol``, e.g. ``lambda s:
    get_decode_symbol(per_slot=True, step_len=s)``) arms the S>1 window
    modules: for every ``window_lens`` entry W > 1 (clamped to the
    capacity) each rung gets a Module over ``symbol_gen(W)`` bound with
    ``shared_module=`` the rung's S=1 module, so that its parameter AND
    cache/cursor cells are the rung's own — the engine checks every aux
    cell is shared.

    ``compute_dtype="bfloat16"`` or ``"float16"`` serves in mixed
    precision, as the JAX package's engine does: every rung and window
    Module casts the parameters and caches to the compute dtype where the
    graph reads them (the executor's cast layer), the decode kernels run
    their instances of that dtype and the logits come back in it."""

    def __init__(self, name, symbol, arg_params, aux_params=None,
                 capacity=None, ladder=None, context=None,
                 compute_dtype=None, logger=None, symbol_gen=None,
                 window_lens=()):
        from ..context import current_context
        from ..models.transformer import BatchedKVCacheDecoder
        from ..module import BucketingModule

        self.name = name
        self.ladder = ladder if isinstance(ladder, BucketLadder) \
            else BucketLadder(ladder if ladder is not None
                              else default_slot_ladder())
        self.exec_est = {}      # rung or (rung, S) -> EMA'd step seconds
        self._warm_mark = None
        self.warmup_compiles = None
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
        if compute_dtype is not None:
            self._bm._module_kwargs["compute_dtype"] = compute_dtype
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

        self.window_lens = sorted(
            {min(int(w), self.capacity) for w in (window_lens or ())}
            - {0, 1})
        self._window_mods = {}               # (rung, S) -> Module
        if self.window_lens:
            if symbol_gen is None:
                raise MXNetError(
                    f"DecodeEngine({name!r}): window_lens="
                    f"{self.window_lens} needs symbol_gen= (a "
                    "step_len -> per-slot decode symbol factory)")
            self._build_windows(symbol_gen, compute_dtype, logger or log)

    def _build_windows(self, symbol_gen, compute_dtype, logger):
        from ..module import Module
        for rung in self.ladder:
            base = self._bm._buckets[rung]
            b_exe = base._exec_group.executor
            for S in self.window_lens:
                mod = Module(symbol_gen(S), data_names=list(self.data_names),
                             label_names=[], logger=logger,
                             context=self._context,
                             compute_dtype=compute_dtype)
                mod.bind(self._provide_data(rung, S), label_shapes=None,
                         for_training=False, shared_module=base)
                w_exe = mod._exec_group.executor
                for nm, cell in w_exe.aux_dict.items():
                    if b_exe.aux_dict.get(nm) is not cell:
                        raise MXNetError(
                            f"DecodeEngine({self.name!r}): window "
                            f"step_len={S} did not share aux cell {nm!r} "
                            f"with the rung-{rung} decode module — "
                            "symbol_gen must rebuild the SAME graph (names, "
                            "capacity, cache dtype) at another step_len")
                self._drivers[rung].add_window(S, mod)
                self._window_mods[(rung, S)] = mod

    def _provide_data(self, slots, step=1):
        descs = [DataDesc("data", (slots, step), np.int32)]
        if self.pos_embed == "learned":
            descs.append(DataDesc("pos_ids", (slots, step), np.float32))
        return descs

    def driver(self, rung):
        """The rung's ``BatchedKVCacheDecoder``."""
        return self._drivers[rung]

    def warmup(self, clock):
        """Run every rung's S=1 module and every window module twice (the
        first step builds and loads the kernels and warms the allocator;
        the second is timed on ``clock``), then free every slot and rewind
        every cursor. Records the kernel libraries warmup loaded."""
        mark = compile_count()
        for rung in self.ladder:
            drv = self._drivers[rung]
            zeros = np.zeros((rung, 1), np.int32)
            drv.step(zeros).asnumpy()
            t0 = clock.now()
            drv.step(zeros).asnumpy()
            self.exec_est[rung] = max(0.0, clock.now() - t0)
            for S in drv.window_lens:
                wz = np.zeros((rung, S), np.int32)
                drv.rewind_many(list(range(rung)), [0] * rung)
                drv.step(wz).asnumpy()
                drv.rewind_many(list(range(rung)), [0] * rung)
                t0 = clock.now()
                drv.step(wz).asnumpy()
                self.exec_est[(rung, S)] = max(0.0, clock.now() - t0)
            drv.active[:] = False
            drv.rewind_many(list(range(rung)), [0] * rung)
        self._warm_mark = compile_count()
        self.warmup_compiles = self._warm_mark - mark
        return dict(self.exec_est)

    def note_exec(self, key, seconds):
        prev = self.exec_est.get(key)
        self.exec_est[key] = seconds if prev is None else \
            0.7 * prev + 0.3 * seconds

    def compiles_since_warmup(self):
        """Kernel libraries built or loaded since warmup (0 in steady
        state), or None before warmup."""
        if self._warm_mark is None:
            return None
        return compile_count() - self._warm_mark

    def migrate(self, src_rung, dst_rung, pairs):
        """Carry live slots between rung pools: for every (src_row,
        dst_row) pair the slot's cache rows and cursor are copied from the
        ``src_rung`` aux cells into ``dst_rung``'s, in place (as bytes, so
        fp8 cells copy as float32 ones do), and the host mirrors follow."""
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
                src = cell.astorch().view(torch.uint8)
                dst = d_exe.aux_dict[nm].astorch().view(torch.uint8)
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
    on rung switches, then advances every slot through the rung's modules
    and streams the sampled tokens.

    Fast paths, each armed only when its modules were built with the
    engine: ``prefill_chunk`` S>1 window dispatches while any slot is
    prefilling (decoding slots ride along with one real token plus pads
    and rewind after); ``draft_engine`` + ``spec_k`` speculative
    iterations when every active slot is in steady state (K draft
    proposals, one S=K target verify, exact rejection, cursor rollback on
    both engines); ``prefix_store`` joins at cursor C on
    ``submit(prefix_id=...)`` hits and captures cold prefixes when their
    prefill completes."""

    def __init__(self, engine, clock=None, max_queue=None,
                 default_max_new=None, logger=None, draft_engine=None,
                 prefill_chunk=None, spec_k=None, prefix_store=None):
        self.engine = engine
        self.draft = draft_engine
        self._clock = clock if clock is not None else MonotonicClock()
        self._max_queue = max_queue if max_queue is not None else \
            _env_int("MXNET_SERVE_DECODE_MAX_QUEUE", 256)
        self._default_max_new = default_max_new if default_max_new \
            is not None else _env_int("MXNET_SERVE_DECODE_MAX_NEW", 64)
        self.logger = logger or log

        if self.draft is not None:
            if list(self.draft.ladder.sizes) != list(engine.ladder.sizes):
                raise MXNetError(
                    f"draft engine ladder {self.draft.ladder.sizes} must "
                    f"match the target's {engine.ladder.sizes} (slots "
                    "mirror 1:1)")
            if self.draft.capacity < engine.capacity:
                raise MXNetError(
                    f"draft cache capacity {self.draft.capacity} < target "
                    f"capacity {engine.capacity}: the draft tracks the "
                    "same stream")
        chunk = int(prefill_chunk if prefill_chunk is not None
                    else default_prefill_chunk())
        chunk = min(chunk, engine.capacity)
        usable = set(engine.window_lens)
        if self.draft is not None:
            usable &= set(self.draft.window_lens)
        self.prefill_chunk = chunk if chunk > 1 and chunk in usable else 1
        k = int(spec_k if spec_k is not None else default_spec_k())
        self.spec_k = 0
        if self.draft is not None:
            if k < 2 or k not in set(engine.window_lens):
                raise MXNetError(
                    f"speculative decoding armed (draft engine given) but "
                    f"the target has no step_len={k} verify window "
                    f"(windows: {engine.window_lens}); build the engine "
                    "with spec_k in window_lens")
            self.spec_k = k
        self.prefix_store = prefix_store
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0

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
        # the draft first: the target's post-warmup mark is the one
        # stats() reports, so it is taken last
        if self.draft is not None:
            with _telemetry.span("serve.decode.warmup",
                                 model=self.draft.name):
                self.draft.warmup(self._clock)
        with _telemetry.span("serve.decode.warmup", model=self.engine.name):
            est = self.engine.warmup(self._clock)
        if self.draft is not None:
            self.draft._warm_mark = compile_count()
        self.logger.info(
            "decode %r warmed — slot ladder %s, windows %s, %d kernel "
            "libraries loaded, step est %s", self.engine.name,
            self.engine.ladder.sizes, self.engine.window_lens,
            self.engine.warmup_compiles,
            {str(r): f"{s * 1e3:.2f}ms" for r, s in est.items()})
        self._gauge("slots").set(self._rung)
        self._gauge("active").set(0)
        self._gauge("occupancy").set(0.0)
        self._gauge("queue.depth").set(0)

    def _gauge(self, key):
        return _telemetry.gauge(f"serve.decode.{key}",
                                model=self.engine.name)

    def _count(self, key, n=1):
        """Add ``n`` to the scheduler's own counter ``key`` (``stats()``)
        and to the ``serve.decode.<key>`` telemetry counter."""
        self._counts[key] += n
        _telemetry.counter(f"serve.decode.{key}",
                           model=self.engine.name).inc(n)

    # ------------------------------------------------------------ admission
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, trace=None, sampling=None, prefix_id=None):
        """Admit one sequence: ``prompt`` is a 1-D int id sequence (1 <=
        len <= cache capacity). ``max_new_tokens`` caps generation
        (``MXNET_SERVE_DECODE_MAX_NEW`` default); ``eos_id`` retires the
        sequence when sampled (not emitted); ``deadline_ms`` (relative to
        now) retires it mid-decode with a partial result; ``sampling`` is
        a ``SamplingParams`` (default greedy); ``prefix_id`` names a
        shared prompt prefix for the prefix store (a hit joins at cursor C
        with the stored rows, a miss prefills cold and stores the prompt's
        rows). Returns the streaming ``DecodeHandle``."""
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
        tr = trace
        if tr is None and _trace.sample():
            tr = _trace.new_trace()
        seq = _Sequence(prompt, max_new, eos_id, now, deadline, trace=tr,
                        sampling=sampling, prefix_id=prefix_id)
        if tr is not None:
            seq.root_sid = _trace.next_span_id()
            if tr.root is None:
                tr.root = seq.root_sid
        with self._cond:
            if len(self._queue) >= self._max_queue:
                self._counts["rejected"] += 1
                exc = QueueFullError(
                    f"decode {self.engine.name!r}: queue depth "
                    f"{len(self._queue)} at MXNET_SERVE_DECODE_"
                    f"MAX_QUEUE={self._max_queue}")
                if tr is not None:
                    exc.trace_id = tr.trace_id
                _telemetry.counter("serve.rejected",
                                   model=self.engine.name).inc()
                raise exc
            self._queue.append(seq)
            depth = len(self._queue)
            self._count("requests")
            self._cond.notify_all()
        self._gauge("queue.depth").set(depth)
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
            if self.draft is not None:
                self.draft.driver(self._rung).leave(seq.slot)
            self._slots[seq.slot] = None
            seq.slot = None
            self._count("leaves")
        if seq.trace is not None:
            _trace.record(
                seq.trace, "serve.decode.sequence", seq.arrival, now,
                span_id=seq.root_sid, model=self.engine.name,
                prompt=len(seq.prompt), generated=len(seq.generated),
                finish=reason if error is None else type(error).__name__)
            if error is not None:
                error.trace_id = seq.trace.trace_id
        self._count("errors" if error is not None else "responses")
        if error is None:
            latency = max(0.0, now - seq.arrival)
            self._latencies.append(latency)
            _telemetry.histogram(
                "serve.decode.request.latency.seconds",
                model=self.engine.name).observe(
                latency, exemplar=seq.trace.trace_id
                if seq.trace is not None else None)
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
        if self.draft is not None:
            self.draft.migrate(self._rung, target, pairs)
        self._rung = target
        self._slots = new_slots
        self.migrations += 1
        self._count("migrations")
        self._gauge("slots").set(target)

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
            if self.draft is not None:
                self.draft.driver(self._rung).join(row)
            seq.slot = row
            self._slots[row] = seq
            self._count("joins")
            if seq.prefix_id is not None and self.prefix_store is not None:
                self._prefix_admit(row, seq, now)
            if seq.trace is not None:
                _trace.record(seq.trace, "serve.decode.queue.wait",
                              seq.arrival, now, parent=seq.root_sid,
                              slot=row)

    def _prefix_admit(self, row, seq, now):
        """Prefix-store hit test for a freshly joined sequence: on a hit
        the stored rows are written into its slot and its cursor set to C,
        so prefill starts at the first unshared token; a miss marks it
        cold, and its prompt rows are captured the iteration its prefill
        completes."""
        tags = ("target", "draft") if self.draft is not None \
            else ("target",)
        c, entry = self.prefix_store.lookup(seq.prefix_id, seq.prompt,
                                            tags=tags)
        if entry is None:
            seq.prefix_cold = True
            self._count("prefix.misses")
            return
        engines = [("target", self.engine)] + (
            [("draft", self.draft)] if self.draft is not None else [])
        for tag, eng in engines:
            drv = eng.driver(self._rung)
            drv.restore_rows(row, {nm: r[:, :c] for nm, r in
                                   entry.payloads[tag].items()})
            drv.rewind(row, c)
        seq.fed = c
        self._count("prefix.hits")
        if seq.trace is not None:
            _trace.record(seq.trace, "serve.decode.prefix.join", now, now,
                          parent=seq.root_sid, slot=row, cursor=c)

    def _plan_dispatch(self):
        """This iteration's dispatch (caller holds the lock):
        ``("window", S)`` — every active slot feeds up to S stream tokens
        (S = the prefill chunk while anyone prefills and every live cursor
        has room, else 1) — or ``("spec", K)`` when speculation is armed
        and every active slot is in steady state with K positions of room
        on both engines."""
        drv = self.engine.driver(self._rung)
        ddrv = self.draft.driver(self._rung) if self.draft else None
        if any(s.remaining() > 1 for s in self._active()):
            S = self.prefill_chunk
            if S > 1 and not drv.overflowing(S) and \
                    (ddrv is None or not ddrv.overflowing(S)):
                return "window", S
            return "window", 1
        if self.spec_k and ddrv is not None and \
                not drv.overflowing(self.spec_k) and \
                not ddrv.overflowing(self.spec_k):
            return "spec", self.spec_k
        return "window", 1

    def _dispatch_spec(self, drv, ddrv, base_tokens, meta, K):
        """One speculative iteration's device work (outside the lock):
        K draft S=1 dispatches propose ``d_1..d_K`` per slot, then ONE
        target S=K window dispatch over ``[t, d_1..d_{K-1}]`` at each
        slot's own cursor gives the target distribution at every proposed
        position (row j verifies ``d_{j+1}``). Returns ``{row: (accepted,
        tokens)}`` from exact rejection sampling."""
        rung = base_tokens.shape[0]
        proposals = np.zeros((rung, K), np.int64)
        draft_rows = {row: [] for row, _seq in meta}
        feed = base_tokens.copy()
        for j in range(K):
            dlog = ddrv.step(feed).asnumpy()         # (rung, 1, V)
            feed = np.zeros((rung, 1), np.int32)
            for row, seq in meta:
                d = sample_token(dlog[row, 0], seq.sampling, seq.rng)
                proposals[row, j] = d
                draft_rows[row].append(dlog[row, 0])
                feed[row, 0] = d
        window = np.zeros((rung, K), np.int32)
        window[:, 0] = base_tokens[:, 0]
        window[:, 1:] = proposals[:, :K - 1]
        vlog = drv.step(window).asnumpy()            # (rung, K, V)
        return {row: speculative_verify(vlog[row], np.asarray(draft_rows[row]),
                                        proposals[row], seq.sampling, seq.rng)
                for row, seq in meta}

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
            active = self._active()
            if not active:
                self._gauge("active").set(0)
                self._gauge("occupancy").set(0.0)
                return 0
            # shrink to the smallest rung covering the live set
            target = self.engine.ladder.bucket_for(len(active))
            if target is not None and target < self._rung:
                self._switch_rung(target)
            drv = self.engine.driver(self._rung)
            ddrv = self.draft.driver(self._rung) if self.draft else None
            mode, S = self._plan_dispatch()
            meta = []                    # (row, seq[, n fed]) per slot
            width = 1 if mode == "spec" else S
            tokens = np.zeros((self._rung, width), np.int32)
            for row, seq in enumerate(self._slots):
                if seq is None:
                    continue
                if mode == "spec":
                    tokens[row, 0] = seq.stream_token(seq.fed)
                    meta.append((row, seq))
                else:
                    n = min(S, seq.remaining())
                    tokens[row, :n] = seq.window(n)
                    meta.append((row, seq, n))
                if seq.first_dispatch_at is None:
                    seq.first_dispatch_at = now
            shared_sid = _trace.next_span_id() \
                if any(s.trace is not None for s in active) else None
            n_before = len(active)
            t0 = now

        # dispatch outside the lock: submits stay non-blocking while the
        # step runs (only pump()/the dispatch thread iterates)
        if mode == "spec":
            verdicts = self._dispatch_spec(drv, ddrv, tokens, meta, S)
        else:
            logits = drv.step(tokens).asnumpy()        # (rung, S, V)
            if ddrv is not None:
                # the draft shadows every non-speculative dispatch so its
                # cache tracks the same stream positions
                ddrv.step(tokens).asnumpy()

        with self._lock:
            end = self._clock.now()
            step_s = max(0.0, end - t0)
            self._step_seconds.append(step_s)
            self.engine.note_exec(self._rung if S == 1 else (self._rung, S),
                                  step_s)
            rew_rows, rew_pos = [], []
            if mode == "spec":
                emitted = self._commit_spec(meta, verdicts, S, t0, end,
                                            shared_sid, rew_rows, rew_pos)
            else:
                emitted = self._commit_window(
                    meta, logits, S, t0, end, shared_sid, n_before,
                    rew_rows, rew_pos)
            # retired rows keep advancing one window per dispatch; pull
            # any nearing capacity back to 0 so no dispatch writes a
            # clamped window for a row nobody owns
            maxw = max([1] + list(drv.window_lens))
            seen = set(rew_rows)
            for row in range(self._rung):
                if self._slots[row] is None and row not in seen and \
                        drv.pos[row] + maxw > self.engine.capacity:
                    rew_rows.append(row)
                    rew_pos.append(0)
            if rew_rows:
                drv.rewind_many(rew_rows, rew_pos)
                if ddrv is not None:
                    ddrv.rewind_many(rew_rows, rew_pos)
            self.iterations += 1
            n_active = len(self._active())
            self._count("iterations")
            if emitted:
                self._count("tokens", emitted)
            _telemetry.histogram("serve.decode.step.seconds",
                                 model=self.engine.name).observe(step_s)
            self._gauge("active").set(n_active)
            self._gauge("occupancy").set(n_active / self._rung)
            self._gauge("queue.depth").set(len(self._queue))
            _telemetry.flightrec.note(
                "serve.decode.step", model=self.engine.name,
                rung=self._rung, active=n_active, emitted=emitted,
                step_us=int(step_s * 1e6), mode=mode, window=S,
                compiles_since_warmup=self.engine.compiles_since_warmup())
        return max(1, emitted)

    def _commit_window(self, meta, logits, S, t0, end, shared_sid,
                       n_active, rew_rows, rew_pos):
        """Apply one window dispatch (caller holds the lock): each slot
        commits the ``n`` tokens it fed, samples when its window reached
        the end of its stream, and rewinds when it fed fewer than S."""
        emitted = chunks = 0
        for row, seq, n in meta:
            if seq.slot is None:
                continue
            prefilling = seq.remaining() > 1
            samples = seq.fed + n == seq.stream_len()
            if seq.trace is not None:
                _trace.record(seq.trace, "serve.decode.step", t0, end,
                              span_id=shared_sid, parent=seq.root_sid,
                              rung=self._rung, n_active=n_active,
                              shared=True, pos=seq.fed, window=n)
                if prefilling:
                    _trace.record(seq.trace, "serve.decode.prefill", t0,
                                  end, parent=seq.root_sid, pos=seq.fed,
                                  tokens=n, chunk=S)
            chunks += prefilling
            tok = sample_token(logits[row, n - 1], seq.sampling, seq.rng) \
                if samples else None
            seq.fed += n
            if n < S:
                # the dispatch advanced the cursor by S: pull it back to
                # the stream position actually fed
                rew_rows.append(row)
                rew_pos.append(seq.fed)
            self._capture_prefix(seq)
            if not samples:
                continue                  # still prefilling
            if seq.eos_id is not None and tok == seq.eos_id:
                self._finish(seq, reason="eos", now=end)
                continue                  # EOS retires, not emitted
            seq.generated.append(tok)
            seq.handle._emit(tok, now=end)
            emitted += 1
            if len(seq.generated) >= seq.max_new:
                self._finish(seq, reason="length", now=end)
        if chunks:
            self._count("prefill.chunks", chunks)
        return emitted

    def _commit_spec(self, meta, verdicts, K, t0, end, shared_sid,
                     rew_rows, rew_pos):
        """Apply one speculative iteration's verdicts (caller holds the
        lock): commit each slot's accepted prefix plus its rejection
        sample, stream the tokens, roll the cursor back over the rejected
        tail (both engines, through the caller's rewinds), retire on EOS
        or max-new inside the window (tokens past the stop are
        dropped)."""
        emitted = 0
        for row, seq in meta:
            if seq.slot is None:
                continue
            accepted, toks = verdicts[row]
            self.spec_proposed += K
            self.spec_accepted += accepted
            if accepted < K:
                self.spec_rollbacks += 1
            committed = 0
            finish = None
            for tok in toks:
                if seq.eos_id is not None and tok == seq.eos_id:
                    finish = "eos"
                    break
                seq.generated.append(int(tok))
                seq.handle._emit(int(tok), now=end)
                emitted += 1
                committed += 1
                if len(seq.generated) >= seq.max_new:
                    finish = "length"
                    break
            seq.fed += committed
            if committed < K:
                rew_rows.append(row)
                rew_pos.append(seq.fed)
            if seq.trace is not None:
                _trace.record(seq.trace, "serve.decode.step", t0, end,
                              span_id=shared_sid, parent=seq.root_sid,
                              rung=self._rung, shared=True, pos=seq.fed,
                              spec_k=K, accepted=accepted,
                              committed=committed)
            if finish is not None:
                self._finish(seq, reason=finish, now=end)
        self._count("spec.proposed", K * len(meta))
        accepted_now = sum(verdicts[r][0] for r, _ in meta)
        if accepted_now:
            self._count("spec.accepted", accepted_now)
        return emitted

    def _capture_prefix(self, seq):
        """Store a cold prefix the moment its prefill completes (caller
        holds the lock): the slot's first ``len(prompt)`` cache positions
        on the target (and the draft, when armed) with the token ids they
        encode."""
        if not seq.prefix_cold or self.prefix_store is None or \
                seq.slot is None or seq.fed < len(seq.prompt):
            return
        payloads = {"target": self.engine.driver(self._rung)
                    .capture_rows(seq.slot, len(seq.prompt))}
        if self.draft is not None:
            payloads["draft"] = self.draft.driver(self._rung) \
                .capture_rows(seq.slot, len(seq.prompt))
        stored = self.prefix_store.put(
            seq.prefix_id, np.asarray(seq.prompt, np.int64), payloads)
        seq.prefix_cold = False
        if stored:
            self._count("prefix.captures")

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
        clock), per-rung and per-window step estimates, kernel libraries
        loaded since warmup, and the ``spec`` / ``prefix`` sections when
        those paths are armed."""

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
            # exec_est keys mix rungs and (rung, window) pairs: "8", "8xS64"
            exec_est = {
                (f"{k[0]}xS{k[1]}" if isinstance(k, tuple) else str(k)):
                round(s * 1e3, 3) for k, s in self.engine.exec_est.items()}
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
                "exec_est_ms": dict(sorted(exec_est.items())),
                "prefill_chunk": self.prefill_chunk,
                "compiles_since_warmup": self.engine.compiles_since_warmup(),
            }
            for key in ("requests", "responses", "errors", "rejected",
                        "iterations", "tokens", "joins", "leaves",
                        "migrations"):
                out[key] = counts.get(key, 0)
            out["prefill_chunks"] = counts.get("prefill.chunks", 0)
            if self.spec_k:
                out["spec"] = {
                    "k": self.spec_k,
                    "proposed": self.spec_proposed,
                    "accepted": self.spec_accepted,
                    "rollbacks": self.spec_rollbacks,
                    "acceptance": round(self.spec_accepted /
                                        self.spec_proposed, 4)
                    if self.spec_proposed else None,
                }
            if self.prefix_store is not None:
                out["prefix"] = self.prefix_store.stats()
        return out


def serve_decoder(symbol, arg_params, name="decoder", capacity=None,
                  ladder=None, clock=None, start=True, max_queue=None,
                  default_max_new=None, context=None, compute_dtype=None,
                  logger=None, symbol_gen=None, prefill_chunk=None,
                  draft_symbol_gen=None, draft_params=None, spec_k=None,
                  prefix_cache_mb=None):
    """One-call front end for continuous decode batching:
    ``serve_decoder(decode_symbol, params).submit([ids...])``.

    ``symbol`` is a per-slot decode graph
    (``get_decode_symbol(per_slot=True)``); builds the slot-rung
    ``DecodeEngine`` on ``context`` (default ``gpu(0)``; without CUDA that
    raises unless ``context=mx.cpu()``), warms every rung and, by default,
    starts the dispatch thread — ``start=False`` + ``pump()`` with a
    FakeClock is the deterministic test path. ``compute_dtype=
    "bfloat16"`` or ``"float16"`` serves in mixed precision (target and
    draft alike).

    Fast paths, as in the JAX package:

    * ``symbol_gen`` — ``symbol_gen(step_len) -> Symbol`` of the SAME
      model arms chunked prefill (window S = ``prefill_chunk`` /
      ``MXNET_SERVE_PREFILL_CHUNK``, default 64): a T-token prompt lands in
      ⌈T/S⌉ dispatches instead of T;
    * ``draft_symbol_gen`` / ``draft_params`` — a small draft LM (same
      generator signature) arms speculative decoding with ``spec_k`` /
      ``MXNET_SERVE_SPEC_K`` (default 4) proposals per verify dispatch;
    * ``prefix_cache_mb`` (default ``MXNET_SERVE_PREFIX_CACHE_MB``, 64) —
      the prefix store's byte budget for ``submit(prefix_id=...)``; 0
      turns the store off."""
    window_lens = set()
    chunk = default_prefill_chunk() if prefill_chunk is None \
        else int(prefill_chunk)
    if symbol_gen is not None and chunk > 1:
        window_lens.add(chunk)
    k = default_spec_k() if spec_k is None else int(spec_k)
    draft_engine = None
    if draft_symbol_gen is not None:
        if draft_params is None:
            raise MXNetError("serve_decoder: draft_symbol_gen needs "
                             "draft_params")
        if symbol_gen is None:
            raise MXNetError(
                "serve_decoder: speculative decoding needs symbol_gen= too "
                "— the target verifies K proposals in one step_len=K "
                "window dispatch")
        window_lens.add(k)
    engine = DecodeEngine(name, symbol, arg_params, capacity=capacity,
                          ladder=ladder, context=context,
                          compute_dtype=compute_dtype, logger=logger,
                          symbol_gen=symbol_gen, window_lens=window_lens)
    if draft_symbol_gen is not None:
        draft_engine = DecodeEngine(
            name + ".draft", draft_symbol_gen(1), draft_params,
            capacity=engine.capacity, ladder=engine.ladder.sizes,
            context=context, compute_dtype=compute_dtype, logger=logger,
            symbol_gen=draft_symbol_gen, window_lens=window_lens)
    budget = None if prefix_cache_mb is None \
        else int(float(prefix_cache_mb) * (1 << 20))
    store = None
    if budget is None or budget > 0:
        store = PrefixStore(budget_bytes=budget)
        if store.budget_bytes <= 0:
            store = None
    sched = DecodeScheduler(engine, clock=clock, max_queue=max_queue,
                            default_max_new=default_max_new, logger=logger,
                            draft_engine=draft_engine, prefill_chunk=chunk,
                            spec_k=k if draft_engine is not None else None,
                            prefix_store=store)
    if start:
        sched.start()
    return sched
