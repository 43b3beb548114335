"""InferenceServer: the in-process continuous-batching front end.

The port of ``mxnet_tpu/serve/server.py``. ``serve(model).submit({"data":
x})`` is the whole client API: submit returns a thread-safe
``ResponseHandle`` (sync ``result()``, async ``done()``/
``add_done_callback``) and the server's dispatch thread drives
admission queue -> dynamic batch -> the bucket's bound module on the card
-> per-request slices. No sockets: a network listener is a thin adapter
over ``submit``.

Two drive modes:

* ``start()`` — a dispatch thread loops decide/wait/dispatch against
  the real clock (production and the e2e/soak tests);
* ``pump()`` — one explicit scheduling step per call against any clock
  (the deterministic tier-1 path: ``FakeClock`` + scripted arrivals,
  no wall-clock sleeps).

Telemetry (always on — these metrics are the serving product surface;
``stats()`` reads them, under the JAX package's names):

====================================  ======  ==========================
``serve.request.latency.seconds``     hist    admission -> completion,
                                              per model (p50/p99 source)
``serve.batch.exec.seconds``          hist    bucket program execution
``serve.queue.depth``                 gauge   per model + global
``serve.batch.occupancy``             gauge   rows/bucket, last dispatch
``serve.padding.waste``               gauge   cumulative padded-row
                                              fraction, per model
``serve.requests|responses|
  dispatches|rejected|errors``        ctr     per model
``serve.rows|padded_rows``            ctr     occupancy/waste numerators
``serve.deadline.miss``               ctr     completed past deadline
``serve.program_cache.
  compiles_since_warmup``             gauge   MUST stay 0 in steady
                                              state: kernel libraries
                                              built or loaded since
                                              warmup (engine.py)
====================================  ======  ==========================

plus one flight-ring record per dispatch (``serve.dispatch``) so a
crash report shows the recent serving timeline.

A dispatch ends when its outputs are computed: the server synchronizes
the outputs' CUDA device (no copy to the host), so ``serve.batch.exec.
seconds`` and the latencies count the device's work.
"""
from __future__ import annotations

import logging
import os
import threading

import numpy as np
import torch

from .. import faults as _faults
from .. import telemetry as _telemetry
from ..telemetry import trace as _trace
from ..base import MXNetError
from ..faults import CircuitOpenError
from .batching import Request, ShedError, pad_rows, slice_rows
from .clock import MonotonicClock
from .engine import BucketEngine, PredictorEngine, compile_count
from .registry import ModelRegistry

__all__ = ["InferenceServer", "serve"]

log = logging.getLogger(__name__)


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class InferenceServer:
    """Continuous-batching server over a multi-tenant model registry.

    Degradation policy: a per-model circuit breaker
    (``breaker_threshold`` consecutive dispatch failures open it,
    half-open probe after ``breaker_cooldown_ms``) rejects admission
    fast while open, and when queue depth crosses
    ``shed_watermark`` (fraction of ``max_queue``, or an absolute
    count when >= 1) admission first *sheds* already-doomed queued
    requests — those that cannot meet their deadline even if dispatched
    immediately — before deciding; a full queue rejects with a
    ``retry_after_ms`` backpressure hint derived from the exec-time EMA
    and queue depth.
    """

    def __init__(self, clock=None, max_queue=None, default_deadline_ms=None,
                 logger=None, breaker_threshold=None,
                 breaker_cooldown_ms=None, shed_watermark=None):
        self._clock = clock if clock is not None else MonotonicClock()
        self._max_queue = max_queue if max_queue is not None else \
            _env_int("MXNET_SERVE_MAX_QUEUE", 1024)
        self._default_deadline_s = (
            default_deadline_ms if default_deadline_ms is not None
            else _env_int("MXNET_SERVE_DEADLINE_MS", 100)) / 1000.0
        self.logger = logger or log
        threshold = breaker_threshold if breaker_threshold is not None \
            else _env_int("MXNET_SERVE_BREAKER_THRESHOLD", 5)
        cooldown_s = (breaker_cooldown_ms if breaker_cooldown_ms
                      is not None else
                      _env_int("MXNET_SERVE_BREAKER_COOLDOWN_MS",
                               1000)) / 1000.0
        watermark = shed_watermark if shed_watermark is not None else \
            _env_float("MXNET_SERVE_SHED_WATERMARK", 0.75)
        self._shed_depth = int(watermark) if watermark >= 1 else \
            max(1, int(watermark * self._max_queue))
        self._registry = ModelRegistry(self._max_queue,
                                       breaker_threshold=threshold,
                                       breaker_cooldown_s=cooldown_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread = None
        self._running = False
        self._warm_mark = None
        self._slowest = {}      # model -> (trace_id, latency_s)

    # ------------------------------------------------------------- registry
    def register(self, name, model=None, symbol=None, arg_params=None,
                 aux_params=None, data_shapes=None, label_names=None,
                 ladder=None, context=None, compute_dtype=None,
                 predictor=None):
        """Add a model and warm its bucket ladder (bind and run every
        rung) so steady-state serving builds nothing.

        Sources, one of: ``model`` (a bound+initialized Module — symbol,
        params, per-row input shapes and context are extracted), or
        explicit ``symbol`` + ``arg_params``/``aux_params`` +
        ``data_shapes`` (dict input name -> per-ROW shape, no batch dim).
        ``predictor`` (a ``.mxp`` artifact) raises until ``predict.py``
        is ported.
        """
        if predictor is not None:
            engine = PredictorEngine(name, predictor, ladder=ladder)
        else:
            if model is not None:
                if not (model.binded and model.params_initialized):
                    raise MXNetError(
                        f"register({name!r}): the Module must be bound "
                        "with initialized params")
                symbol = model._symbol
                arg_params, aux_params = model.get_params()
                data_shapes = {d.name: tuple(d.shape)[1:]
                               for d in model.data_shapes}
                label_names = label_names or list(model._label_names)
                context = context or model._context[0]
                compute_dtype = compute_dtype or getattr(
                    model, "_compute_dtype", None)
            if symbol is None or data_shapes is None:
                raise MXNetError(
                    f"register({name!r}) needs model=, predictor=, or "
                    "symbol= + params + data_shapes")
            # MXNET_SERVE_QUANTIZE=int8|fp8 defaults every symbol-
            # sourced registration onto the quantized ladder (explicit
            # compute_dtype= wins)
            if compute_dtype is None:
                compute_dtype = os.environ.get(
                    "MXNET_SERVE_QUANTIZE") or None
            engine = BucketEngine(
                name, symbol, arg_params or {}, aux_params or {},
                data_shapes, label_names=label_names or ("softmax_label",),
                ladder=ladder, context=context,
                compute_dtype=compute_dtype, logger=self.logger)

        with _telemetry.span("serve.warmup", model=name):
            est = engine.warmup(self._clock)
        self.logger.info(
            "serve: model %r warmed — ladder %s, %d kernel builds, exec "
            "est %s",
            name, engine.ladder.sizes, engine.warmup_compiles,
            {b: f"{s * 1e3:.2f}ms" for b, s in est.items()})
        self._registry.add(engine)
        # a single int swapped under the GIL; the dispatch thread only
        # subtracts it from a monotone counter for a gauge
        self._warm_mark = compile_count()
        # the serving gauges exist from registration (scrapes before the
        # first request see zeros, not absent series)
        _telemetry.gauge("serve.queue.depth", model=name).set(0)
        _telemetry.gauge("serve.queue.depth").set(self._depth_total())
        _telemetry.gauge(
            "serve.program_cache.compiles_since_warmup").set(0)
        _telemetry.flightrec.note(
            "serve.register", model=name, ladder=list(engine.ladder),
            warmup_compiles=engine.warmup_compiles)
        return engine

    def unregister(self, name):
        """Remove a model, failing its queued requests."""
        entry = self._registry.remove(name)
        entry.queue.fail_all(
            MXNetError(f"model {name!r} unregistered"),
            now=self._clock.now())

    @property
    def models(self):
        return self._registry.names()

    def engine(self, name=None):
        return self._registry.engine(name or self._registry.sole_name())

    # ------------------------------------------------------------ admission
    def submit(self, inputs, model=None, deadline_ms=None, trace=None):
        """Admit one request; returns its ``ResponseHandle``.

        ``inputs``: dict input name -> array with a leading row dim
        (1 <= rows <= the model's largest bucket). ``deadline_ms`` is
        relative to now (default ``MXNET_SERVE_DEADLINE_MS``); the
        scheduler flushes the request's batch no later than
        deadline - estimated bucket execution time.

        ``trace``: record the request's spans into an existing
        ``telemetry.trace.Trace``. Default: a fresh trace per request
        under ``MXNET_TRACE_SAMPLE``.
        """
        name = model or self._registry.sole_name()
        engine = self._registry.engine(name)
        rows, vals = engine.validate(inputs)
        _faults.point("serve.admit", model=name)
        now = self._clock.now()
        deadline_s = (deadline_ms if deadline_ms is not None
                      else self._default_deadline_s * 1000.0) / 1000.0
        tr = trace
        if tr is None and _trace.sample():
            tr = _trace.new_trace()
        req = Request(name, vals, rows, now, now + deadline_s, trace=tr)
        if tr is not None:
            req.root_sid = _trace.next_span_id()
        with self._cond:
            entry = self._registry.entry(name)
            if not entry.breaker.admit_allowed(now):
                # breaker open: reject fast instead of queueing work
                # onto a model that is structurally failing
                _telemetry.counter("serve.rejected", model=name).inc()
                exc = CircuitOpenError(name,
                                       entry.breaker.retry_after(now))
                if tr is not None:
                    # the rejected request still leaves a trace: a
                    # zero-length root span naming the breaker state,
                    # and the ring record carries the trace id so the
                    # rejection is joinable to the trace after the fact
                    exc.trace_id = tr.trace_id
                    _trace.record(
                        tr, "serve.request", now, now,
                        span_id=req.root_sid,
                        model=name, error="circuit_open",
                        breaker=entry.breaker.state)
                _telemetry.flightrec.note(
                    "serve.breaker.reject", model=name,
                    trace=tr.trace_id if tr is not None else None,
                    retry_after_ms=exc.retry_after_ms)
                raise exc
            if len(entry.queue) >= self._shed_depth:
                self._shed_doomed(entry, now)
            try:
                entry.queue.admit(req)
            except MXNetError as exc:
                _telemetry.counter("serve.rejected", model=name).inc()
                exc.retry_after_ms = self._retry_after_ms(entry)
                if tr is not None:
                    exc.trace_id = tr.trace_id
                raise
            depth = len(entry.queue)
            self._cond.notify_all()
        _telemetry.counter("serve.requests", model=name).inc()
        _telemetry.gauge("serve.queue.depth", model=name).set(depth)
        _telemetry.gauge("serve.queue.depth").set(self._depth_total())
        return req.handle

    def _retry_after_ms(self, entry):
        """Backpressure estimate: time to drain the model's queue at
        the measured exec-time EMA of its largest bucket (>= 1ms so a
        zero estimate — e.g. a FakeClock warmup — still signals
        'later, not now')."""
        ladder = entry.engine.ladder
        est = entry.engine.exec_estimate(ladder.max)
        dispatches = max(1, -(-entry.queue.rows_pending // ladder.max))
        return max(1, int(dispatches * est * 1000))

    def _shed_doomed(self, entry, now):
        """Load-shedding pass (caller holds the lock): complete every
        already-doomed queued request with ``ShedError`` so the slots
        go to requests that can still meet their SLO. ``serve.shed``
        counts these, distinct from ``serve.rejected``."""
        name = entry.engine.name
        ladder = entry.engine.ladder

        def est(rows):
            bucket = ladder.bucket_for(min(rows, ladder.max)) or ladder.max
            return entry.engine.exec_estimate(bucket)

        doomed = entry.queue.shed_doomed(now, est)
        if not doomed:
            return
        retry_after = self._retry_after_ms(entry)
        depth = len(entry.queue)
        _telemetry.counter("serve.shed", model=name).inc(len(doomed))
        _telemetry.flightrec.note(
            "serve.shed", model=name, n=len(doomed),
            retry_after_ms=retry_after,
            # the shed decision is joinable to its victims' traces —
            # and each victim's root span (below) carries the queue
            # state that doomed it
            trace_ids=[r.trace.trace_id for r in doomed[:8]
                       if r.trace is not None])
        for r in doomed:
            err = ShedError(
                f"model {name!r}: request {r.id} shed at queue depth "
                f"watermark — deadline unreachable before dispatch")
            err.retry_after_ms = retry_after
            if r.trace is not None:
                err.trace_id = r.trace.trace_id
                _trace.record(
                    r.trace, "serve.queue.wait", r.arrival, now,
                    parent=r.root_sid)
                _trace.record(
                    r.trace, "serve.request", r.arrival, now,
                    span_id=r.root_sid,
                    model=name, rows=r.rows, error="shed",
                    queue_depth=depth, shed_depth=self._shed_depth,
                    retry_after_ms=retry_after)
            r.handle._complete(error=err, now=now)

    def _depth_total(self):
        return sum(len(e.queue) for e in self._registry.entries())

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, name):
        """Drain one dynamic batch for ``name`` and run it. Returns the
        number of requests served (0 if the queue emptied under us)."""
        with self._lock:
            entry = self._registry.entry(name)
            if entry is None:
                return 0
            engine = entry.engine
            # the breaker gates every attempt: open = no dispatch,
            # open-past-cooldown = this drain becomes the half-open probe
            if not entry.breaker.acquire(self._clock.now()):
                return 0
            reqs, rows = entry.queue.drain(engine.ladder.max)
            if not reqs:
                entry.breaker.release()     # probe unused, nothing queued
                return 0
            self._registry.note_dispatch(name)
            depth = len(entry.queue)
        bucket = engine.ladder.bucket_for(rows)
        wait_s = self._clock.now() - min(r.arrival for r in reqs)
        traced = [r for r in reqs if r.trace is not None]
        # batched requests share ONE dispatch span id: the span is
        # mirrored into each member's trace under that member's root,
        # so every request reconstructs alone and batch-mates join on
        # the shared id
        shared_sid = _trace.next_span_id() if traced else None

        # the flush break-even must cover the WHOLE dispatch cost the
        # tail request pays, so t0 starts before batch assembly
        t0 = self._clock.now()
        values = {
            nm: pad_rows(
                np.concatenate([r.inputs[nm] for r in reqs], axis=0)
                if len(reqs) > 1 else reqs[0].inputs[nm], bucket)
            for nm in engine.data_names}
        asm_end = self._clock.now()
        try:
            _faults.point("serve.dispatch", model=name, bucket=bucket)
            outs = engine.forward(bucket, values)
            for dev in {o.astorch().device for o in outs}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        except Exception as exc:    # fail the whole batch, keep serving
            now = self._clock.now()
            entry.breaker.record_failure(now)
            for r in reqs:
                if r.trace is not None:
                    _trace.record(
                        r.trace, "serve.request", r.arrival, now,
                        span_id=r.root_sid,
                        model=name, rows=r.rows, bucket=bucket,
                        error=type(exc).__name__)
                r.handle._complete(error=exc, now=now)
            _telemetry.counter("serve.errors", model=name).inc()
            _telemetry.flightrec.note(
                "serve.dispatch.error", model=name,
                bucket=bucket, error=repr(exc),
                breaker=entry.breaker.state,
                trace_ids=[r.trace.trace_id for r in traced[:8]])
            self.logger.exception("serve: dispatch failed for %r", name)
            return len(reqs)
        entry.breaker.record_success(self._clock.now())
        exec_s = self._clock.now() - t0
        engine.note_exec(bucket, exec_s)
        exec_end = self._clock.now()

        now = self._clock.now()
        off = 0
        misses = 0
        lat_hist = _telemetry.histogram("serve.request.latency.seconds",
                                        model=name)
        for r in reqs:
            r.handle._complete(outputs=slice_rows(outs, off, r.rows),
                               bucket=bucket, now=now)
            off += r.rows
            lat_hist.observe(now - r.arrival,
                             exemplar=r.trace.trace_id
                             if r.trace is not None else None)
            if now > r.deadline:
                misses += 1
        resp_end = self._clock.now()
        for r in traced:
            self._record_request_trace(r, name, bucket, len(reqs),
                                       shared_sid, t0, asm_end,
                                       exec_end, resp_end,
                                       missed=resp_end > r.deadline)

        _telemetry.histogram("serve.batch.exec.seconds",
                             model=name).observe(exec_s)
        _telemetry.counter("serve.responses", model=name).inc(len(reqs))
        _telemetry.counter("serve.dispatches", model=name).inc()
        rows_c = _telemetry.counter("serve.rows", model=name).inc(rows)
        pad_c = _telemetry.counter("serve.padded_rows",
                                   model=name).inc(bucket)
        if misses:
            _telemetry.counter("serve.deadline.miss",
                               model=name).inc(misses)
        _telemetry.gauge("serve.batch.occupancy",
                         model=name).set(rows / bucket)
        _telemetry.gauge("serve.padding.waste", model=name).set(
            1.0 - rows_c.value / pad_c.value if pad_c.value else 0.0)
        _telemetry.gauge("serve.queue.depth", model=name).set(depth)
        _telemetry.gauge("serve.queue.depth").set(self._depth_total())
        compiles = engine.compiles_since_warmup()
        if self._warm_mark is not None:
            _telemetry.gauge(
                "serve.program_cache.compiles_since_warmup").set(
                compile_count() - self._warm_mark)
        _telemetry.flightrec.note(
            "serve.dispatch", model=name, bucket=bucket, rows=rows,
            n_requests=len(reqs), occupancy=round(rows / bucket, 3),
            wait_us=int(wait_s * 1e6), exec_us=int(exec_s * 1e6),
            deadline_misses=misses, compiles_since_warmup=compiles,
            trace_ids=[r.trace.trace_id for r in traced[:8]])
        return len(reqs)

    def _record_request_trace(self, r, name, bucket, n_requests,
                              shared_sid, t0, asm_end, exec_end,
                              resp_end, missed=False):
        """Record one served request's span tree (telemetry.trace):

        ::

            serve.request                arrival -> respond
            ├─ serve.queue.wait          arrival -> drain
            └─ serve.dispatch (shared)   drain   -> exec done
               ├─ serve.assemble         pad / coalesce
               ├─ serve.exec             bucket forward + sync
               └─ serve.respond          slice + complete

        The dispatch span id is shared across the batch; its children
        are mirrored per member trace so each tree stands alone.
        """
        tr = r.trace
        _trace.record(tr, "serve.queue.wait", r.arrival, t0,
                      parent=r.root_sid)
        _trace.record(tr, "serve.dispatch", t0, exec_end,
                      span_id=shared_sid, parent=r.root_sid,
                      bucket=bucket, n_requests=n_requests, shared=True)
        _trace.record(tr, "serve.assemble", t0, asm_end,
                      parent=shared_sid)
        _trace.record(tr, "serve.exec", asm_end, exec_end,
                      parent=shared_sid)
        _trace.record(tr, "serve.respond", exec_end, resp_end,
                      parent=shared_sid)
        _trace.record(tr, "serve.request", r.arrival, resp_end,
                      span_id=r.root_sid, model=name,
                      rows=r.rows, bucket=bucket,
                      deadline_miss=bool(missed))
        # the per-model slowest completed trace (stats() surfaces it);
        # the read-compare-write races the caller-thread stats() reader
        # without the lock
        lat = resp_end - r.arrival
        with self._lock:
            worst = self._slowest.get(name)
            if worst is None or lat > worst[1]:
                self._slowest[name] = (tr.trace_id, lat)

    # ----------------------------------------------------------- drive modes
    def pump(self, max_dispatches=None):
        """Deterministic drive: dispatch every model that is ready at
        the scheduler clock's *now*, without waiting. Returns the number
        of dispatches performed. The explicit alternative to ``start()``
        for FakeClock tests — no thread, no sleeps."""
        done = 0
        while max_dispatches is None or done < max_dispatches:
            with self._lock:
                action, arg = self._registry.next_action(self._clock.now())
            if action != "dispatch":
                break
            self._dispatch(arg)
            done += 1
        return done

    def _loop(self):
        while True:
            with self._cond:
                if not self._running:
                    return
                action, arg = self._registry.next_action(self._clock.now())
                if action == "wait":
                    # bounded by the earliest flush_at; an admission
                    # notify re-evaluates sooner. The condvar waits real
                    # time — production pairs the thread with the real
                    # clock (FakeClock users drive pump() directly).
                    self._cond.wait(timeout=arg)
                    continue
            self._dispatch(arg)

    def start(self):
        """Spawn the dispatch thread (idempotent)."""
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet-serve-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the dispatch thread; ``drain`` serves remaining queued
        requests before returning, else they fail with MXNetError."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if drain:
            while any(len(e.queue) for e in self._registry.entries()):
                for e in self._registry.entries():
                    if len(e.queue):
                        self._dispatch(e.engine.name)
        else:
            now = self._clock.now()
            for e in self._registry.entries():
                e.queue.fail_all(MXNetError("server stopped"), now=now)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------- warm restart
    def checkpoint_to(self, manager, block=True):
        """Warm restarts persist the server through ``serve/warm.py`` and
        ``checkpoint/``, which come with the multi-GPU slice."""
        raise MXNetError(
            "InferenceServer.checkpoint_to: warm restarts (serve/warm.py "
            "over checkpoint/) are not ported yet — they come with the "
            "multi-GPU slice")

    # ---------------------------------------------------------------- stats
    def stats(self):
        """Snapshot for dashboards/bench: per-model p50/p99 latency,
        occupancy, padding waste, queue depth, counters, exec
        estimates; plus the process compile delta since warmup."""
        models = {}
        for e in self._registry.entries():
            name = e.engine.name

            def c(metric):
                m = _telemetry.get_metric(metric, model=name)
                return m.value if m is not None else 0

            h = _telemetry.get_metric("serve.request.latency.seconds",
                                      model=name)
            rows_v, pad_v = c("serve.rows"), c("serve.padded_rows")
            with self._lock:
                worst = self._slowest.get(name)
            slowest = None if worst is None else {
                "trace": worst[0],
                "latency_ms": round(worst[1] * 1e3, 3)}
            models[name] = {
                "requests": c("serve.requests"),
                "responses": c("serve.responses"),
                "dispatches": c("serve.dispatches"),
                "rejected": c("serve.rejected"),
                "shed": c("serve.shed"),
                "errors": c("serve.errors"),
                "breaker": e.breaker.state,
                "deadline_misses": c("serve.deadline.miss"),
                "queue_depth": len(e.queue),
                "latency_ms": None if h is None or not h.count else {
                    "p50": round((h.quantile(0.50) or 0) * 1e3, 3),
                    "p99": round((h.quantile(0.99) or 0) * 1e3, 3),
                    "mean": round(h.mean * 1e3, 3),
                    "max": round((h.max or 0) * 1e3, 3)},
                # exemplars: concrete traces behind the aggregates — a
                # p99 number links to a request you can reconstruct
                # with telemetry.trace.tree()
                "p99_trace": None if h is None else h.exemplar(0.99),
                "slowest_trace": slowest,
                "batch_occupancy": round(rows_v / pad_v, 4)
                if pad_v else None,
                "padding_waste_pct": round(100 * (1 - rows_v / pad_v), 2)
                if pad_v else None,
                "ladder": e.engine.ladder.sizes,
                "exec_est_ms": {b: round(s * 1e3, 3) for b, s in
                                sorted(e.engine.exec_est.items())},
                "programs_resident": e.engine.programs_resident(),
                "quantized": getattr(e.engine, "quantized", None),
            }
        compiles = None
        if self._warm_mark is not None:
            compiles = compile_count() - self._warm_mark
        return {"models": models, "compiles_since_warmup": compiles}


def serve(model, name="default", ladder=None, start=True, clock=None,
          max_queue=None, default_deadline_ms=None, breaker_threshold=None,
          breaker_cooldown_ms=None, shed_watermark=None, **register_kw):
    """One-call front end: ``serve(model).submit({...})``.

    ``model``: a bound+initialized Module (a ``.mxp`` path reaches
    ``PredictorEngine``, which raises until ``predict.py`` is ported).
    Builds a single-model ``InferenceServer``, warms the ladder on the
    Module's context (the card, unless it was bound on ``mx.cpu()``), and
    by default starts the dispatch thread; use ``start=False`` +
    ``pump()`` with a FakeClock for deterministic scheduling.
    ``compute_dtype="int8"``/``"fp8"`` serves the quantized tier.
    """
    server = InferenceServer(clock=clock, max_queue=max_queue,
                             default_deadline_ms=default_deadline_ms,
                             breaker_threshold=breaker_threshold,
                             breaker_cooldown_ms=breaker_cooldown_ms,
                             shed_watermark=shed_watermark)
    if isinstance(model, str):
        server.register(name, predictor=model, ladder=ladder,
                        **register_kw)
    else:
        server.register(name, model=model, ladder=ladder, **register_kw)
    if start:
        server.start()
    return server
