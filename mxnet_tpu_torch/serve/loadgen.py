"""Open-loop load generation: Poisson arrivals + scripted replays.

The port's copy of ``mxnet_tpu/serve/loadgen.py``. Open-loop means
arrivals are scheduled from the arrival process alone — a slow server
does NOT slow the generator down (closed-loop generators hide overload
by self-throttling, so a req/s-at-p99-SLO number is only honest
open-loop). Two generators over one summary:

* ``PoissonLoadGen`` — real-clock Poisson process at ``rate`` req/s
  against a started server;
* ``run_scripted`` — deterministic replay of explicit arrival times
  against a FakeClock server via ``pump()``: zero wall-clock sleeps,
  exact flush/deadline decisions, the tier-1 scheduler gate.

``summarize`` folds completed handles into the req/s + latency
percentile + SLO-attainment dict both paths report.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .batching import QueueFullError

__all__ = ["PoissonLoadGen", "run_scripted", "summarize"]


def summarize(handles, elapsed_s, slo_ms=None):
    """Fold handles into the load-test report dict.

    ``elapsed_s``: generator-side wall (or virtual) span the requests
    were offered over — the req/s denominator. ``slo_ms`` adds
    ``p99_within_slo`` (p99 latency <= SLO).
    """
    done = [h for h in handles if h.done() and h.exception() is None]
    lat = sorted(h.latency for h in done if h.latency is not None)
    misses = sum(1 for h in done if h.missed_deadline())

    def pct(q):
        if not lat:
            return None
        return round(lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3, 3)

    out = {
        "offered": len(handles),
        "completed": len(done),
        "errors": sum(1 for h in handles
                      if h.done() and h.exception() is not None),
        "req_per_sec": round(len(done) / elapsed_s, 2) if elapsed_s else
        None,
        "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                       "p99": pct(0.99),
                       "mean": round(float(np.mean(lat)) * 1e3, 3)
                       if lat else None},
        "deadline_misses": misses,
    }
    if slo_ms is not None:
        out["slo_ms"] = slo_ms
        out["p99_within_slo"] = (out["latency_ms"]["p99"] is not None
                                 and out["latency_ms"]["p99"] <= slo_ms)
    return out


class PoissonLoadGen:
    """Real-clock open-loop Poisson generator against a started server."""

    def __init__(self, server, make_input, model=None, rate=50.0,
                 n_requests=200, deadline_ms=None, seed=0):
        """``make_input(i, rng)`` -> the inputs dict for request i (vary
        row counts here to exercise mixed shapes); ``rate``: mean
        arrivals/second of the exponential inter-arrival draw."""
        if rate <= 0:
            raise MXNetError("rate must be positive")
        self.server = server
        self.make_input = make_input
        self.model = model
        self.rate = float(rate)
        self.n_requests = int(n_requests)
        self.deadline_ms = deadline_ms
        self.seed = seed

    def run(self, slo_ms=None, result_timeout_s=60.0):
        """Offer the full arrival schedule, wait for completions, and
        return ``summarize(...)`` plus the offered-rate bookkeeping."""
        rng = np.random.RandomState(self.seed)
        gaps = rng.exponential(1.0 / self.rate, size=self.n_requests)
        clock = self.server._clock
        t0 = clock.now()
        handles = []
        next_at = t0
        for i in range(self.n_requests):
            next_at += gaps[i]
            clock.sleep(next_at - clock.now())
            try:
                handles.append(self.server.submit(
                    self.make_input(i, rng), model=self.model,
                    deadline_ms=self.deadline_ms))
            except QueueFullError:
                handles.append(None)   # overload: counted as rejected
        offered_span = clock.now() - t0
        live = [h for h in handles if h is not None]
        for h in live:
            h.result(timeout=result_timeout_s)
        out = summarize(live, clock.now() - t0, slo_ms=slo_ms)
        out["rejected"] = sum(1 for h in handles if h is None)
        out["offered_rate_req_s"] = round(
            self.n_requests / offered_span, 2) if offered_span else None
        return out


def run_scripted(server, arrivals, make_input, model=None,
                 deadline_ms=None, slo_ms=None):
    """Deterministic replay: ``arrivals`` are absolute FakeClock times.

    The server must NOT be started — the script advances the clock to
    each arrival, submits, and ``pump()``s, then advances past the last
    deadline and pumps until drained. Everything (flush instants,
    latencies, percentiles) is exact and repeatable.
    """
    clock = server._clock
    if not hasattr(clock, "advance"):
        raise MXNetError("run_scripted needs a FakeClock-driven server")
    handles = []
    t_start = clock.now()
    for i, t in enumerate(sorted(arrivals)):
        if t > clock.now():
            # walk deadline boundaries between now and the arrival so
            # flushes fire at their exact scheduled instants
            while True:
                with server._lock:
                    action, wait = server._registry.next_action(
                        clock.now())
                if action != "wait" or wait is None or \
                        clock.now() + wait > t:
                    break
                clock.advance(wait)
                server.pump()
            clock.advance(max(0.0, t - clock.now()))
        server.pump()
        handles.append(server.submit(
            make_input(i, np.random.RandomState(i)), model=model,
            deadline_ms=deadline_ms))
        server.pump()
    # drain: advance through remaining flush instants
    while any(len(e.queue) for e in server._registry.entries()):
        with server._lock:
            action, wait = server._registry.next_action(clock.now())
        if action == "wait":
            if wait is None:
                raise MXNetError("scripted drain stuck: queued work "
                                 "with no flush deadline")
            clock.advance(wait)
        server.pump()
    return summarize(handles, clock.now() - t_start, slo_ms=slo_ms)
