"""Shared retry policy: exponential backoff + jitter + deadline budget.

The port's copy of ``mxnet_tpu/faults/retry.py``. One retry
implementation for every seam the fault plane hardens — in the port, the
checkpoint writer (``ckpt.write``); the kvstore collective dispatch
(``kvstore.collective``) comes with the multi-process kvstore — instead
of N ad-hoc loops with N different bugs. A :class:`RetryPolicy` is data
(attempt cap, backoff curve, per-sleep cap, deadline budget),
``retry_call`` is the one loop, and both are observable:
``retry.attempts`` / ``retry.retries`` / ``retry.giveups`` counters
labeled by ``site``, plus a ``retry.attempt`` flight-ring record per
retry, so crash reports show exactly how a degraded run limped along.

Policies default from ``MXNET_RETRY_<SITE>`` env vars
(``attempts=3,base=0.05,mult=2,max=2,deadline=30,jitter=0.1``) so
operators can tune a production seam without code.

The ``give_up`` hook is the policy escape hatch: it inspects each
failure and may return a *different* exception to raise immediately
(the JAX package's kvstore turns a collective failure into
``DeadWorkerError`` this way when a peer actually died).
"""
from __future__ import annotations

import os
import random
import time

from ..base import MXNetError
from .. import telemetry as _telemetry

__all__ = ["RetryPolicy", "retry_call"]


def _parse_kv(raw, site):
    out = {}
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise MXNetError(f"MXNET_RETRY_{site}: bad token {tok!r} "
                             "(want key=value)")
        k, _, v = tok.partition("=")
        out[k.strip()] = v.strip()
    return out


class RetryPolicy:
    """Data for one seam's retry behavior.

    attempts : total tries including the first (1 = no retry).
    base_s / multiplier / max_s : exponential backoff curve —
        sleep ``min(max_s, base_s * multiplier**(k-1))`` after the k-th
        failure.
    jitter : +-fraction of each sleep drawn from a private seeded rng
        (decorrelates a fleet retrying in lockstep; seed it for
        deterministic tests).
    deadline_s : total wall-budget across all attempts; when the next
        backoff would overrun it, give up instead.
    retry_on : exception classes worth retrying (everything else
        propagates immediately).
    sleep : injectable sleep (a FakeClock's in tests).
    """

    __slots__ = ("attempts", "base_s", "multiplier", "max_s", "jitter",
                 "deadline_s", "retry_on", "sleep", "_rng")

    def __init__(self, attempts=3, base_s=0.05, multiplier=2.0, max_s=2.0,
                 jitter=0.1, deadline_s=None, retry_on=(Exception,),
                 sleep=time.sleep, seed=None):
        self.attempts = max(1, int(attempts))
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.retry_on = tuple(retry_on)
        self.sleep = sleep
        self._rng = random.Random(seed)

    def backoff(self, failure_count):
        """Sleep seconds after the ``failure_count``-th failure
        (1-based)."""
        d = min(self.max_s,
                self.base_s * self.multiplier ** (failure_count - 1))
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    @classmethod
    def from_env(cls, site, **defaults):
        """Policy for one seam, overridable via ``MXNET_RETRY_<SITE>``
        (e.g. ``MXNET_RETRY_CKPT="attempts=5,base=0.1,deadline=60"``).
        ``defaults`` supply the in-tree per-seam baseline."""
        raw = os.environ.get(f"MXNET_RETRY_{site.upper()}", "")
        kw = dict(defaults)
        if raw:
            keymap = {"attempts": ("attempts", int),
                      "base": ("base_s", float),
                      "mult": ("multiplier", float),
                      "max": ("max_s", float),
                      "deadline": ("deadline_s", float),
                      "jitter": ("jitter", float)}
            for k, v in _parse_kv(raw, site.upper()).items():
                if k not in keymap:
                    raise MXNetError(
                        f"MXNET_RETRY_{site.upper()}: unknown key {k!r} "
                        f"(have: {sorted(keymap)})")
                name, conv = keymap[k]
                try:
                    kw[name] = conv(v)
                except ValueError:
                    raise MXNetError(
                        f"MXNET_RETRY_{site.upper()}: bad value "
                        f"{k}={v!r}")
        return cls(**kw)


def retry_call(fn, policy=None, site="", give_up=None, logger=None):
    """Run ``fn()`` under ``policy``; return its result or raise.

    ``give_up(exc)`` (optional) inspects each retryable failure first:
    returning an exception raises it immediately (chained off the
    original), returning None lets the policy decide. Non-``retry_on``
    exceptions always propagate untouched.
    """
    policy = policy or RetryPolicy()
    start = time.monotonic()
    failures = 0
    while True:
        _telemetry.counter("retry.attempts", site=site).inc()
        try:
            return fn()
        except policy.retry_on as exc:
            failures += 1
            if give_up is not None:
                hard = give_up(exc)
                if hard is not None:
                    _telemetry.counter("retry.giveups", site=site).inc()
                    _telemetry.flightrec.note(
                        "retry.giveup", site=site, failures=failures,
                        converted=type(hard).__name__,
                        error=f"{type(exc).__name__}: {exc}")
                    raise hard from exc
            delay = policy.backoff(failures)
            out_of_budget = (
                policy.deadline_s is not None and
                time.monotonic() - start + delay > policy.deadline_s)
            if failures >= policy.attempts or out_of_budget:
                _telemetry.counter("retry.giveups", site=site).inc()
                _telemetry.flightrec.note(
                    "retry.giveup", site=site, failures=failures,
                    reason="deadline" if out_of_budget else "attempts",
                    error=f"{type(exc).__name__}: {exc}")
                raise
            _telemetry.counter("retry.retries", site=site).inc()
            _telemetry.flightrec.note(
                "retry.attempt", site=site, failures=failures,
                delay_ms=int(delay * 1000),
                error=f"{type(exc).__name__}: {exc}")
            if logger is not None:
                logger.warning(
                    "%s failed (attempt %d/%d): %s — retrying in %.3fs",
                    site or "call", failures, policy.attempts, exc, delay)
            if delay:
                policy.sleep(delay)
