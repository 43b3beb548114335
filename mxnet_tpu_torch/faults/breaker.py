"""Circuit breaker: consecutive failures -> open -> half-open probe.

The port's copy of ``mxnet_tpu/faults/breaker.py``, the serving
registry's per-model degradation primitive: ``threshold`` consecutive
failures trip the breaker OPEN; while open, work is rejected fast with a
retry-after hint. After ``cooldown_s`` exactly one probe goes through
(HALF-OPEN); its success closes the circuit, its failure re-opens it.

Time comes in through the caller (scheduler-clock seconds), so the
serving tests drive the state machine on a FakeClock. Transitions bump
``<prefix>.transitions{to=...}`` and set the ``<prefix>.state`` gauge (0
closed, 1 half-open, 2 open), labeled with the owner's labels.
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from .. import telemetry as _telemetry

__all__ = ["CircuitBreaker", "CircuitOpenError"]

_STATE_GAUGE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitOpenError(MXNetError):
    """Rejected fast: the target's circuit breaker is open.
    ``retry_after_ms`` hints when the next probe becomes possible."""

    def __init__(self, site, retry_after_s=0.0):
        self.site = site
        self.retry_after_ms = max(0, int(retry_after_s * 1000))
        super().__init__(
            f"{site}: circuit breaker open after consecutive failures; "
            f"retry after ~{self.retry_after_ms}ms")


class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open ->
    (cooldown) -> half-open probe -> closed | open."""

    def __init__(self, threshold=5, cooldown_s=1.0, site="",
                 labels=None, metric_prefix="breaker"):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.site = site
        self._labels = dict(labels or {})
        self._prefix = metric_prefix
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at = None
        self._probing = False
        _telemetry.gauge(f"{self._prefix}.state", **self._labels).set(0)

    def _transition(self, state, now=None):
        self.state = state
        if state == "open":
            self.opened_at = now
            self._probing = False
        elif state == "closed":
            self.opened_at = None
            self.consecutive_failures = 0
            self._probing = False
        _telemetry.counter(f"{self._prefix}.transitions", to=state,
                           **self._labels).inc()
        _telemetry.gauge(f"{self._prefix}.state",
                         **self._labels).set(_STATE_GAUGE[state])
        _telemetry.flightrec.note(f"{self._prefix}.transition",
                                  site=self.site, to=state,
                                  failures=self.consecutive_failures,
                                  **self._labels)

    # ---------------------------------------------------------- decisions
    def can_dispatch(self, now):
        """Pure read: may work be attempted at ``now``? True when
        closed, when an open cooldown has elapsed, or half-open with no
        probe in flight."""
        if self.state == "closed":
            return True
        if self.state == "open":
            return now - self.opened_at >= self.cooldown_s
        return not self._probing

    def admit_allowed(self, now):
        """May new work be accepted at ``now``? Rejects only while open
        with the cooldown still running."""
        if self.state != "open":
            return True
        return now - self.opened_at >= self.cooldown_s

    def retry_after(self, now):
        """Seconds until the next probe becomes possible (0 unless open
        with cooldown remaining)."""
        if self.state != "open" or self.opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (now - self.opened_at))

    # ----------------------------------------------------------- mutation
    def acquire(self, now):
        """Claim permission to attempt work now; in the open state an
        elapsed cooldown turns the claim into the half-open probe. Pair
        every True with ``record_success``/``record_failure`` (or
        ``release`` if nothing was attempted)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if now - self.opened_at < self.cooldown_s:
                    return False
                self._transition("half_open", now)
            if self._probing:
                return False
            self._probing = True
            return True

    def release(self):
        """Abandon an acquired probe without an outcome."""
        with self._lock:
            self._probing = False

    def record_success(self, now=None):
        with self._lock:
            self.consecutive_failures = 0
            if self.state != "closed":
                self._transition("closed", now)

    def record_failure(self, now):
        with self._lock:
            self.consecutive_failures += 1
            if self.state == "half_open" or (
                    self.state == "closed" and
                    self.consecutive_failures >= self.threshold):
                self._transition("open", now)
