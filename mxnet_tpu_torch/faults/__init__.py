"""Fault injection and the serving degradation policy.

* ``faults.plane`` — named injection points (the serving server's
  ``serve.admit`` and ``serve.dispatch``, the checkpoint writer's
  ``ckpt.write`` and ``ckpt.d2h``) armed by ``faults.scope(...)`` or
  ``configure`` with scripted triggers; one branch when unarmed;
* ``faults.retry`` — the shared :class:`RetryPolicy` / ``retry_call``
  (exponential backoff + jitter + deadline budget, ``MXNET_RETRY_*``
  env, ``retry.*`` counters), applied to checkpoint commits
  (``ckpt.write``);
* ``faults.breaker`` — :class:`CircuitBreaker`, the serving registry's
  per-model breaker.
"""
from __future__ import annotations

from .plane import (InjectedFault, point, configure, scope, clear,
                    enabled, fired, calls, parse_spec)
from .retry import RetryPolicy, retry_call
from .breaker import CircuitBreaker, CircuitOpenError
from . import plane
from . import retry
from . import breaker

__all__ = ["InjectedFault", "point", "configure", "scope", "clear",
           "enabled", "fired", "calls", "parse_spec", "RetryPolicy",
           "retry_call", "CircuitBreaker", "CircuitOpenError", "plane",
           "retry", "breaker"]
