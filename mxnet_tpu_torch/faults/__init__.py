"""Fault injection and the serving degradation policy.

* ``faults.plane`` — named injection points (the serving server's
  ``serve.admit`` and ``serve.dispatch``) armed by ``faults.scope(...)``
  or ``configure`` with scripted triggers; one branch when unarmed;
* ``faults.breaker`` — :class:`CircuitBreaker`, the serving registry's
  per-model breaker.

The JAX package's retry policy (``faults.retry``) serves checkpoint
writes and collectives and comes with the multi-GPU slice.
"""
from __future__ import annotations

from .plane import (InjectedFault, point, configure, scope, clear,
                    enabled, fired, calls, parse_spec)
from .breaker import CircuitBreaker, CircuitOpenError
from . import plane
from . import breaker

__all__ = ["InjectedFault", "point", "configure", "scope", "clear",
           "enabled", "fired", "calls", "parse_spec", "CircuitBreaker",
           "CircuitOpenError", "plane", "breaker"]
