"""Deterministic fault-injection plane: named points, scripted triggers.

The port's copy of the part of ``mxnet_tpu/faults/plane.py`` that the
serving slice uses. A failure seam declares a named injection point::

    from mxnet_tpu_torch import faults
    faults.point("serve.dispatch", model=name)

and a test arms it with a scripted trigger::

    with faults.scope("serve.dispatch:nth=2,error=os"):
        ...

Trigger grammar (comma-separated tokens after ``point:``; clauses joined
by ``;``): ``once``, ``always``, ``nth=N``, ``error=KIND`` (``fault`` —
:class:`InjectedFault`, the default — ``os``, ``runtime``, ``conn``,
``timeout``, ``value``), ``msg=TEXT``. The JAX package's other triggers
(``every=``, ``first=``, ``prob=``/``seed=``, ``latency=``) and its arming
from ``MXNET_FAULTS`` at import come with the slice whose operators arm
faults in production; a spec naming them raises.

Unarmed, ``point()`` is one global load and one branch. Every trigger is
a pure function of its private call counter, so an armed spec fires the
same way every run. Each injection bumps ``faults.injected{point=...}``
and leaves a ``fault.injected`` flight-ring record. The port's in-tree
points are the serving server's ``serve.admit`` and ``serve.dispatch`` and
the checkpoint writer's ``ckpt.write`` and ``ckpt.d2h``.
"""
from __future__ import annotations

import contextlib
import threading

from ..base import MXNetError
from .. import telemetry as _telemetry

__all__ = ["InjectedFault", "point", "configure", "scope", "clear",
           "enabled", "fired", "calls", "parse_spec"]


class InjectedFault(MXNetError):
    """The default exception an armed point raises. Every injected
    exception carries ``mx_fault_point``, whatever its class."""


_ERROR_KINDS = {
    "fault": InjectedFault,
    "os": OSError,
    "runtime": RuntimeError,
    "conn": ConnectionError,
    "timeout": TimeoutError,
    "value": ValueError,
}

#: the JAX package's triggers that this port does not take yet
_LATER = ("every", "first", "prob", "seed", "latency")


class _Trigger:
    """One point's scripted trigger: the call it fires on (or every
    call), its exception, and a private counter."""

    __slots__ = ("point", "nth", "exc_cls", "msg", "calls", "fired")

    def __init__(self, point, spec):
        self.point = point
        self.nth = None           # fire on call nth; 0 = on every call
        self.exc_cls = InjectedFault
        self.msg = None
        self.calls = 0
        self.fired = 0
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok in ("once", "always"):
                self.nth = 1 if tok == "once" else 0
                continue
            if "=" not in tok:
                raise MXNetError(
                    f"fault spec: bad token {tok!r} for point "
                    f"{point!r} (want key=value, 'once' or 'always')")
            key, _, val = tok.partition("=")
            key = key.strip()
            if key == "nth":
                self.nth = int(val)
                if self.nth < 1:
                    raise MXNetError(f"fault spec: nth={val} must be >= 1")
            elif key == "error":
                if val not in _ERROR_KINDS:
                    raise MXNetError(
                        f"fault spec: unknown error kind {val!r} "
                        f"(have: {sorted(_ERROR_KINDS)})")
                self.exc_cls = _ERROR_KINDS[val]
            elif key == "msg":
                self.msg = val
            elif key in _LATER:
                raise MXNetError(
                    f"fault spec: trigger {key}= is not ported yet (a "
                    "later slice); the port takes once, always and nth=")
            else:
                raise MXNetError(f"fault spec: unknown key {key!r} "
                                 f"for point {point!r}")
        if self.nth is None:
            raise MXNetError(
                f"fault spec: point {point!r} needs a trigger "
                "(once/always/nth=)")

    def should_fire(self):
        """Advance the private counter; decide deterministically."""
        self.calls += 1
        return self.nth == 0 or self.calls == self.nth


class _Plane:
    """One armed configuration: point name -> trigger."""

    def __init__(self, triggers):
        self.triggers = triggers
        self._lock = threading.Lock()

    def hit(self, name, ctx):
        trig = self.triggers.get(name)
        if trig is None:
            return
        with self._lock:
            fire = trig.should_fire()
            if fire:
                trig.fired += 1
                call = trig.calls
        if not fire:
            return
        _telemetry.counter("faults.injected", point=name).inc()
        _telemetry.flightrec.note(
            "fault.injected", point=name, call=call,
            action=trig.exc_cls.__name__, **ctx)
        exc = trig.exc_cls(trig.msg or
                           f"injected fault at point {name!r} "
                           f"(call {call})")
        exc.mx_fault_point = name
        raise exc


_active = None     # None = disarmed: the point() fast path


def parse_spec(spec):
    """A spec string (or dict point -> trigger) -> triggers."""
    if isinstance(spec, dict):
        return {p: _Trigger(p, s) for p, s in spec.items()}
    triggers = {}
    for clause in str(spec).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        pt, sep, trig = clause.partition(":")
        if not sep or not pt.strip():
            raise MXNetError(
                f"fault spec: bad clause {clause!r} "
                "(want point:trigger[,key=value...])")
        pt = pt.strip()
        if pt in triggers:
            raise MXNetError(f"fault spec: point {pt!r} configured "
                             "twice")
        triggers[pt] = _Trigger(pt, trig)
    return triggers


def point(name, **ctx):
    """One named injection site: a no-op unless the plane is armed with
    a trigger for ``name``; when it fires, raises the configured
    exception (marked ``mx_fault_point``). ``ctx`` rides into the flight-ring record."""
    plane = _active
    if plane is not None:
        plane.hit(name, ctx)


def configure(spec):
    """Arm the plane from a spec string/dict; ``None``/empty disarms.
    Returns the previous arming (for ``scope``)."""
    global _active
    prev = _active
    _active = _Plane(parse_spec(spec)) if spec else None
    return prev


def clear():
    """Disarm the plane."""
    global _active
    _active = None


def enabled():
    return _active is not None


@contextlib.contextmanager
def scope(spec):
    """Arm ``spec`` for a with-block, restoring the previous arming."""
    global _active
    prev = configure(spec)
    try:
        yield _active
    finally:
        _active = prev


def fired(name=None):
    """Injections fired so far: count for one point, or dict for all."""
    plane = _active
    trigs = plane.triggers if plane is not None else {}
    if name is not None:
        t = trigs.get(name)
        return t.fired if t is not None else 0
    return {p: t.fired for p, t in trigs.items()}


def calls(name=None):
    """Point traversals seen by armed triggers (fired or not)."""
    plane = _active
    trigs = plane.triggers if plane is not None else {}
    if name is not None:
        t = trigs.get(name)
        return t.calls if t is not None else 0
    return {p: t.calls for p, t in trigs.items()}

