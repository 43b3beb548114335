"""Telemetry: metrics registry, span tracer, trace plane, flight recorder,
MFU accounting.

The port carries the pieces the serving server and ``Module.fit`` read
and write; the JAX package's exporters (chrome trace, Prometheus, JSON
lines), fleet aggregation, memory accounting and the training-health
plane come with later slices.

* ``telemetry.metrics`` — counters, gauges, histograms (``stats()``
  reads its serving series);
* ``telemetry.core`` — ``span`` and ``event`` (off by default),
  ``enable``/``disable``;
* ``telemetry.mfu`` — cost tables over a bound graph, the card's peaks,
  the ``mfu.*`` gauges ``Module.fit`` sets;
* ``telemetry.trace`` — per-request span trees;
* ``telemetry.flightrec`` — the always-on activity ring and crash
  reports.

Usage::

    mx.telemetry.enable()
    with mx.telemetry.span("my.phase", step=3):
        ...
    mx.telemetry.counter("my.items").inc(8)
    mx.telemetry.snapshot()
"""
from __future__ import annotations

from .core import span, event, record_event, enable, disable, enabled
from .metrics import (Counter, Gauge, Histogram, counter, gauge, histogram,
                      get_metric)
from . import core
from . import metrics
from . import flightrec
from . import trace
from . import mfu

__all__ = ["span", "event", "record_event", "enable", "disable", "enabled",
           "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "get_metric", "snapshot", "reset", "core", "metrics", "flightrec",
           "trace", "mfu"]


def snapshot():
    """The metrics registry plus the span buffer's depth."""
    snap = metrics.snapshot()
    snap["spans"] = len(core.get_spans())
    return snap


def reset():
    """Clear spans, the metrics registry, the flight-recorder ring and
    the trace buffer; the enabled switch is left as it is."""
    core.clear()
    metrics.reset()
    flightrec.clear()
    trace.clear()
