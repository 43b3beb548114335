"""Telemetry: metrics registry, span tracer, trace plane, flight recorder.

The port carries the pieces the serving server reads and writes; the
JAX package's exporters (chrome trace, Prometheus, JSON lines), fleet
aggregation, memory accounting and the training-health plane come with
later slices.

* ``telemetry.metrics`` — counters, gauges, histograms (``stats()``
  reads its serving series);
* ``telemetry.core`` — ``span`` (off by default), ``enable``/``disable``;
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

from .core import span, enable, disable, enabled
from .metrics import (Counter, Gauge, Histogram, counter, gauge, histogram,
                      get_metric)
from . import core
from . import metrics
from . import flightrec
from . import trace

__all__ = ["span", "enable", "disable", "enabled", "Counter", "Gauge",
           "Histogram", "counter", "gauge", "histogram", "get_metric",
           "snapshot", "reset", "core", "metrics", "flightrec", "trace"]


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
