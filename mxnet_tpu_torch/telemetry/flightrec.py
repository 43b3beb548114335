"""Flight recorder: always-on bounded activity ring + crash reports.

The port's copy of ``mxnet_tpu/telemetry/flightrec.py``: a fixed-size
ring (``collections.deque`` with ``maxlen``) of recent activity — the
serving server notes every registration, dispatch, breaker transition
and shed, ``Module.fit`` notes every batch while the span tracer is off,
and finished spans, events and trace records are mirrored in — cheap
enough to leave on (one dict build and one deque append per record).
``dump_crash`` writes the ring, the metrics registry, the CUDA devices
and the ``MXNET_*``/``CUDA_*`` environment as one JSON file in
``MXNET_CRASH_DIR`` (default: the working directory).

Records carry no rank: the port runs one process per card until the
multi-GPU slice tags them. Pure stdlib at import time (torch is read only
inside ``dump_crash``).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import socket
import sys
import threading
import time
import traceback

__all__ = ["note", "note_span", "note_event", "enabled", "configure",
           "get_records", "clear",
           "dump_crash"]

log = logging.getLogger(__name__)

_DEFAULT_CAPACITY = 512

_enabled = os.environ.get("MXNET_FLIGHT_RECORDER", "1") != "0"
_ring = collections.deque(maxlen=max(1, int(os.environ.get(
    "MXNET_FLIGHT_RECORDER_CAPACITY", _DEFAULT_CAPACITY))))
_dump_dir = os.environ.get("MXNET_CRASH_DIR", ".")
_dump_lock = threading.Lock()
_dump_seq = 0


def enabled():
    return _enabled


def configure(capacity=None, dump_dir=None, enabled=None):
    """Adjust the recorder (ring size, crash-dump directory, on/off);
    resizing keeps the newest entries that fit."""
    global _ring, _dump_dir, _enabled
    if capacity is not None:
        _ring = collections.deque(_ring, maxlen=max(1, int(capacity)))
    if dump_dir is not None:
        _dump_dir = dump_dir
    if enabled is not None:
        _enabled = bool(enabled)


def note(kind, **info):
    """Append one record to the ring (no-op while disabled)."""
    if not _enabled:
        return
    _ring.append({"kind": kind, "ts_us": time.perf_counter_ns() // 1000,
                  **info})


def note_span(span):
    """Mirror a finished ``core.Span`` into the ring."""
    if not _enabled:
        return
    _ring.append({"kind": "span", "name": span.name, "ts_us": span.ts,
                  "dur_us": span.dur, **span.args})


def note_event(rec):
    """Mirror a ``core.event()`` record (already timestamped) into the
    ring."""
    if not _enabled:
        return
    _ring.append({"kind": rec["kind"], "ts_us": rec["ts_us"],
                  **rec["payload"]})


def get_records():
    """The ring's contents, oldest first."""
    return list(_ring)


def clear():
    _ring.clear()


def dump_crash(exc=None, where="", extra=None):
    """Write a crash report JSON into the configured directory and
    return its path: the ring, the metrics registry, the CUDA devices
    and the filtered environment."""
    global _dump_seq
    report = _build_report(exc, where, extra)
    os.makedirs(_dump_dir, exist_ok=True)
    with _dump_lock:
        _dump_seq += 1
        seq = _dump_seq
    path = os.path.join(_dump_dir, f"mxnet_crash_{os.getpid()}_{seq}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    log.error("crash report written to %s (while in %s)", path,
              where or "unknown")
    return path


def _build_report(exc, where, extra):
    report = {
        "type": "crash_report",
        "version": 1,
        "time_unix": time.time(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "where": where,
        "pid": os.getpid(),
        "rank": 0,
        "host": socket.gethostname(),
        "argv": list(sys.argv),
        "ring": get_records(),
    }
    if exc is not None:
        report["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__),
        }
    try:
        from . import metrics as _metrics
        report["metrics"] = _metrics.snapshot()
    except Exception as e:
        report["metrics_error"] = repr(e)
    try:
        import torch
        report["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        report["devices"] = [
            {"id": i, "platform": "gpu",
             "device_kind": torch.cuda.get_device_name(i)}
            for i in range(torch.cuda.device_count())]
    except Exception as e:            # never require a live device
        report["devices_error"] = repr(e)
    report["env"] = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith(("MXNET_", "CUDA_", "TORCH_", "NCCL_"))}
    if extra:
        report["extra"] = extra
    return report
