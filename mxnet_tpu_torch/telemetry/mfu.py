"""MFU and roofline accounting over op cost metadata.

The port's copy of ``mxnet_tpu/telemetry/mfu.py``. The registry's per-op
``flops``/``bytes_moved`` estimators (seeded in ``ops/cost.py``) describe
ONE forward execution at concrete shapes. This module folds them over a
bound graph into:

* a **cost table** — per-op FLOPs/bytes totals for one step (with a
  backward multiplier for training), plus the coverage bookkeeping that
  keeps the numbers honest: which ops carry no metadata and how many
  compute nodes they account for;
* a **roofline** — arithmetic intensity per op against the device's
  machine balance (peak FLOP/s ÷ peak device-memory bandwidth):
  compute-bound vs memory-bound, attainable fraction of peak, share of
  step FLOPs;
* **registry gauges** — ``mfu.model`` (the model-level MFU figure),
  ``mfu.achieved_flops_per_sec``, ``mfu.node_coverage``,
  ``mfu.flops_per_step``, and per-op ``mfu.op.flops`` / ``mfu.op.bytes``
  / ``mfu.op.ai`` series.

MFU is only as honest as its denominator: the peaks come from the device
kind, and ``PEAKS`` holds the one card the port runs on — the H100 SXM
(NVIDIA's data sheet: dense tensor-core rates, 80 GB of HBM3 at 3.35
TB/s). Off the table (the CPU, any other card) there is no peak and only
the achieved FLOP/s is reported.

The default ``dtype="bf16"`` is the JAX package's contract: ``mfu.model``
is a share of the bf16 tensor-core peak (989 TFLOP/s) whatever the step
computes in, so a float32 step's figure is its share of that peak, not of
the 67 TFLOP/s float32 rate outside the tensor cores (``dtype="f32"``) or
the 495 TFLOP/s of TF32 (``dtype="tf32"``).

Pure stdlib at import; torch is read only by ``device_peaks`` /
``device_hbm_bytes`` with no device kind given.
"""
from __future__ import annotations

from . import metrics as _metrics

__all__ = ["PEAKS", "device_peaks", "device_hbm_bytes", "cost_table",
           "roofline", "model_mfu", "record_gauges", "train_factor"]

#: device kind (``torch.cuda.get_device_name()``) -> {"bf16", "tf32",
#: "f32": peak FLOP/s, "hbm": device-memory bytes/s, "hbm_bytes":
#: device-memory capacity}
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
                              "hbm": 3.35e12, "hbm_bytes": 80e9},
}

#: backward-pass FLOP multiplier per op family: weight-bearing ops run
#: ~2 extra matmul/conv-sized passes (grad_data + grad_weight); plain
#: elementwise ops roughly double; optimizer updates run once.
_TRAIN_FACTORS = {
    "Convolution": 3.0, "Deconvolution": 3.0, "FullyConnected": 3.0,
    "FusedConvBNReLU": 3.0, "RNN": 3.0, "dot": 3.0, "batch_dot": 3.0,
    "BatchNorm": 3.0,
    "attention": 3.0, "pallas_flash_attention": 3.0,
    "sgd_update": 1.0, "sgd_mom_update": 1.0, "adam_update": 1.0,
    "rmsprop_update": 1.0, "rmspropalex_update": 1.0,
    "pallas_sgd_mom_update": 1.0,
    # inference-tier ops never appear in a train graph
    "QuantizedFullyConnected": 1.0, "QuantizedConvolution": 1.0,
}
_DEFAULT_TRAIN_FACTOR = 2.0


def train_factor(op_name):
    return _TRAIN_FACTORS.get(op_name, _DEFAULT_TRAIN_FACTOR)


def _current_kind():
    """The current CUDA device's name, or None without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def device_peaks(device_kind=None, dtype="bf16"):
    """(peak_flops, peak_bytes_per_sec) for a device kind — the current
    CUDA device's when none is given — or (None, None) off the table (the
    CPU, no CUDA, another card)."""
    if device_kind is None:
        device_kind = _current_kind()
    rec = PEAKS.get(device_kind)
    if rec is None:
        return None, None
    return rec.get(dtype, rec["bf16"]), rec["hbm"]


def device_hbm_bytes(device_kind=None):
    """Device-memory capacity of one card, or None off the table."""
    if device_kind is None:
        device_kind = _current_kind()
    rec = PEAKS.get(device_kind)
    return int(rec["hbm_bytes"]) if rec else None


def cost_table(symbol, shapes, train=True):
    """Fold per-op cost metadata over one bound graph.

    ``shapes`` maps input/label names to concrete shapes (the same dict
    ``symbol.infer_shape`` takes). Returns a dict:

    ``per_op``        op -> {flops, bytes, train_flops, train_bytes,
                             nodes}
    ``flops/bytes``   forward totals; ``train_flops/train_bytes`` with
                      the backward multiplier applied
    ``uncovered``     op names with nodes in this graph but no metadata
    ``covered_nodes/compute_nodes``  node-level coverage counts
    """
    arg_shapes, _out, aux_shapes = symbol.infer_shape(**shapes)
    known = dict(zip(symbol.list_arguments(), arg_shapes))
    known.update(zip(symbol.list_auxiliary_states(), aux_shapes))
    entry_shapes = symbol._infer_entry_shapes(known)

    per_op = {}
    uncovered = {}
    covered = 0
    compute = 0
    for node in symbol._topo_nodes():
        if node.is_variable:
            continue
        compute += 1
        opdef = node.opdef()
        attrs = node.attrs
        n_aux = len(opdef.aux_names(attrs))
        in_shapes = []
        ok = True
        ins = node.inputs[:len(node.inputs) - n_aux] if n_aux \
            else node.inputs
        for inp, idx in ins:
            if inp.is_variable:
                s = known.get(inp.name)
            else:
                s = entry_shapes.get(id(inp), [None])[idx]
            if s is None or 0 in tuple(s):
                ok = False
                break
            in_shapes.append(tuple(s))
        cost = opdef.cost(attrs, in_shapes) if ok and in_shapes else None
        if cost is None:
            uncovered.setdefault(node.op, 0)
            uncovered[node.op] += 1
            continue
        covered += 1
        f = train_factor(node.op)
        rec = per_op.setdefault(node.op, {"flops": 0.0, "bytes": 0.0,
                                          "train_flops": 0.0,
                                          "train_bytes": 0.0, "nodes": 0})
        rec["flops"] += cost[0]
        rec["bytes"] += cost[1]
        rec["train_flops"] += cost[0] * f
        rec["train_bytes"] += cost[1] * f
        rec["nodes"] += 1

    key = "train_flops" if train else "flops"
    return {
        "per_op": per_op,
        "flops": sum(r["flops"] for r in per_op.values()),
        "bytes": sum(r["bytes"] for r in per_op.values()),
        "train_flops": sum(r["train_flops"] for r in per_op.values()),
        "train_bytes": sum(r["train_bytes"] for r in per_op.values()),
        "step_flops": sum(r[key] for r in per_op.values()),
        "uncovered": sorted(uncovered),
        "uncovered_nodes": int(sum(uncovered.values())),
        "covered_nodes": covered,
        "compute_nodes": compute,
    }


def roofline(table, peak_flops=None, peak_bandwidth=None, train=True,
             top=None):
    """Roofline rows per op, largest FLOPs share first.

    Each row: op, flops, bytes, share (of step FLOPs), ai (arithmetic
    intensity, FLOPs/byte), bound ('compute'|'memory'), and — when the
    peaks are known — attainable_frac (the roofline ceiling for that
    intensity, as a fraction of peak FLOP/s)."""
    fkey = "train_flops" if train else "flops"
    bkey = "train_bytes" if train else "bytes"
    total = sum(r[fkey] for r in table["per_op"].values()) or 1.0
    balance = None
    if peak_flops and peak_bandwidth:
        balance = peak_flops / peak_bandwidth       # FLOPs/byte ridge
    rows = []
    for op, rec in table["per_op"].items():
        ai = rec[fkey] / rec[bkey] if rec[bkey] else float("inf")
        row = {"op": op, "flops": rec[fkey], "bytes": rec[bkey],
               "share": rec[fkey] / total, "ai": ai, "nodes": rec["nodes"]}
        if balance is not None:
            row["bound"] = "compute" if ai >= balance else "memory"
            row["attainable_frac"] = min(1.0, ai / balance)
        else:
            # no machine balance known: classify against a generic
            # accelerator ridge of ~100 FLOPs/byte so the column stays
            # meaningful on CPU runs
            row["bound"] = "compute" if ai >= 100.0 else "memory"
        rows.append(row)
    rows.sort(key=lambda r: r["flops"], reverse=True)
    return rows[:top] if top else rows


def model_mfu(flops_per_step, step_seconds, peak_flops):
    """Model-level MFU: achieved FLOP/s over peak. None without a peak
    or a measurement."""
    if not (flops_per_step and step_seconds and peak_flops):
        return None
    return (flops_per_step / step_seconds) / peak_flops


def record_gauges(table, step_seconds=None, peak_flops=None, train=True):
    """Mirror a cost table (and optionally a measured step) into the
    metrics registry."""
    fkey = "train_flops" if train else "flops"
    bkey = "train_bytes" if train else "bytes"
    for op, rec in table["per_op"].items():
        _metrics.gauge("mfu.op.flops", op=op).set(rec[fkey])
        _metrics.gauge("mfu.op.bytes", op=op).set(rec[bkey])
        if rec[bkey]:
            _metrics.gauge("mfu.op.ai", op=op).set(rec[fkey] / rec[bkey])
    covered = table["covered_nodes"] or 0
    compute = table["compute_nodes"] or 1
    _metrics.gauge("mfu.node_coverage").set(covered / compute)
    flops = table[fkey]
    _metrics.gauge("mfu.flops_per_step").set(flops)
    if step_seconds:
        achieved = flops / step_seconds
        _metrics.gauge("mfu.achieved_flops_per_sec").set(achieved)
        if peak_flops:
            _metrics.gauge("mfu.model").set(achieved / peak_flops)
    return table
