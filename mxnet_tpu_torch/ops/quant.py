"""Post-training quantization tiers (weight-only, per-channel): int8 and
fp8 (``float8_e4m3fn`` storage + float32 scales).

The port of ``mxnet_tpu/ops/quant.py``:

* ``quantize_per_channel`` maps a float weight to int8 (amax / 127,
  round half to even) or ``float8_e4m3fn`` (amax / 448, the cast's
  rounding) plus one float32 scale per output channel. It works in torch
  (numpy has no fp8 without extension packages) and divides and rounds
  exactly as the JAX package's numpy code does, so the bytes it returns
  are the JAX package's bytes;
* ``QuantizedFullyConnected`` / ``QuantizedConvolution``: the plain
  forward dequantizes in float32 (``dequantize``) and runs the
  float op; the ``"cuda"`` variants (attached in ``cuda_kernels.py``) run
  the dequant-fused matmul kernel and the row-dequant kernel ahead of
  cuDNN's convolution, as the JAX package keeps its convolution in XLA;
* ``quantize_symbol`` rewrites a trained graph onto the quantized ops and
  splits each weight ``w`` into ``w_q`` (declared through the variable's
  ``__dtype__``, so the executor binds a narrow cell) and ``w_scale``;
  the rewritten symbol's JSON is the JAX package's.

Quantized graphs are an inference tier: the quantized ops carry no
gradient path, and their ``"cuda"`` variants refuse inputs that require
grad.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, parse_bool, parse_int
from .nn import _CONV_ATTRS, _conv_infer, _convolution, _fully_connected
from .registry import register

__all__ = ["INT8_TOL", "FP8_TOL", "FP8_MAX", "quantize_per_channel",
           "dequantize", "qfc_matmul_plain",
           "quantize_symbol", "quantizable_weights"]

#: tolerance class for int8-vs-float outputs (per-channel symmetric
#: weight-only quantization: at most 1/254 relative weight error)
INT8_TOL = {"atol": 0.05, "rtol": 0.05}

#: tolerance class for fp8-vs-float outputs (e4m3's 3-bit mantissa: at
#: most 2^-4 relative weight error after the amax / 448 scaling)
FP8_TOL = {"atol": 0.15, "rtol": 0.15}

#: largest finite float8_e4m3fn magnitude (the fp8 storage type)
FP8_MAX = 448.0

#: dtype aliases quantize surfaces accept -> canonical storage dtype
_QUANT_DTYPES = {"int8": "int8",
                 "fp8": "float8_e4m3fn",
                 "float8_e4m3fn": "float8_e4m3fn"}
_STORAGE_TORCH = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}

#: ops the rewrite lowers, old op name -> quantized op name
_QUANT_OPS = {"FullyConnected": "QuantizedFullyConnected",
              "Convolution": "QuantizedConvolution"}


def _storage(dtype):
    storage = _QUANT_DTYPES.get(str(dtype))
    if storage is None:
        raise MXNetError(f"quantize: unsupported dtype {dtype!r} "
                         "(int8 or fp8)")
    return storage


def _float32_cpu(arr):
    """Any array-like (NDArray, numpy, torch) as a float32 CPU tensor."""
    if hasattr(arr, "astorch"):
        arr = arr.astorch()
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


# ----------------------------------------------------------- numerics
def quantize_per_channel(arr, axis=0, dtype="int8"):
    """Symmetric per-channel narrow-dtype quantization.

    Returns ``(q, scale)`` as CPU tensors: ``q`` shaped like ``arr`` in
    the storage dtype (``torch.int8`` or ``torch.float8_e4m3fn``),
    ``scale`` float32 shaped ``(arr.shape[axis],)`` with ``arr ≈ q *
    scale`` along ``axis``. int8 maps amax to 127 and rounds half to
    even; fp8 maps amax to 448 and lets the cast round the rest. An
    all-zero channel gets scale 1.0. Every step is the JAX package's
    float32 arithmetic: ``a / scale`` is a true division, not a product
    with the reciprocal.
    """
    storage = _storage(dtype)
    a = _float32_cpu(arr)
    red = tuple(i for i in range(a.ndim) if i != axis)
    amax = a.abs().amax(dim=red) if red else a.abs()
    bshape = [1] * a.ndim
    bshape[axis] = -1
    top = 127.0 if storage == "int8" else FP8_MAX
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    q = a / scale.reshape(bshape)
    if storage == "int8":
        q = torch.round(q)
    q = torch.clamp(q, -top, top)
    return q.to(_STORAGE_TORCH[storage]), scale


def dequantize(q, scale, axis=0):
    """Float32 reconstruction of a per-channel quantized array: over
    rows (O, cols), ``float(q[o, c]) * scale[o]``, the plain version of
    the row-dequant kernel."""
    bshape = [1] * q.ndim
    bshape[axis] = -1
    return q.to(torch.float32) * scale.to(torch.float32).reshape(bshape)


def qfc_matmul_plain(x2, wq, scale):
    """``x2 @ (wq * scale[:, None]).T`` in float32, the weight dequantized
    first: the plain version of the dequant-fused matmul kernel."""
    return torch.matmul(x2.to(torch.float32), dequantize(wq, scale).t())


# ------------------------------------------------- quantized dense op
def _q_inputs(attrs):
    if parse_bool(attrs.get("no_bias", False)):
        return ["data", "weight", "scale"]
    return ["data", "weight", "scale", "bias"]


def _qfc_infer(attrs, in_shapes, out_known=None):
    num_hidden = parse_int(attrs["num_hidden"])
    no_bias = parse_bool(attrs.get("no_bias", False))
    data_s = in_shapes[0]
    w_s, out_s = None, (0, num_hidden)
    if data_s is not None:
        if all(d > 0 for d in data_s[1:]):
            w_s = (num_hidden, int(np.prod(data_s[1:], dtype=np.int64)))
        out_s = (data_s[0], num_hidden)
    new_in = [data_s, w_s, (num_hidden,)] + \
        ([] if no_bias else [(num_hidden,)])
    return new_in, [out_s], []


def _qfc_plain(attrs, data, weight, scale, bias=None):
    """The exact composition: float32 dequant, then FullyConnected; the
    output in the data's dtype."""
    out = _fully_connected(attrs, data.to(torch.float32),
                           dequantize(weight, scale),
                           None if bias is None else bias.to(torch.float32))
    return out.to(data.dtype)


# -------------------------------------------------- quantized conv op
def _qconv_infer(attrs, in_shapes):
    nf = parse_int(attrs["num_filter"])
    no_bias = parse_bool(attrs.get("no_bias", False))
    new_in, out_s, _ = _conv_infer(dict(attrs, no_bias=True),
                                   in_shapes[:2])
    new_in = [new_in[0], new_in[1], (nf,)] + \
        ([] if no_bias else [(nf,)])
    return new_in, out_s, []


def _qconv_plain(attrs, data, weight, scale, bias=None):
    """Float32 dequant per output row, then Convolution."""
    return _convolution(attrs, data, dequantize(weight, scale), bias)


register("QuantizedFullyConnected", inputs=_q_inputs, simple=_qfc_plain,
         infer_shape=_qfc_infer,
         attr_spec={"num_hidden": (parse_int, None),
                    "no_bias": (parse_bool, False),
                    "flatten": (parse_bool, True)})
register("QuantizedConvolution", inputs=_q_inputs, simple=_qconv_plain,
         infer_shape=_qconv_infer, attr_spec=dict(_CONV_ATTRS))


# ----------------------------------------------------- graph rewrite
def quantizable_weights(symbol, arg_params):
    """Weight params eligible for the rewrite: variables that feed ONLY
    FullyConnected/Convolution nodes at the weight slot (a weight shared
    with any other consumer stays float), are present in ``arg_params``,
    and have >= 2 dims."""
    ok, bad = set(), set()
    for node in symbol._topo_nodes():
        if node.is_variable:
            continue
        for i, (inp, _idx) in enumerate(node.inputs):
            if not inp.is_variable:
                continue
            if node.op in _QUANT_OPS and i == 1:
                ok.add(inp.name)
            else:
                bad.add(inp.name)
    out = []
    for name in sorted(ok - bad):
        p = arg_params.get(name)
        if p is not None and len(p.shape) >= 2:
            out.append(name)
    return out


def quantize_symbol(symbol, arg_params, dtype="int8"):
    """Rewrite a trained graph onto the quantized ops.

    Returns ``(qsymbol, qarg_params)``: every quantizable weight ``w`` is
    replaced in the params by ``w_q`` (int8 or float8_e4m3fn) + ``w_scale``
    (float32), CPU NDArrays, and its consumer nodes become Quantized*
    nodes (same node names, so output names and downstream wiring are
    unchanged). Aux params are untouched — pass the originals alongside.
    """
    from ..ndarray import NDArray
    from ..symbol import Node, Symbol
    storage = _storage(dtype)
    targets = set(quantizable_weights(symbol, arg_params))
    if not targets:
        raise MXNetError(
            "quantize: no quantizable weights (needs FullyConnected/"
            "Convolution nodes with their weight in arg_params)")

    qvars = {}          # weight name -> (q_node, scale_node)

    def qvar(name):
        if name not in qvars:
            qvars[name] = (
                Node(None, f"{name}_q", extra={"__dtype__": storage}),
                Node(None, f"{name}_scale",
                     extra={"__dtype__": "float32"}))
        return qvars[name]

    rebuilt = {}

    def rebuild(node):
        if id(node) in rebuilt:
            return rebuilt[id(node)]
        if node.is_variable:
            rebuilt[id(node)] = node        # var nodes are shared as-is
            return node
        new_inputs = [(rebuild(inp), idx) for inp, idx in node.inputs]
        wnode = node.inputs[1][0] if len(node.inputs) > 1 else None
        if (node.op in _QUANT_OPS and wnode is not None
                and wnode.is_variable and wnode.name in targets):
            q_node, s_node = qvar(wnode.name)
            new_inputs = ([new_inputs[0], (q_node, 0), (s_node, 0)]
                          + new_inputs[2:])
            new = Node(_QUANT_OPS[node.op], node.name,
                       dict(node.attrs), new_inputs, dict(node._extra))
        else:
            new = Node(node.op, node.name, dict(node.attrs),
                       new_inputs, dict(node._extra))
        rebuilt[id(node)] = new
        return new

    qsym = Symbol([(rebuild(n), i) for n, i in symbol._outputs])

    qargs = {}
    for name, val in arg_params.items():
        if name in qvars:
            q, s = quantize_per_channel(val, axis=0, dtype=storage)
            qargs[f"{name}_q"] = NDArray(q)
            qargs[f"{name}_scale"] = NDArray(s)
        else:
            qargs[name] = val
    return qsym, qargs
