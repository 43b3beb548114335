"""Tensor ops of the decode graph, as plain PyTorch.

The subset of the JAX package's ``ops/tensor.py`` that the transformer LM
binds: ``Reshape`` with its special codes, ``transpose``, ``slice_axis``,
``dot``, elementwise and broadcast add, ``expand_dims``, ``_arange`` and
the ``Embedding`` composition — plus ``Flatten``, which the image
classifiers bind. Every op here except ``Embedding`` is
plain PyTorch on both devices, as the JAX package leaves them to XLA;
``Embedding`` gets its CUDA kernel as the ``"cuda"`` variant in
``cuda_kernels.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import (parse_tuple, parse_bool, parse_int, parse_float,
                    merge_shape)
from .registry import register, alias


def _infer_elemwise(attrs, in_shapes, out_known=None):
    """Identity-shape inference, merged across inputs and outputs."""
    merged = None
    for s in list(in_shapes) + list(out_known or []):
        merged = merge_shape(merged, s)
    return [merged] * len(in_shapes), [merged], []


def _flatten_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None or any(d == 0 for d in s[1:]):
        return in_shapes, [None], []
    return in_shapes, [(s[0], int(np.prod(s[1:], dtype=np.int64)))], []


@register("Flatten", inputs=("data",), infer_shape=_flatten_infer)
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


register("elemwise_add", inputs=("lhs", "rhs"),
         simple=lambda attrs, a, b: a + b, infer_shape=_infer_elemwise)
alias("_plus", "elemwise_add")
register("broadcast_add", inputs=("lhs", "rhs"),
         simple=lambda attrs, a, b: a + b)


@register("_arange", inputs=(),
          attr_spec={"start": (parse_float, 0.0), "stop": (None, None),
                     "step": (parse_float, 1.0), "repeat": (parse_int, 1),
                     "dtype": (None, "float32")})
def _arange_op(attrs):
    from ..ndarray import to_torch_dtype
    start = attrs.get("start", 0.0)
    stop = attrs.get("stop")
    if stop in (None, "None"):
        start, stop = 0.0, start
    arr = torch.arange(start, float(stop), attrs.get("step", 1.0),
                       dtype=to_torch_dtype(attrs.get("dtype", "float32")))
    if attrs.get("repeat", 1) > 1:
        arr = torch.repeat_interleave(arr, attrs["repeat"])
    return arr


@register("dot", inputs=("lhs", "rhs"),
          attr_spec={"transpose_a": (parse_bool, False),
                     "transpose_b": (parse_bool, False)})
def _dot(attrs, a, b):
    if attrs.get("transpose_a"):
        a = a.mT if a.ndim >= 2 else a
    if attrs.get("transpose_b"):
        b = b.mT if b.ndim >= 2 else b
    # MXNet dot on >2d collapses [a1..an-1, an] x [b1, b2..bm] over an==b1
    if a.ndim > 2 or b.ndim > 2:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.matmul(a, b)


@register("transpose", inputs=("data",),
          attr_spec={"axes": (parse_tuple, None)})
def _transpose(attrs, x):
    axes = attrs.get("axes")
    if not axes:
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(*axes)


@register("expand_dims", inputs=("data",), attr_spec={"axis": (parse_int, 0)})
def _expand_dims(attrs, x):
    return x.unsqueeze(attrs["axis"])


@register("Reshape", inputs=("data",),
          attr_spec={"shape": (parse_tuple, None),
                     "target_shape": (parse_tuple, None),
                     "keep_highest": (parse_bool, False),
                     "reverse": (parse_bool, False)})
def _reshape(attrs, x):
    """MXNet's special codes: 0 copies a dim, -1 infers one, -2 copies
    the rest, -3 merges two consecutive dims."""
    shape = attrs.get("shape") or attrs.get("target_shape")
    out = []
    src = list(x.shape)
    i = 0
    for s in shape:
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            continue
        else:
            out.append(s)
            i += 1
    return x.reshape(tuple(out))


alias("reshape", "Reshape")


@register("slice_axis", inputs=("data",),
          attr_spec={"axis": (parse_int, 0), "begin": (parse_int, 0),
                     "end": (None, None)})
def _slice_axis(attrs, x):
    axis, begin = attrs["axis"], attrs["begin"]
    end = attrs.get("end")
    end = x.shape[axis] if end in (None, "None") else int(end)
    if end < 0:
        end += x.shape[axis]
    return x.narrow(axis, begin, end - begin)


def _embedding_infer(attrs, in_shapes):
    data_s, _w_s = in_shapes
    w = (int(attrs["input_dim"]), int(attrs["output_dim"]))
    out = None if data_s is None else tuple(data_s) + (w[1],)
    return [data_s, w], [out], []


def embedding_lookup(ids, weight, scale=1.0):
    """Rows ``ids`` (any shape) of ``weight`` (V, D), times ``scale`` in
    float32, with ``jnp.take``'s default fill: an id in [-V, 0) counts
    from the end, any other out-of-range id gives a NaN row. The 1.0
    default skips the multiply so unscaled lookups stay exact."""
    V = weight.shape[0]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + V, ids)
    valid = (ids >= 0) & (ids < V)
    rows = weight[ids.clamp(0, V - 1)]
    if scale != 1.0:
        rows = (rows.to(torch.float32) * scale).to(weight.dtype)
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


@register("Embedding", inputs=("data", "weight"),
          attr_spec={"input_dim": (parse_int, None),
                     "output_dim": (parse_int, None),
                     "dtype": (None, "float32"),
                     "scale": (parse_float, 1.0)},
          infer_shape=_embedding_infer)
def _embedding(attrs, data, weight):
    """Token-id gather with the optional post-lookup scale (sqrt(d_model)
    in the transformer)."""
    return embedding_lookup(data, weight,
                            parse_float(attrs.get("scale", 1.0)))
