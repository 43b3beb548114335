"""Layer ops of the decode graph, as plain PyTorch.

``FullyConnected`` (weights stored (num_hidden, in_dim), ``x @ W^T`` on
``torch.matmul`` — the large products stay library matmuls, as the JAX
package leaves them to XLA), the ``LayerNorm`` and ``FusedBiasGeLU``
compositions (their CUDA kernels are attached in ``cuda_kernels.py``),
and rotary position embedding (``rope_apply`` / ``RoPE``), which stays
plain on both devices exactly as the JAX package keeps it outside any
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import (parse_bool, parse_int, parse_float, merge_shape,
                    shape_is_known)
from .registry import register


def _fc_inputs(attrs):
    if parse_bool(attrs.get("no_bias", False)):
        return ["data", "weight"]
    return ["data", "weight", "bias"]


def _fc_infer(attrs, in_shapes, out_known=None):
    num_hidden = parse_int(attrs["num_hidden"])
    no_bias = parse_bool(attrs.get("no_bias", False))
    data_s = in_shapes[0]
    out_s = (0, num_hidden)
    w_s = in_shapes[1] if len(in_shapes) > 1 else None
    if out_known and out_known[0] is not None:
        out_s = merge_shape(out_s, out_known[0])
    if data_s is not None:
        if all(d > 0 for d in data_s[1:]):
            in_dim = int(np.prod(data_s[1:], dtype=np.int64))
            w_s = merge_shape(w_s, (num_hidden, in_dim))
        out_s = merge_shape(out_s, (data_s[0], num_hidden))
        data_s = merge_shape(data_s, (out_s[0],) + tuple(data_s[1:]))
    elif out_s is not None and w_s is not None and shape_is_known(w_s):
        data_s = (out_s[0], w_s[1])
    new_in = [data_s, w_s] + ([] if no_bias else [(num_hidden,)])
    return new_in, [out_s], []


@register("FullyConnected", inputs=_fc_inputs,
          attr_spec={"num_hidden": (parse_int, None),
                     "no_bias": (parse_bool, False),
                     "flatten": (parse_bool, True)},
          infer_shape=_fc_infer)
def _fully_connected(attrs, data, weight, bias=None):
    if data.ndim > 2 and attrs.get("flatten", True):
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.to(data.dtype).t())
    if bias is not None:
        out = out + bias.to(data.dtype)
    return out


def _ln_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    if data_s is None:
        return in_shapes, [None, None, None], []
    axis = parse_int(attrs.get("axis", -1)) % len(data_s)
    c = (data_s[axis],)
    red = tuple(d for i, d in enumerate(data_s) if i != axis)
    return [data_s, c, c], [data_s, red, red], []


def _ln_fwd(attrs, inputs, aux, is_train, rng):
    """LayerNorm composition: per-sample statistics over one axis in
    float32. Outputs [out, mean, std] with std = sqrt(var + eps)."""
    data, gamma, beta = inputs
    axis = parse_int(attrs.get("axis", -1)) % data.ndim
    eps = parse_float(attrs.get("eps", 1e-5))
    x32 = data.to(torch.float32)
    mean = x32.mean(dim=axis)
    var = x32.var(dim=axis, unbiased=False)
    std = torch.sqrt(var + eps)
    bshape = [1] * data.ndim
    bshape[axis] = -1
    me = mean.unsqueeze(axis)
    rstd = torch.rsqrt(var + eps).unsqueeze(axis)
    out = (x32 - me) * rstd * gamma.to(torch.float32).reshape(bshape) \
        + beta.to(torch.float32).reshape(bshape)
    return [out.to(data.dtype), mean, std], []


register("LayerNorm", inputs=("data", "gamma", "beta"), full=_ln_fwd,
         num_outputs=3, output_names=["output", "mean", "std"],
         num_visible=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
         attr_spec={"axis": (parse_int, -1), "eps": (parse_float, 1e-5),
                    "output_mean_var": (parse_bool, False)},
         infer_shape=_ln_infer)


def rope_apply(x, positions, base=10000.0):
    """Rotate ``x`` (..., T, D) by rotary angles at absolute
    ``positions`` — (T,) shared across the batch, or (B, T) per-slot
    positions. Split-half (GPT-NeoX) pairs; trig in float32, cast back."""
    dh = x.shape[-1]
    half = dh // 2
    inv = torch.tensor(base, dtype=torch.float32, device=x.device) ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (2.0 / dh))
    ang = positions.to(torch.float32)[..., :, None] * inv   # (..., T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.ndim == 2:
        # (B, T, half) -> (B, 1, T, half) against x (B, H, T, D)
        cos, sin = cos[:, None], sin[:, None]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_INV_SQRT2 = 0.7071067811865476


def _bias_gelu_infer(attrs, in_shapes, out_known=None):
    data_s = in_shapes[0]
    if out_known and out_known[0] is not None and data_s is None:
        data_s = out_known[0]
    c = (data_s[-1],) if data_s is not None else None
    return [data_s, c], [data_s], []


def bias_gelu(data, bias):
    """Bias add + exact (erf) GeLU over the last axis, in float32: the
    dense epilogue ``0.5 z (1 + erf(z / sqrt 2))`` with z = data + bias."""
    z = data.to(torch.float32) + bias.to(torch.float32)
    return (0.5 * z * (1.0 + torch.erf(z * _INV_SQRT2))).to(data.dtype)


register("FusedBiasGeLU", inputs=("data", "bias"),
         simple=lambda attrs, data, bias: bias_gelu(data, bias),
         infer_shape=_bias_gelu_infer)


@register("RoPE", inputs=("data",), shape_passthrough=True,
          attr_spec={"base": (parse_float, 10000.0),
                     "offset": (parse_int, 0)})
def _rope(attrs, x):
    """x: (B, H, T, D) rotated at absolute positions ``offset + t``."""
    if x.shape[-1] % 2:
        raise ValueError(f"RoPE needs an even head dim, got {x.shape[-1]}")
    positions = parse_int(attrs.get("offset", 0)) + torch.arange(
        x.shape[-2], device=x.device)
    return rope_apply(x, positions, parse_float(attrs.get("base", 10000.0)))
