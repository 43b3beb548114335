"""Layer ops, as plain PyTorch.

The decode graph's ``FullyConnected`` (weights stored (num_hidden,
in_dim), ``x @ W^T`` on ``torch.matmul`` — the large products stay
library matmuls, as the JAX package leaves them to XLA), the
``LayerNorm`` and ``FusedBiasGeLU`` compositions (their CUDA kernels are
attached in ``cuda_kernels.py``), and rotary position embedding
(``rope_apply`` / ``RoPE``), which stays plain on both devices exactly as
the JAX package keeps it outside any kernel.

The image-classification layers the ResNet training path binds —
``Convolution`` (``F.conv*``, as ``lax.conv`` lies outside any Pallas
kernel), ``Pooling``, ``Activation`` and ``BatchNorm`` — are the JAX
package's compositions written in PyTorch; their backward is autograd's.
``FusedConvBNReLU`` is those three in one op (its plain forward is their
composition; the BatchNorm-and-ReLU half has CUDA kernels). The other
classifiers of ``models/`` also bind ``LRN`` and ``Concat`` (the JAX
package's compositions, plain on both devices) and ``Dropout``, whose
mask is ``mx.random``'s bernoulli draw under the node's key, bit for bit
the JAX package's (its CUDA variant, the threefry kernel, is attached in
``cuda_kernels.py``). ``softmax`` / ``log_softmax`` over an axis and
``SliceChannel`` (alias ``split``) are the JAX package's, plain on both
devices.

Mixed precision (``compute_dtype="bfloat16"`` or ``"float16"``): the
executor hands these ops 16-bit data, parameters and moving statistics.
Weights are cast to the data's type, as the JAX package casts them, and
the BatchNorm arithmetic follows the JAX package's types op for op: a
Python scalar meeting a 16-bit tensor is first rounded to its type (JAX's
weak typing, ``weak_scalar``: 0.9 is 0.8984375 in bfloat16 and
0.89990234375 in float16), and a 16-bit tensor meeting a float32 one
promotes to float32. JAX treats the two 16-bit types alike here, and so
does the port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import (parse_tuple, parse_bool, parse_int, parse_float,
                    merge_shape, shape_is_known)
from .registry import register, alias


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


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------
_CONV_ATTRS = {
    "kernel": (parse_tuple, None), "stride": (parse_tuple, None),
    "dilate": (parse_tuple, None), "pad": (parse_tuple, None),
    "num_filter": (parse_int, None), "num_group": (parse_int, 1),
    "no_bias": (parse_bool, False), "workspace": (parse_int, 1024),
    "cudnn_tune": (None, None), "cudnn_off": (parse_bool, False),
    "layout": (None, None),
}


def _ntuple(v, n, default):
    t = parse_tuple(v) if v is not None else None
    if t is None:
        return (default,) * n
    if len(t) != n:
        t = tuple(t) + (default,) * (n - len(t))
    return t


def _conv_out_dim(in_dim, k, s, p, d):
    return (in_dim + 2 * p - (d * (k - 1) + 1)) // s + 1


def _conv_infer(attrs, in_shapes):
    kernel = parse_tuple(attrs["kernel"])
    nf = parse_int(attrs["num_filter"])
    ng = parse_int(attrs.get("num_group", 1))
    no_bias = parse_bool(attrs.get("no_bias", False))
    nd = len(kernel)
    stride = _ntuple(attrs.get("stride"), nd, 1)
    pad = _ntuple(attrs.get("pad"), nd, 0)
    dilate = _ntuple(attrs.get("dilate"), nd, 1)
    data_s = in_shapes[0]
    w_s, out_s = None, None
    if data_s is not None:
        w_s = (nf, data_s[1] // ng) + kernel
        spatial = tuple(_conv_out_dim(data_s[2 + i], kernel[i], stride[i],
                                      pad[i], dilate[i]) for i in range(nd))
        out_s = (data_s[0], nf) + spatial
    return [data_s, w_s] + ([] if no_bias else [(nf,)]), [out_s], []


_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", inputs=_fc_inputs, attr_spec=dict(_CONV_ATTRS),
          infer_shape=_conv_infer)
def _convolution(attrs, data, weight, bias=None):
    """NCHW (NCH, NCDHW) convolution, weight (O, I/groups, k...)."""
    kernel = parse_tuple(attrs["kernel"])
    nd = len(kernel)
    return _CONV_FNS[nd](
        data, weight.to(data.dtype),
        None if bias is None else bias.to(data.dtype),
        stride=_ntuple(attrs.get("stride"), nd, 1),
        padding=_ntuple(attrs.get("pad"), nd, 0),
        dilation=_ntuple(attrs.get("dilate"), nd, 1),
        groups=parse_int(attrs.get("num_group", 1)))


alias("Convolution_v1", "Convolution")


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------
def _pool_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    if data_s is None:
        return in_shapes, [None], []
    kernel = parse_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = _ntuple(attrs.get("stride"), nd, 1)
    pad = _ntuple(attrs.get("pad"), nd, 0)
    if parse_bool(attrs.get("global_pool", False)):
        out_s = data_s[:2] + (1,) * nd
    else:
        full = attrs.get("pooling_convention", "valid") == "full"
        dims = []
        for i in range(nd):
            x = data_s[2 + i] + 2 * pad[i] - kernel[i]
            dims.append(int(np.ceil(x / stride[i])) + 1 if full
                        else x // stride[i] + 1)
        out_s = data_s[:2] + tuple(dims)
    return in_shapes, [out_s], []


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", inputs=("data",),
          attr_spec={"kernel": (parse_tuple, None),
                     "pool_type": (None, "max"),
                     "global_pool": (parse_bool, False),
                     "pooling_convention": (None, "valid"),
                     "stride": (parse_tuple, None),
                     "pad": (parse_tuple, None)},
          infer_shape=_pool_infer)
def _pooling(attrs, data):
    """The JAX package's reduce_window semantics: max pads with -inf,
    avg divides by the kernel size (padding counted), sum is the window
    sum, ``global_pool`` takes the whole spatial extent, and
    ``pooling_convention="full"`` (ceil output shape) pads the high side
    by what the ceil needs."""
    nd = data.ndim - 2
    glob = parse_bool(attrs.get("global_pool", False))
    if glob:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = parse_tuple(attrs["kernel"])
        stride = _ntuple(attrs.get("stride"), nd, 1)
        pad = _ntuple(attrs.get("pad"), nd, 0)
    extra = [0] * nd
    if attrs.get("pooling_convention", "valid") == "full" and not glob:
        for i in range(nd):
            x = data.shape[2 + i] + 2 * pad[i] - kernel[i]
            want = int(np.ceil(x / stride[i])) + 1
            extra[i] = max(0, (want - 1) * stride[i] + kernel[i]
                           - (data.shape[2 + i] + 2 * pad[i]))
    ptype = attrs.get("pool_type", "max")
    if ptype not in ("max", "avg", "sum"):
        raise ValueError(f"pool_type {ptype}")
    if ptype == "max" and not any(extra) and \
            all(p <= k // 2 for p, k in zip(pad, kernel)):
        # PyTorch's implicit padding is -inf for max pooling
        return _MAX_POOL[nd](data, kernel, stride, pad)
    # explicit padding, (last axis lo, hi, ..., first axis lo, hi)
    widths = []
    for p, e in zip(reversed(pad), reversed(extra)):
        widths += [p, p + e]
    if ptype == "max":
        x = F.pad(data, widths, value=float("-inf"))
        return _MAX_POOL[nd](x, kernel, stride)
    x = F.pad(data, widths) if any(widths) else data
    if nd == 1:   # the 2-D pool over a unit height
        x, kernel, stride = x.unsqueeze(2), (1,) + kernel, (1,) + stride
    out = _AVG_POOL[max(nd, 2)](x, kernel, stride,
                                divisor_override=1 if ptype == "sum"
                                else int(np.prod(kernel)))
    return out.squeeze(2) if nd == 1 else out


alias("Pooling_v1", "Pooling")


# --------------------------------------------------------------------------
# Activation
# --------------------------------------------------------------------------
def _id_infer(attrs, in_shapes, out_known=None):
    merged = merge_shape(in_shapes[0], out_known[0] if out_known else None)
    return [merged] + list(in_shapes[1:]), [merged], []


@register("Activation", inputs=("data",),
          attr_spec={"act_type": (None, "relu")}, infer_shape=_id_infer)
def _activation(attrs, x):
    t = attrs.get("act_type", "relu")
    if t == "relu":
        # torch.maximum, not relu: at x == 0 its gradient splits 1/2-1/2
        # between the two operands exactly as jnp.maximum's does
        return torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    if t == "sigmoid":
        return torch.sigmoid(x)
    if t == "tanh":
        return torch.tanh(x)
    if t == "softrelu":
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    if t == "softsign":
        return x / (1 + torch.abs(x))
    if t == "gelu":
        x32 = x.to(torch.float32)
        return (0.5 * x32 * (1.0 + torch.erf(x32 * _INV_SQRT2))).to(x.dtype)
    raise ValueError(f"act_type {t}")


# --------------------------------------------------------------------------
# BatchNorm
# --------------------------------------------------------------------------
def momentum_update(momentum, moving, batch):
    """``momentum * moving + (1 - momentum) * batch``, the moving
    statistics' update. Under ``compute_dtype`` ``moving`` arrives in
    16 bits: ``momentum`` is then rounded to its type (``weak_scalar``)
    and the sum promotes to float32, and the product is kept in float32,
    as the JAX package's compiled bfloat16 step computes it (XLA holds
    excess precision inside the fusion), so the stored statistics match
    its bit for bit given the same batch statistics. Its compiled float16
    step rounds the product to float16 before the sum (measured on the
    CPU: keeping it in float32 moves a statistic by up to 4e-4 relative),
    and so does the port."""
    if moving.dtype == torch.float16:
        # the compiled float16 step rounds the product to float16
        return (weak_scalar(momentum, moving) * moving).to(batch.dtype) + \
            (1 - momentum) * batch
    return weak_scalar(momentum, moving) * moving.to(batch.dtype) + \
        (1 - momentum) * batch


def weak_scalar(value, like):
    """The Python scalar ``value`` as JAX's weak typing reads it beside the
    tensor ``like``: rounded to ``like``'s half-precision type (0.9 is
    0.8984375 in bfloat16, 0.89990234375 in float16), unchanged beside
    float32. PyTorch would keep
    the scalar in float32 and round only the result."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(value, dtype=like.dtype))
    return value


def _bn_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    c = (data_s[1],) if data_s is not None else None
    return [data_s, c, c], [data_s, c, c], [c, c]


def _bn_fwd(attrs, inputs, aux, is_train, rng):
    """The JAX package's composition. Training (without
    ``use_global_stats``) normalizes by the batch statistics over every
    axis but the channel, in float32, and moves the aux state by
    ``momentum`` toward the batch mean and the BIASED batch variance
    (``F.batch_norm`` would move it toward the unbiased one, so it is not
    used). ``fix_gamma`` replaces gamma by ones, so gamma's gradient is 0.
    Outputs [out, mean, var]; new aux [moving_mean, moving_var], detached
    from the graph. Under ``compute_dtype`` the moving statistics arrive in
    16 bits: the update is ``momentum_update``'s, and inference takes
    ``rsqrt(var + eps)`` in that type (``eps`` rounded to it), as the
    JAX package's types say."""
    data, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps = parse_float(attrs.get("eps", 1e-3))
    momentum = parse_float(attrs.get("momentum", 0.9))
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    if parse_bool(attrs.get("fix_gamma", True)):
        gamma = torch.ones_like(gamma)
    if is_train and not parse_bool(attrs.get("use_global_stats", False)):
        var, mean = torch.var_mean(data.to(torch.float32), dim=axes,
                                   unbiased=False)
        new_mean = momentum_update(momentum, moving_mean, mean.detach())
        new_var = momentum_update(momentum, moving_var, var.detach())
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + weak_scalar(eps, var))
    out = (data - mean.reshape(bshape).to(data.dtype)) * \
        (inv.reshape(bshape) * gamma.reshape(bshape)).to(data.dtype) + \
        beta.reshape(bshape).to(data.dtype)
    return [out, mean, var], [new_mean, new_var]


register("BatchNorm", inputs=("data", "gamma", "beta"),
         aux=("moving_mean", "moving_var"), full=_bn_fwd,
         num_outputs=3, output_names=["output", "mean", "var"],
         num_visible=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
         attr_spec={"eps": (parse_float, 1e-3),
                    "momentum": (parse_float, 0.9),
                    "fix_gamma": (parse_bool, True),
                    "use_global_stats": (parse_bool, False),
                    "output_mean_var": (parse_bool, False)},
         infer_shape=_bn_infer)
alias("CuDNNBatchNorm", "BatchNorm")


# --------------------------------------------------------------------------
# FusedConvBNReLU
# --------------------------------------------------------------------------
def cbr_plain(attrs, data, weight, gamma, beta, moving_mean, moving_var,
              is_train):
    """The JAX package's ``_cbr_xla_impl``: Convolution (no bias) ->
    BatchNorm -> ReLU through this module's own compositions, so the fused
    op computes bit for bit what the three ops compute. Returns (y,
    [new_moving_mean, new_moving_var])."""
    conv = _convolution(attrs, data, weight)
    outs, new_aux = _bn_fwd(attrs, [conv, gamma, beta],
                            [moving_mean, moving_var], is_train, None)
    return torch.maximum(outs[0], torch.zeros((), dtype=outs[0].dtype,
                                              device=outs[0].device)), new_aux


def _cbr_forward(attrs, inputs, aux, is_train, rng):
    data, weight, gamma, beta = inputs
    y, new_aux = cbr_plain(attrs, data, weight, gamma, beta, aux[0], aux[1],
                           is_train)
    return [y], new_aux


def _cbr_infer(attrs, in_shapes):
    new_in, out_s, _ = _conv_infer(dict(attrs, no_bias=True), in_shapes[:2])
    c = (parse_int(attrs["num_filter"]),)
    return [new_in[0], new_in[1], c, c], out_s, [c, c]


_CBR_ATTRS = {k: v for k, v in _CONV_ATTRS.items() if k != "no_bias"}
_CBR_ATTRS.update({"eps": (parse_float, 1e-3),
                   "momentum": (parse_float, 0.9),
                   "fix_gamma": (parse_bool, True),
                   "use_global_stats": (parse_bool, False)})
register("FusedConvBNReLU", inputs=("data", "weight", "gamma", "beta"),
         aux=("moving_mean", "moving_var"), full=_cbr_forward,
         attr_spec=_CBR_ATTRS, infer_shape=_cbr_infer)


# --------------------------------------------------------------------------
# LRN
# --------------------------------------------------------------------------
@register("LRN", inputs=("data",),
          attr_spec={"alpha": (parse_float, 1e-4), "beta": (parse_float, 0.75),
                     "knorm": (parse_float, 2.0), "nsize": (parse_int, 5)},
          num_outputs=2, num_visible=1, output_names=["output", "tmp_norm"],
          infer_shape=lambda attrs, s: (s, [s[0], s[0]], []))
def _lrn(attrs, data):
    """The JAX package's composition: the squares summed over a window of
    ``nsize`` channels, zero-padded by ``nsize // 2`` on each side, then
    ``norm = (knorm + alpha / nsize * window) ** beta``; outputs [data /
    norm, norm]."""
    nsize = parse_int(attrs.get("nsize", 5))
    alpha = parse_float(attrs.get("alpha", 1e-4))
    beta = parse_float(attrs.get("beta", 0.75))
    knorm = parse_float(attrs.get("knorm", 2.0))
    half = nsize // 2
    c = data.shape[1]
    widths = [0, 0] * (data.ndim - 2) + [half, half]
    padded = F.pad(torch.square(data), widths)
    windows = 0
    for i in range(nsize):
        windows = windows + padded[:, i:i + c]
    norm = (knorm + alpha / nsize * windows) ** beta
    return data / norm, norm


# --------------------------------------------------------------------------
# Dropout
# --------------------------------------------------------------------------
def dropout_mask_value(keep, dtype):
    """The value a kept element's mask holds, ``1 / keep`` as the JAX
    package's ``bernoulli(...).astype(dtype) / keep`` gives it: ``keep`` (a
    weakly typed Python float) rounded to ``dtype`` first
    (``weak_scalar``), the quotient taken in float32 and rounded to
    ``dtype``."""
    k = torch.tensor(float(keep), dtype=dtype).to(torch.float32)
    return float((torch.ones((), dtype=torch.float32) / k).to(dtype))


def dropout_plain(x, key, keep):
    """(y, mask): ``mask`` holds ``dropout_mask_value(keep, x.dtype)``
    where ``mx.random.bernoulli(key, keep, x.shape)`` is true and 0
    elsewhere, in x's dtype, and ``y = x * mask``: the JAX package's
    Dropout, bit for bit."""
    kept = _random.bernoulli(key, keep, x.shape, device=x.device)
    mask = torch.where(kept, torch.tensor(
        dropout_mask_value(keep, x.dtype), dtype=x.dtype, device=x.device),
        torch.zeros((), dtype=x.dtype, device=x.device))
    return x * mask, mask


def _dropout_fwd(attrs, inputs, aux, is_train, rng):
    """Outside training, or at ``p <= 0``, the identity and a mask of
    ones; in training ``dropout_plain`` under the node's key, keeping
    each element with probability ``1 - p``. The backward multiplies by
    the forward's mask (autograd through ``x * mask``) and draws nothing."""
    x = inputs[0]
    p = parse_float(attrs.get("p", 0.5))
    if not is_train or p <= 0.0:
        return [x, torch.ones_like(x)], []
    return list(dropout_plain(x, rng, 1.0 - p)), []


register("Dropout", inputs=("data",), full=_dropout_fwd, need_rng=True,
         num_outputs=2, num_visible=1, output_names=["output", "mask"],
         attr_spec={"p": (parse_float, 0.5), "mode": (None, "training")},
         infer_shape=lambda attrs, s: (s, [s[0], s[0]], []))


# --------------------------------------------------------------------------
# Concat
# --------------------------------------------------------------------------
def _concat_inputs(attrs):
    return [f"arg{i}" for i in range(parse_int(attrs.get("num_args", 2)))]


def _concat_infer(attrs, in_shapes):
    dim = parse_int(attrs.get("dim", 1))
    if any(s is None for s in in_shapes):
        return in_shapes, [None], []
    out = list(in_shapes[0])
    out[dim] = sum(s[dim] for s in in_shapes)
    return in_shapes, [tuple(out)], []


@register("Concat", inputs=_concat_inputs,
          attr_spec={"num_args": (parse_int, 2), "dim": (parse_int, 1)},
          infer_shape=_concat_infer)
def _concat(attrs, *xs):
    return torch.cat(xs, dim=parse_int(attrs.get("dim", 1)))


alias("concat", "Concat")


# --------------------------------------------------------------------------
# softmax / log_softmax over an axis, and SliceChannel (plain on both
# devices: the JAX package's are XLA's ``jax.nn`` compositions; the
# SoftmaxOutput head's kernels are for the loss head's rows only)
# --------------------------------------------------------------------------
@register("softmax", inputs=("data",), shape_passthrough=True,
          attr_spec={"axis": (parse_int, -1),
                     "temperature": (None, None)})
def _softmax_op(attrs, x):
    t = attrs.get("temperature")
    if t not in (None, "None"):
        x = x / parse_float(t)
    return torch.softmax(x, dim=attrs.get("axis", -1))


@register("log_softmax", inputs=("data",), shape_passthrough=True,
          attr_spec={"axis": (parse_int, -1)})
def _log_softmax_op(attrs, x):
    return torch.log_softmax(x, dim=attrs.get("axis", -1))


def _slice_channel_outputs(attrs):
    return parse_int(attrs.get("num_outputs", 1))


def _slice_channel_infer(attrs, in_shapes):
    n = parse_int(attrs.get("num_outputs", 1))
    axis = parse_int(attrs.get("axis", 1))
    data_s = in_shapes[0]
    if data_s is None:
        return in_shapes, [None] * n, []
    out = list(data_s)
    out[axis] = out[axis] // n
    if parse_bool(attrs.get("squeeze_axis", False)) and out[axis] == 1:
        out.pop(axis)
    return in_shapes, [tuple(out)] * n, []


@register("SliceChannel", inputs=("data",),
          attr_spec={"num_outputs": (parse_int, 1), "axis": (parse_int, 1),
                     "squeeze_axis": (parse_bool, False)},
          num_outputs=_slice_channel_outputs,
          infer_shape=_slice_channel_infer)
def _slice_channel(attrs, x):
    """``num_outputs`` equal parts of x along ``axis`` (``jnp.split``: the
    axis must divide), each a view; ``squeeze_axis`` drops the axis."""
    n = parse_int(attrs.get("num_outputs", 1))
    axis = parse_int(attrs.get("axis", 1))
    if x.shape[axis] % n:
        raise ValueError(f"SliceChannel: axis {axis} of {tuple(x.shape)} "
                         f"does not split into {n} equal parts")
    outs = torch.split(x, x.shape[axis] // n, dim=axis)
    if parse_bool(attrs.get("squeeze_axis", False)):
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


alias("split", "SliceChannel")
