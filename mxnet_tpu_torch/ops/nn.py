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
from .tensor import _take_along


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
        return gelu_exact(x)
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


# --------------------------------------------------------------------------
# LeakyReLU (every act_type needs a key: only rrelu's training forward uses
# it, drawing its slopes as the JAX package's ``jax.random.uniform`` does)
# --------------------------------------------------------------------------
def gelu_exact(x):
    """Exact (erf) GeLU in float32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    return (0.5 * x32 * (1.0 + torch.erf(x32 * _INV_SQRT2))).to(x.dtype)


def _lrelu_inputs(attrs):
    if attrs.get("act_type", "leaky") == "prelu":
        return ["data", "gamma"]
    return ["data"]


def _lrelu_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    if attrs.get("act_type", "leaky") == "prelu":
        g = (data_s[1],) if data_s is not None else None
        return [data_s, g], [data_s], []
    return in_shapes, [data_s], []


def _lrelu_fwd(attrs, inputs, aux, is_train, rng):
    """``x`` where x > 0, else ``slope * x`` (leaky), ``slope * (exp(x) -
    1)`` (elu), ``gamma[c] * x`` (prelu) or ``r * x`` (rrelu: r uniform in
    [lower_bound, upper_bound) under the node's key in training, their mean
    outside it); gelu is the exact GeLU."""
    t = attrs.get("act_type", "leaky")
    x = inputs[0]
    slope = weak_scalar(parse_float(attrs.get("slope", 0.25)), x)
    if t == "leaky":
        return [torch.where(x > 0, x, slope * x)], []
    if t == "elu":
        return [torch.where(x > 0, x, slope * (torch.exp(x) - 1))], []
    if t == "prelu":
        gamma = inputs[1].reshape((1, -1) + (1,) * (x.ndim - 2))
        return [torch.where(x > 0, x, gamma * x)], []
    if t == "rrelu":
        lo = parse_float(attrs.get("lower_bound", 0.125))
        hi = parse_float(attrs.get("upper_bound", 0.334))
        if is_train:
            from .cuda_kernels import uniform
            r = uniform(rng, tuple(x.shape), lo, hi, device=x.device,
                        dtype=x.dtype)
        else:
            r = weak_scalar((lo + hi) / 2.0, x)
        return [torch.where(x > 0, x, r * x)], []
    if t == "gelu":
        return [gelu_exact(x)], []
    raise ValueError(f"act_type {t}")


register("LeakyReLU", inputs=_lrelu_inputs, full=_lrelu_fwd, need_rng=True,
         attr_spec={"act_type": (None, "leaky"), "slope": (parse_float, 0.25),
                    "lower_bound": (parse_float, 0.125),
                    "upper_bound": (parse_float, 0.334)},
         infer_shape=_lrelu_infer)


# --------------------------------------------------------------------------
# Deconvolution and UpSampling
# --------------------------------------------------------------------------
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d}


def conv_transpose(data, weight, stride, pad, adj, groups):
    """``lax.conv_transpose`` as the JAX package calls it: the input dilated
    by ``stride`` and padded ``k - 1 - p`` before and ``k - 1 - p + adj``
    after, so ``out = (in - 1) * s + k - 2p + adj``; weight (cin, nf / ng,
    k...). PyTorch's ``output_padding`` must stay below the stride and
    its padding at most ``k - 1``: outside those, the full transposed
    convolution (no padding) is cropped by ``p`` before and padded with
    zeros (or cropped) by ``adj - p`` after, which is the same function."""
    fn = _CONV_T[len(stride)]
    kernel = weight.shape[2:]
    if all(a < s and p <= k - 1 for a, s, p, k in zip(adj, stride, pad,
                                                        kernel)):
        return fn(data, weight, None, stride, pad, adj, groups)
    full = fn(data, weight, None, stride, 0, 0, groups)
    widths = []
    for p, a in zip(reversed(pad), reversed(adj)):
        widths += [-p, a - p]
    return F.pad(full, widths)


def _deconv_infer(attrs, in_shapes):
    kernel = parse_tuple(attrs["kernel"])
    nf = parse_int(attrs["num_filter"])
    ng = parse_int(attrs.get("num_group", 1))
    no_bias = parse_bool(attrs.get("no_bias", True))
    nd = len(kernel)
    stride = _ntuple(attrs.get("stride"), nd, 1)
    pad = _ntuple(attrs.get("pad"), nd, 0)
    adj = _ntuple(attrs.get("adj"), nd, 0)
    data_s = in_shapes[0]
    w_s, out_s = None, None
    if data_s is not None:
        w_s = (data_s[1], nf // ng) + kernel
        spatial = tuple(stride[i] * (data_s[2 + i] - 1) + kernel[i]
                        - 2 * pad[i] + adj[i] for i in range(nd))
        out_s = (data_s[0], nf) + spatial
    return [data_s, w_s] + ([] if no_bias else [(nf,)]), [out_s], []


@register("Deconvolution", inputs=_fc_inputs,
          attr_spec={**_CONV_ATTRS, "adj": (parse_tuple, None),
                     "target_shape": (parse_tuple, None),
                     "no_bias": (parse_bool, True)},
          infer_shape=_deconv_infer)
def _deconvolution(attrs, data, weight, bias=None):
    """1-D or 2-D transposed convolution (``conv_transpose``), grouped by
    ``num_group``; MXNet's weight layout (cin, nf / ng, k...) is
    PyTorch's. ``target_shape`` and ``dilate`` are parsed and not read,
    as in the JAX package."""
    kernel = parse_tuple(attrs["kernel"])
    nd = len(kernel)
    if nd not in _CONV_T:
        raise ValueError(f"Deconvolution: a {nd}-D kernel; 1-D and 2-D "
                         "only")
    out = conv_transpose(data, weight.to(data.dtype),
                         _ntuple(attrs.get("stride"), nd, 1),
                         _ntuple(attrs.get("pad"), nd, 0),
                         _ntuple(attrs.get("adj"), nd, 0),
                         parse_int(attrs.get("num_group", 1)))
    if bias is not None:
        out = out + bias.to(data.dtype).reshape((1, -1) + (1,) * nd)
    return out


def _upsampling_inputs(attrs):
    if attrs.get("sample_type", "nearest") == "bilinear":
        return ["data", "weight"]
    return [f"arg{i}" for i in range(parse_int(attrs.get("num_args", 1)))]


@register("UpSampling", inputs=_upsampling_inputs,
          attr_spec={"scale": (parse_int, 2), "num_filter": (parse_int, 0),
                     "sample_type": (None, "nearest"),
                     "multi_input_mode": (None, "concat"),
                     "num_args": (parse_int, 1),
                     "workspace": (parse_int, 512)})
def _upsampling(attrs, *xs):
    """``nearest``: every input repeated up to the first input's size times
    ``scale``, then concatenated over channels or summed
    (``multi_input_mode``). ``bilinear``: a transposed convolution grouped
    by channel with the (C, 1, k, k) weight given, stride ``scale`` and
    padding ``k - 1 - ceil((scale - 1) / 2)`` on each side, k = 2 scale -
    scale % 2 (the JAX package's padding, whatever the weight's size)."""
    scale = parse_int(attrs.get("scale", 2))
    if attrs.get("sample_type", "nearest") == "nearest":
        th, tw = xs[0].shape[2] * scale, xs[0].shape[3] * scale
        outs = [x.repeat_interleave(th // x.shape[2], dim=2)
                .repeat_interleave(tw // x.shape[3], dim=3) for x in xs]
        if len(outs) == 1:
            return outs[0]
        if attrs.get("multi_input_mode", "concat") == "sum":
            return sum(outs)
        return torch.cat(outs, dim=1)
    data, weight = xs
    k = 2 * scale - scale % 2
    lo = k - 1 - int(np.ceil((scale - 1) / 2.0))
    pad = tuple(kw - 1 - lo for kw in weight.shape[2:])
    return conv_transpose(data, weight.to(data.dtype), (scale, scale), pad,
                          (0, 0), data.shape[1])


# --------------------------------------------------------------------------
# InstanceNorm, L2Normalization, SoftmaxActivation
# --------------------------------------------------------------------------
def _in_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    c = (data_s[1],) if data_s is not None else None
    return [data_s, c, c], [data_s], []


@register("InstanceNorm", inputs=("data", "gamma", "beta"),
          attr_spec={"eps": (parse_float, 1e-3)}, infer_shape=_in_infer)
def _instance_norm(attrs, data, gamma, beta):
    """Per sample and channel over the spatial axes, in data's dtype:
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` (biased var)."""
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + attrs.get("eps", 1e-3)) * \
        gamma.reshape(bshape) + beta.reshape(bshape)


_L2_AXES = {"instance": lambda nd: tuple(range(1, nd)),
            "channel": lambda nd: (1,),
            "spatial": lambda nd: tuple(range(2, nd))}


@register("L2Normalization", inputs=("data",),
          attr_spec={"eps": (parse_float, 1e-10), "mode": (None, "instance")},
          infer_shape=_id_infer)
def _l2_normalization(attrs, data):
    """``x / sqrt(sum(x^2) + eps)`` over every axis but the batch
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``)."""
    mode = attrs.get("mode", "instance")
    if mode not in _L2_AXES:
        raise ValueError(f"L2Normalization: mode {mode!r}")
    norm = torch.sqrt(torch.sum(torch.square(data), dim=_L2_AXES[mode](
        data.ndim), keepdim=True) + attrs.get("eps", 1e-10))
    return data / norm


@register("SoftmaxActivation", inputs=("data",),
          attr_spec={"mode": (None, "instance")}, infer_shape=_id_infer)
def _softmax_activation(attrs, x):
    """Softmax over the channel axis (``channel``), or over all but the
    batch axis (``instance``)."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


# --------------------------------------------------------------------------
# Crop
# --------------------------------------------------------------------------
@register("Crop", inputs=lambda attrs: ["data", "crop_like"][:parse_int(
    attrs.get("num_args", 1))],
    attr_spec={"num_args": (parse_int, 1), "offset": (parse_tuple, (0, 0)),
               "h_w": (parse_tuple, (0, 0)),
               "center_crop": (parse_bool, False)})
def _crop_op(attrs, data, crop_like=None):
    """An (h, w) window of the last two axes (``crop_like``'s, else
    ``h_w``) at ``offset`` (or centred). As ``lax.dynamic_slice`` does, a
    negative start counts from the end, then each start is clamped into
    [0, dim - size], so the window always lies inside the input; a window
    larger than the input raises."""
    oy, ox = attrs.get("offset", (0, 0))
    if crop_like is not None:
        h, w = crop_like.shape[2], crop_like.shape[3]
    else:
        h, w = attrs.get("h_w", (0, 0))
    H, W = data.shape[2], data.shape[3]
    if h > H or w > W:
        raise ValueError(f"Crop: a ({h}, {w}) window of {tuple(data.shape)}")
    if parse_bool(attrs.get("center_crop", False)):
        oy, ox = (H - h) // 2, (W - w) // 2
    oy, ox = (o + dim if o < 0 else o for o, dim in ((oy, H), (ox, W)))
    oy, ox = min(max(oy, 0), H - h), min(max(ox, 0), W - w)
    return data[:, :, oy:oy + h, ox:ox + w]


# --------------------------------------------------------------------------
# Sequence ops (time-major: axis 0 is time; ``sequence_length`` (B,) is
# truncated to int32, as the JAX package's ``astype`` does)
# --------------------------------------------------------------------------
def _seq_inputs(attrs):
    if parse_bool(attrs.get("use_sequence_length", False)):
        return ["data", "sequence_length"]
    return ["data"]


def _seq_lengths(sequence_length, ndim):
    """The lengths as int32, shaped (1, B, 1, ...) against (T, B, ...)."""
    return sequence_length.to(torch.int32).reshape((1, -1) + (1,) *
                                                   (ndim - 2))


@register("SequenceLast", inputs=_seq_inputs,
          attr_spec={"use_sequence_length": (parse_bool, False)})
def _sequence_last(attrs, data, sequence_length=None):
    """The last step, or step ``length - 1`` of each sequence through
    ``take_along_axis``' default mode (length 0 reads the last step,
    a length past T gives NaN)."""
    if sequence_length is None:
        return data[-1]
    return _take_along(data, _seq_lengths(sequence_length, data.ndim) - 1,
                       0)[0]


@register("SequenceMask", inputs=_seq_inputs,
          attr_spec={"use_sequence_length": (parse_bool, False),
                     "value": (parse_float, 0.0)})
def _sequence_mask(attrs, data, sequence_length=None):
    """Steps at or past each sequence's length set to ``value``."""
    if sequence_length is None:
        return data
    t = data.shape[0]
    steps = torch.arange(t, dtype=torch.int32, device=data.device).reshape(
        (t,) + (1,) * (data.ndim - 1))
    return torch.where(steps < _seq_lengths(sequence_length, data.ndim),
                       data, torch.tensor(attrs.get("value", 0.0),
                                          dtype=data.dtype,
                                          device=data.device))


@register("SequenceReverse", inputs=_seq_inputs,
          attr_spec={"use_sequence_length": (parse_bool, False)})
def _sequence_reverse(attrs, data, sequence_length=None):
    """Time reversed, or each sequence's first ``length`` steps reversed
    and the rest kept (a length past T reads past the end: NaN, as
    ``take_along_axis`` fills)."""
    if sequence_length is None:
        return torch.flip(data, dims=(0,))
    t = data.shape[0]
    lengths = sequence_length.to(torch.int32)[None, :]
    steps = torch.arange(t, dtype=torch.int32, device=data.device)[:, None]
    idx = torch.where(steps < lengths, lengths - 1 - steps, steps)
    return _take_along(data, idx.reshape(idx.shape + (1,) * (data.ndim - 2)),
                       0)


# --------------------------------------------------------------------------
# ROIPooling: the JAX composition masks the whole (C, H, W) image once per
# output cell; here the same max is taken in two separable stages (the
# x-bins of every row, then the y-bins of those row maxima) over chunks
# of ROIs, and the backward recomputes a chunk at a time
# --------------------------------------------------------------------------
#: elements of one chunk's largest intermediate (float32: 128 MiB)
ROI_CHUNK_ELEMS = 1 << 25


def roi_bins(rois, scale, pooled, size, batch):
    """Per ROI its batch index (negative counts from the end, then clamped,
    as JAX indexing does) and the masks of its y-bins (R, ph, H) and
    x-bins (R, pw, W): corners ``round(coord * scale)`` (half to even),
    bin i of a side of length L >= 1 from ``start + floor(i L / n)`` to
    ``start + ceil((i + 1) L / n)``, cut at the image's edge."""
    b = rois[:, 0].to(torch.int32).to(torch.int64)
    b = torch.where(b < 0, b + batch, b).clamp(0, batch - 1)
    corners = torch.round(rois[:, 1:5] * scale).to(torch.int32)
    x1, y1, x2, y2 = corners.unbind(1)
    masks = []
    for lo, hi, n, dim in ((y1, y2, pooled[0], size[0]),
                           (x1, x2, pooled[1], size[1])):
        length = torch.clamp(hi - lo + 1, min=1)[:, None]
        i = torch.arange(n, dtype=torch.int32, device=rois.device)[None]
        start = lo[:, None] + (i * length) // n
        end = torch.clamp(lo[:, None] + ((i + 1) * length + n - 1) // n,
                          max=dim)
        pos = torch.arange(dim, dtype=torch.int32, device=rois.device)
        masks.append((pos >= start[..., None]) & (pos < end[..., None]))
    return b, masks[0], masks[1]


def _roi_pool_chunk(img, ymask, xmask):
    """Max of img (r, C, H, W) over each (y-bin, x-bin) cell, in two
    stages, -inf outside a bin; an empty cell gives 0. (r, C, ph, pw)."""
    neg = torch.full((), float("-inf"), dtype=img.dtype, device=img.device)
    rows = torch.where(xmask[:, None, None], img[:, :, :, None, :],
                       neg).amax(dim=-1)                   # (r, C, H, pw)
    cells = torch.where(ymask[:, None, :, :, None], rows[:, :, None],
                        neg).amax(dim=3)                   # (r, C, ph, pw)
    full = ymask.any(-1)[:, :, None] & xmask.any(-1)[:, None, :]
    return torch.where(full[:, None], cells, torch.zeros((), dtype=img.dtype,
                                                         device=img.device))


def _roi_chunk(data, pooled):
    _, c, h, w = data.shape
    return max(1, ROI_CHUNK_ELEMS // max(1, c * h * w * max(pooled)))


class _ROIPoolFn(torch.autograd.Function):
    """Forward: ``_roi_pool_chunk`` over chunks of ROIs, nothing kept but
    the inputs. Backward: each chunk recomputed with autograd on and its
    gradient added into the image's (``amax`` splits a cell's gradient
    evenly among ties at each stage: the joint max of the JAX package
    splits it evenly among the cell's ties, which agrees wherever the tied
    rows of a cell hold equally many tied maxima, as a cell of zeros
    does)."""

    @staticmethod
    def forward(ctx, data, b, ymask, xmask):
        ctx.save_for_backward(data, b, ymask, xmask)
        ctx.step = step = _roi_chunk(data, (ymask.shape[1], xmask.shape[1]))
        out = data.new_empty((b.shape[0], data.shape[1], ymask.shape[1],
                              xmask.shape[1]))
        for i in range(0, b.shape[0], step):
            out[i:i + step] = _roi_pool_chunk(data[b[i:i + step]],
                                              ymask[i:i + step],
                                              xmask[i:i + step])
        return out

    @staticmethod
    def backward(ctx, g):
        data, b, ymask, xmask = ctx.saved_tensors
        grad = torch.zeros_like(data)
        for i in range(0, b.shape[0], ctx.step):
            rows = b[i:i + ctx.step]
            with torch.enable_grad():
                img = data[rows].detach().requires_grad_(True)
                out = _roi_pool_chunk(img, ymask[i:i + ctx.step],
                                      xmask[i:i + ctx.step])
                gi, = torch.autograd.grad(out, img, g[i:i + ctx.step])
            grad.index_add_(0, rows, gi)
        return grad, None, None, None


@register("ROIPooling", inputs=("data", "rois"),
          attr_spec={"pooled_size": (parse_tuple, None),
                     "spatial_scale": (parse_float, 1.0)})
def _roi_pooling(attrs, data, rois):
    """rois (R, 5): (batch index, x1, y1, x2, y2) in input pixels, scaled
    by ``spatial_scale``; out (R, C, ph, pw), the max over each bin
    (``roi_bins``). The ROIs get no gradient."""
    b, ymask, xmask = roi_bins(rois.detach(), attrs["spatial_scale"],
                               attrs["pooled_size"], data.shape[2:],
                               data.shape[0])
    return _ROIPoolFn.apply(data, b, ymask, xmask)


# --------------------------------------------------------------------------
# BilinearSampler, GridGenerator, SpatialTransformer
# --------------------------------------------------------------------------
def bilinear_sample(data, grid):
    """The JAX package's sampler: grid (N, 2, Ho, Wo) of (x, y) in [-1, 1]
    mapped to pixels ``(g + 1) * (size - 1) / 2``; the four neighbours of
    each point gathered (a neighbour outside the image counts 0) and
    weighted by the fractional parts. Gradients reach data (a scatter-add
    of the gather) and grid (through the weights)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = data.reshape(n, c, h * w)

    def gather(yy, xx):
        yi = torch.nan_to_num(yy).clamp(0, h - 1).to(torch.int64)
        xi = torch.nan_to_num(xx).clamp(0, w - 1).to(torch.int64)
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        out = torch.gather(flat, 2, idx).reshape((n, c) + tuple(yy.shape[1:]))
        return out * valid[:, None].to(data.dtype)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
            v10 * (1 - wx) * wy + v11 * wx * wy)


register("BilinearSampler", inputs=("data", "grid"),
         simple=lambda attrs, data, grid: bilinear_sample(data, grid))


def _linspace(n, device):
    """``jnp.linspace(-1, 1, n)`` in float32, as JAX computes it:
    ``-1 * (1 - t) + 1 * t`` at t = i / (n - 1), the last point 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([-(1 - t) + t, torch.ones(1, device=device)])


def affine_grid(loc, target_shape):
    """The affine grid of (N, 6) ``loc`` over a (h, w) target: theta (N, 2,
    3) times the homogeneous (x, y, 1) of ``linspace(-1, 1)`` points, as
    (N, 2, h, w)."""
    h, w = target_shape
    n = loc.shape[0]
    ys, xs = torch.meshgrid(_linspace(h, loc.device), _linspace(w, loc.device),
                            indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1),
                          torch.ones(h * w, device=loc.device)])
    theta = loc.reshape(n, 2, 3)
    return torch.matmul(theta, coords.to(theta.dtype)).reshape(n, 2, h, w)


@register("GridGenerator", inputs=("data",),
          attr_spec={"transform_type": (None, "affine"),
                     "target_shape": (parse_tuple, (0, 0))})
def _grid_generator(attrs, data):
    """``affine``: ``affine_grid`` of the (N, 6) data. ``warp``: the (N, 2,
    h, w) flow plus each pixel's own (x, y), mapped to [-1, 1] as
    ``(v * 2) / (size - 1) - 1``."""
    if attrs.get("transform_type", "affine") == "affine":
        return affine_grid(data, attrs["target_shape"])
    n, _, h, w = data.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=data.dtype, device=data.device),
        torch.arange(w, dtype=data.dtype, device=data.device), indexing="ij")
    gx = (data[:, 0] + xs) * 2 / (w - 1) - 1
    gy = (data[:, 1] + ys) * 2 / (h - 1) - 1
    return torch.stack([gx, gy], dim=1)


@register("SpatialTransformer", inputs=("data", "loc"),
          attr_spec={"target_shape": (parse_tuple, (0, 0)),
                     "transform_type": (None, "affine"),
                     "sampler_type": (None, "bilinear")})
def _spatial_transformer(attrs, data, loc):
    """``bilinear_sample`` of data on the affine grid of ``loc``."""
    return bilinear_sample(data, affine_grid(loc, attrs["target_shape"]))


# --------------------------------------------------------------------------
# Correlation: the JAX package's composition, which shifts with a
# wrap-around roll, takes the mean over channels and reads neither
# ``kernel_size``, ``stride1`` nor ``is_multiply`` (MXNet does none of
# these; the port copies them)
# --------------------------------------------------------------------------
def _wrapped(x, dim, start, length):
    """``length`` entries of ``x`` along ``dim`` from ``start``, taken
    modulo its size (``jnp.roll``'s wrap-around): a view where they do not
    wrap, else two views joined."""
    size = x.shape[dim]
    start %= size
    if start + length <= size:
        return x.narrow(dim, start, length)
    head = size - start
    return torch.cat([x.narrow(dim, start, head),
                      _wrapped(x, dim, 0, length - head)], dim=dim)


@register("Correlation", inputs=("data1", "data2"),
          attr_spec={"kernel_size": (parse_int, 1),
                     "max_displacement": (parse_int, 1),
                     "stride1": (parse_int, 1), "stride2": (parse_int, 1),
                     "pad_size": (parse_int, 0),
                     "is_multiply": (parse_bool, True)},
          num_outputs=2, num_visible=1, output_names=["output", "tmp"])
def _correlation(attrs, data1, data2):
    """Both inputs zero-padded by ``pad_size``; for each displacement (dy,
    dx) in ``range(-md, md + 1, stride2)`` squared, the channel mean of
    ``data1 * roll(data2, (-dy, -dx))`` over the padded extent, then the
    padding cropped off. Computed on the kept region alone (there the
    padded data1 is data1), from windows of the padded data2 that wrap
    around its edges (``_wrapped``). Outputs (N, D * D, H, W) and a (1,)
    zero."""
    md, s2 = attrs["max_displacement"], attrs["stride2"]
    pad = attrs["pad_size"]
    d2 = F.pad(data2, [pad] * 4)
    n_y, n_x = data1.shape[2], data1.shape[3]
    disp = range(-md, md + 1, s2)
    out = torch.stack([
        (data1 * _wrapped(_wrapped(d2, 2, pad + dy, n_y), 3, pad + dx,
                          n_x)).mean(dim=1)
        for dy in disp for dx in disp], dim=1)
    return out, torch.zeros((1,), dtype=data1.dtype, device=data1.device)
