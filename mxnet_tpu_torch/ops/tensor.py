"""Tensor ops of the decode graph, as plain PyTorch.

The subset of the JAX package's ``ops/tensor.py`` that the transformer LM
binds: ``Reshape`` with its special codes, ``transpose``, ``slice_axis``,
``dot``, elementwise and broadcast add, ``expand_dims``, ``_arange`` and
the ``Embedding`` composition — plus ``Flatten``, which the image
classifiers bind, and ``sum`` (alias ``sum_axis``) and the unary
``relu``, which imperative autograd code calls, and the samplers
(``_random_uniform`` ... ``_random_generalized_negative_binomial`` and
their aliases: ``sample``). Every op here except ``Embedding`` and the
samplers is plain PyTorch on both devices, as the JAX package leaves them
to XLA; ``Embedding`` gets its CUDA kernel as the ``"cuda"`` variant in
``cuda_kernels.py``, and so do the samplers (the threefry kernel's
uniform draws).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..base import (MXNetError, parse_tuple, parse_bool, parse_int,
                    parse_float, merge_shape, str_to_attr)
from .registry import register, alias


def _axis_param(val):
    """An ``axis`` attr: None, an int or a tuple of ints."""
    if val is None or val == "None" or val == "()":
        return None
    if isinstance(val, str):
        val = str_to_attr(val)
    if isinstance(val, (int, np.integer)):
        return int(val)
    return tuple(int(v) for v in val)


_REDUCE_ATTRS = {"axis": (_axis_param, None), "keepdims": (parse_bool, False),
                 "exclude": (parse_bool, False)}


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


@register("sum", inputs=("data",), attr_spec=dict(_REDUCE_ATTRS))
def _sum(attrs, x):
    """The sum over ``axis`` (all axes when None; the axes NOT listed
    under ``exclude``), in the input's dtype as ``jnp.sum`` keeps it
    (bool sums to int32)."""
    axis = attrs.get("axis")
    keepdims = attrs.get("keepdims", False)
    if axis is None:
        axis = tuple(range(x.ndim))
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    axis = tuple(a % x.ndim for a in axis)
    if attrs.get("exclude", False):
        axis = tuple(i for i in range(x.ndim) if i not in axis)
    dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    if not axis:
        return x.to(dtype).clone()
    return torch.sum(x, dim=axis, keepdim=keepdims, dtype=dtype)


alias("sum_axis", "sum")


@register("relu", inputs=("data",), infer_shape=_infer_elemwise)
def _relu(attrs, x):
    # torch.maximum, as Activation(act_type="relu"): at x == 0 its
    # gradient splits 1/2-1/2 between the operands as jnp.maximum's does
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


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
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)       # Python semantics: begin < 0 too
    return x[tuple(idx)]


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


# --------------------------------------------------------------------------
# samplers: the JAX package's ``_random_*`` ops on the ``mx.random`` chain
# --------------------------------------------------------------------------
#: sampler -> its attrs beyond shape and dtype
_SAMPLER_EXTRA = {
    "_random_uniform": {"low": (parse_float, 0.0), "high": (parse_float, 1.0)},
    "_random_normal": {"loc": (parse_float, 0.0), "scale": (parse_float, 1.0)},
    "_random_gamma": {"alpha": (parse_float, 1.0), "beta": (parse_float, 1.0)},
    "_random_exponential": {"lam": (parse_float, 1.0)},
    "_random_poisson": {"lam": (parse_float, 1.0)},
    "_random_negative_binomial": {"k": (parse_int, 1), "p": (parse_float, 1.0)},
    "_random_generalized_negative_binomial": {
        "mu": (parse_float, 1.0), "alpha": (parse_float, 1.0)},
}


def _key_generator(key, device):
    """A PyTorch generator on ``device`` seeded with the key's 64 bits."""
    k0, k1 = _random.key_words(key)
    return torch.Generator(device=device).manual_seed((k0 << 32) | k1)


def _gamma(alpha, shape, gen, device):
    conc = torch.full(shape, float(alpha), dtype=torch.float32,
                      device=device)
    return torch._standard_gamma(conc, generator=gen)


def sample(name, attrs, key, device, uniform=None):
    """One draw of sampler ``name`` under ``key`` on ``device``.

    Uniform, normal and exponential draws are the JAX package's bits
    (``mx.random.draw``; uniform bit for bit, normal and exponential
    within a few float32 ulps, since ``erfinv`` and ``log1p`` are not
    XLA's polynomials), through ``uniform(key, shape, lo, hi, transform,
    dtype)`` where the caller passes one (the card's threefry kernel, in
    float32, bfloat16 or float16) and the plain version otherwise. Gamma, Poisson and the two negative
    binomials draw with PyTorch's samplers (``torch._standard_gamma``,
    ``torch.poisson``) under a generator seeded from the key: their
    draws are the JAX package's in distribution (moments), not in value."""
    from ..ndarray import to_torch_dtype
    shape = tuple(attrs.get("shape", ()))
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))

    def base(transform, lo=0.0, hi=1.0):
        if uniform is None:
            return _random.draw(key, shape, transform, lo, hi, dtype,
                                device)
        return uniform(key, shape, lo, hi, transform, dtype)

    if name == "_random_uniform":
        return base(_random.UNIFORM, attrs.get("low", 0.0),
                    attrs.get("high", 1.0))
    if name == "_random_normal":
        return attrs.get("loc", 0.0) + attrs.get("scale", 1.0) * \
            base(_random.NORMAL)
    if name == "_random_exponential":
        return base(_random.EXPONENTIAL) / attrs.get("lam", 1.0)
    gen = _key_generator(key, device)
    if name == "_random_gamma":
        out = _gamma(attrs.get("alpha", 1.0), shape, gen, device) * \
            attrs.get("beta", 1.0)
    elif name == "_random_poisson":
        out = torch.poisson(torch.full(shape, float(attrs.get("lam", 1.0)),
                                       device=device), generator=gen)
    else:
        if name == "_random_negative_binomial":
            r, p = attrs.get("k", 1), attrs.get("p", 0.5)
        else:
            r = 1.0 / attrs.get("alpha", 1.0)
            p = r / (r + attrs.get("mu", 1.0))
        lam = _gamma(r, shape, gen, device) * (1 - p) / p
        out = torch.poisson(lam, generator=gen)
    return out.to(dtype)


def _register_sampler(name):
    def forward(attrs, inputs, aux, is_train, rng):
        return [sample(name, attrs, rng, torch.device("cpu"))], []
    register(name, inputs=(), full=forward, need_rng=True,
             attr_spec={"shape": (parse_tuple, ()),
                        "dtype": (None, "float32"),
                        **_SAMPLER_EXTRA[name]},
             infer_shape=lambda attrs, in_shapes: (
                 [], [tuple(attrs.get("shape", ()))], []))


for _name in _SAMPLER_EXTRA:
    _register_sampler(_name)
for _alias, _name in (
        ("uniform", "_random_uniform"), ("random_uniform", "_random_uniform"),
        ("normal", "_random_normal"), ("random_normal", "_random_normal"),
        ("random_gamma", "_random_gamma"),
        ("random_exponential", "_random_exponential"),
        ("random_poisson", "_random_poisson"),
        ("random_negative_binomial", "_random_negative_binomial"),
        ("random_generalized_negative_binomial",
         "_random_generalized_negative_binomial")):
    alias(_alias, _name)
