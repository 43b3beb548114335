"""Tensor ops, as plain PyTorch: the port of the JAX package's
``ops/tensor.py``.

The families of the reference's NNVM tensor surface, in the JAX package's
table-driven form and with its op names, attribute names and defaults (so
a symbol file crosses between the packages): the unary math family,
``BlockGrad`` / ``make_loss`` / ``smooth_l1`` / ``Cast``, the binary
family (``elemwise_*``, ``broadcast_*``, the ``_*_scalar`` forms, the
reflected scalar forms and the short aliases), ``add_n``,
``broadcast_axis`` / ``broadcast_to``, the reductions, the init ops, the
matrix ops (``dot``, ``batch_dot``, ``transpose``, ``Reshape``,
``slice`` ... ``Pad``), indexing (``Embedding``, ``take``, ``pick``,
``one_hot``, ``where``), ordering (``sort``, ``argsort``, ``topk``) and
the samplers. None of these has a Pallas kernel in the JAX package (they
are XLA's), so every op here is plain PyTorch on both devices; the two
exceptions carry hand-written kernels as their ``"cuda"`` variants,
attached in ``cuda_kernels.py``: ``Embedding`` (the gather) and the
samplers (the threefry kernel's uniform draws). Gradients are autograd's
over these bodies.

Where the JAX function and PyTorch's nearest call differ, the body
follows the JAX function, and the comment at the place names the trap:
the scalar forms cast the scalar to the array's dtype (``int32 * 2.5``
multiplies by 2); ``abs``, ``clip``, ``max`` / ``min`` and ``norm`` have
JAX's gradients at their kinks; ``sort`` / ``argsort`` flip the stable
ascending order for ``is_ascend=False`` and ``topk`` takes the lower
index among ties; ``take``, ``pick`` and ``one_hot`` treat out-of-range
indices as the JAX calls do. Two faults of the reference are copied on
purpose: ``round`` rounds half to even (``jnp.round``; MXNet rounds half
away from zero) and ``gamma`` is ``exp(gammaln(x))``, which is |Γ(x)|
for a negative non-integer x. Integer ``**`` with a negative exponent
truncates, as MXNet does, where the JAX package overflows or raises
(``ROADMAP.md`` §C pins both).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import (parse_tuple, parse_bool, parse_int, parse_float,
                    merge_shape, str_to_attr)
from .registry import register, alias


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
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


def _torch_dtype(dtype):
    from ..ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _const(value, like):
    """``value`` as a 0-d tensor of ``like``'s dtype on its device, as
    ``jnp.asarray(value, dtype=a.dtype)`` makes it: a float cast to an
    integer type truncates toward zero (2.5 -> 2, -2.5 -> -2), and a
    16-bit type rounds the scalar before the op (PyTorch would keep a
    Python scalar in float32 and round only the result)."""
    dtype = like.dtype
    if dtype == torch.bool:
        value = bool(value)
    elif not dtype.is_floating_point:
        value = int(value)
    return torch.full((), value, dtype=dtype, device=like.device)


def _inexact(x):
    """``x`` promoted as JAX promotes an integer input of a floating
    function (``promote_args_inexact``): to float32."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


class _AbsFn(torch.autograd.Function):
    """``|x|`` with ``lax.abs``'s gradient: ``g`` where ``x >= 0``, ``-g``
    elsewhere. Trap: at x == 0 JAX passes ``g``, ``torch.abs`` passes 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    return _AbsFn.apply(x) if x.dtype.is_floating_point else torch.abs(x)


def _sign(x):
    # trap: torch.sign(NaN) is 0, jnp.sign(NaN) is NaN
    if x.dtype.is_floating_point:
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


def _gammaln(x):
    # lgamma in float32, back to the input's dtype (an integer input
    # stays integer), as the JAX package's ``_GAMMALN``
    return torch.lgamma(x.to(torch.float32)).to(x.dtype)


def _hypot(a, b):
    """``jnp.hypot``'s composition, with its gradient (torch.hypot's is NaN
    at (0, 0), JAX's composition gives 1/2 to each operand there)."""
    a, b = _inexact(a), _inexact(b)
    a, b = _abs(a), _abs(b)
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    ratio = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * torch.sqrt(1 + ratio * ratio))
    return torch.where(inf, torch.full((), math.inf, dtype=out.dtype,
                                       device=out.device), out)


def _fill_value(dtype):
    """``jnp.take`` / ``take_along_axis``'s fill for an out-of-range index:
    NaN for floating types, the most negative value for signed integers,
    the largest for unsigned ones."""
    if dtype.is_floating_point:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _take_along(data, idx, axis):
    """``jnp.take_along_axis(data, idx, axis)`` in its default mode: an
    index in [-n, 0) counts from the end, any other out-of-range index
    gives the fill value (NaN for floats) and no gradient."""
    n = data.shape[axis]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    shape = list(data.shape)
    shape[axis] = idx.shape[axis]
    idx = idx.expand(shape) if list(idx.shape) != shape else idx
    valid = valid.expand(shape) if list(valid.shape) != shape else valid
    got = torch.gather(data, axis, idx.clamp(0, max(n - 1, 0)))
    return torch.where(valid, got, torch.full(
        (), _fill_value(data.dtype), dtype=data.dtype, device=data.device))


# --------------------------------------------------------------------------
# unary math family (JAX ``ops/tensor.py`` ``_UNARY``)
# --------------------------------------------------------------------------
_UNARY = {
    "abs": _abs, "arccos": torch.arccos, "arccosh": torch.arccosh,
    "arcsin": torch.arcsin, "arcsinh": torch.arcsinh,
    "arctan": torch.arctan, "arctanh": torch.arctanh,
    "ceil": torch.ceil, "cos": torch.cos, "cosh": torch.cosh,
    "degrees": lambda x: _inexact(x) * _const(180.0 / math.pi,
                                              _inexact(x)),
    "exp": torch.exp, "expm1": torch.expm1, "fix": torch.trunc,
    "floor": torch.floor,
    # fault of the reference, copied: exp(lgamma(x)) is |Γ(x)| for a
    # negative non-integer x (Γ(-0.5) = -3.5449..., this gives +3.5449...)
    "gamma": lambda x: torch.exp(_gammaln(x)), "gammaln": _gammaln,
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2, "negative": torch.negative,
    "radians": lambda x: _inexact(x) * _const(math.pi / 180.0,
                                              _inexact(x)),
    # torch.maximum, as Activation(act_type="relu"): at x == 0 its
    # gradient splits 1/2-1/2 between the operands as jnp.maximum's does
    "relu": lambda x: torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)),
    # half to even, as torch.round: MXNet's round goes half away from
    # zero, the JAX package's (jnp.round) half to even, a fault copied
    "rint": torch.round, "round": torch.round,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "sigmoid": torch.sigmoid, "sign": _sign, "sin": torch.sin,
    "sinh": torch.sinh, "sqrt": torch.sqrt, "square": torch.square,
    "tan": torch.tan, "tanh": torch.tanh,
}

for _name, _fn in _UNARY.items():
    register(_name, inputs=("data",),
             simple=(lambda attrs, x, _f=_fn: _f(x)),
             infer_shape=_infer_elemwise)

register("_copy", inputs=("data",), simple=lambda attrs, x: x,
         infer_shape=_infer_elemwise)
alias("identity", "_copy")


@register("BlockGrad", inputs=("data",), infer_shape=_infer_elemwise)
def _block_grad(attrs, x):
    return x.detach()


alias("stop_gradient", "BlockGrad")


@register("make_loss", inputs=("data",), infer_shape=_infer_elemwise)
def _make_loss_t(attrs, x):
    return x


@register("smooth_l1", inputs=("data",),
          attr_spec={"scalar": (parse_float, 1.0)},
          infer_shape=_infer_elemwise)
def _smooth_l1(attrs, x):
    sigma2 = attrs.get("scalar", 1.0) ** 2
    absx = _abs(x)
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                       absx - 0.5 / sigma2)


@register("Cast", inputs=("data",), attr_spec={"dtype": (None, "float32")},
          infer_shape=_infer_elemwise)
def _cast(attrs, x):
    return x.to(_torch_dtype(attrs.get("dtype", "float32")))


alias("cast", "Cast")


# --------------------------------------------------------------------------
# binary family: elemwise, broadcast, scalar (JAX ``_BINARY``)
# --------------------------------------------------------------------------
def _compare(fn):
    """A comparison whose 0/1 result takes the left operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide,
    # integer arrays to a negative exponent truncate (MXNet's integer
    # power; the JAX package overflows): ROADMAP.md §C
    "power": torch.pow,
    "hypot": _hypot, "maximum": torch.maximum, "minimum": torch.minimum,
    "equal": _compare(torch.eq), "not_equal": _compare(torch.ne),
    "greater": _compare(torch.gt), "greater_equal": _compare(torch.ge),
    "lesser": _compare(torch.lt), "lesser_equal": _compare(torch.le),
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
    "mod": torch.remainder,
}


def _scalar_op(fn, reflected=False):
    """``fn(a, s)`` (or ``fn(s, a)``) with the scalar attr cast to the
    array's dtype first, as ``jnp.asarray(scalar, dtype=a.dtype)`` does.
    Trap: PyTorch would promote ``int32 * 2.5`` to float; here it
    multiplies by 2 and stays int32."""
    def run(attrs, a):
        s = _const(attrs.get("scalar", 0.0), a)
        return fn(s, a) if reflected else fn(a, s)
    return run


for _name, _fn in _BINARY.items():
    register(f"elemwise_{_name}" if _name in ("add", "sub", "mul", "div")
             else f"_{_name}",
             inputs=("lhs", "rhs"),
             simple=(lambda attrs, a, b, _f=_fn: _f(a, b)),
             infer_shape=_infer_elemwise)
    register(f"broadcast_{_name}", inputs=("lhs", "rhs"),
             simple=(lambda attrs, a, b, _f=_fn: _f(a, b)))
    register(f"_{_name}_scalar", inputs=("data",),
             attr_spec={"scalar": (parse_float, 0.0)},
             simple=_scalar_op(_fn), infer_shape=_infer_elemwise)

for _name, _fn in (("rsub", torch.sub), ("rdiv", torch.true_divide),
                   ("rpower", torch.pow), ("rmod", torch.remainder)):
    register(f"_{_name}_scalar", inputs=("data",),
             attr_spec={"scalar": (parse_float, 0.0)},
             simple=_scalar_op(_fn, reflected=True),
             infer_shape=_infer_elemwise)

for _short, _canon in (("_plus", "elemwise_add"), ("_minus", "elemwise_sub"),
                       ("_mul", "elemwise_mul"), ("_div", "elemwise_div"),
                       ("_grad_add", "elemwise_add"),
                       ("_plus_scalar", "_add_scalar"),
                       ("_minus_scalar", "_sub_scalar"),
                       ("_rminus_scalar", "_rsub_scalar")):
    alias(_short, _canon)


@register("add_n", inputs=lambda attrs: [f"arg{i}" for i in range(
    int(attrs.get("num_args", 2)))],
    attr_spec={"num_args": (parse_int, 2)})
def _add_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


alias("ElementWiseSum", "add_n")
alias("_sum", "add_n")


@register("broadcast_axis", inputs=("data",),
          attr_spec={"axis": (_axis_param, None), "size": (_axis_param, None)})
def _broadcast_axis(attrs, x):
    axes, sizes = attrs.get("axis"), attrs.get("size")
    axes = (axes,) if isinstance(axes, int) else axes
    sizes = (sizes,) if isinstance(sizes, int) else sizes
    shape = list(x.shape)
    for ax, sz in zip(axes, sizes):
        shape[ax] = sz
    return x.expand(tuple(shape))


@register("broadcast_to", inputs=("data",),
          attr_spec={"shape": (parse_tuple, None)})
def _broadcast_to(attrs, x):
    tgt = list(attrs["shape"])
    for i, s in enumerate(tgt):
        if s == 0:
            tgt[i] = x.shape[i]
    return x.expand(tuple(tgt))


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------
def _reduce_dims(attrs, x):
    """The axes a reduction runs over: ``axis`` (all when None; the axes
    NOT listed under ``exclude``), as the JAX package's ``_reduce`` reads
    them (``exclude`` without ``axis`` reduces everything)."""
    axis = attrs.get("axis")
    if axis is None:
        return tuple(range(x.ndim))
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    axis = tuple(a % x.ndim for a in axis)
    if attrs.get("exclude", False):
        axis = tuple(i for i in range(x.ndim) if i not in axis)
    return axis


def _reducer(fn):
    """A reduction op over ``_reduce_dims``; ``fn(x, dims, keepdims)``.
    An empty axis list returns the input (``jnp.sum(x, axis=())``), where
    PyTorch's empty ``dim`` would reduce everything."""
    def impl(attrs, x):
        dims = _reduce_dims(attrs, x)
        if not dims:
            return x.clone()
        return fn(x, dims, attrs.get("keepdims", False))
    return impl


def _sum_fn(x, dims, keep):
    # in the input's dtype as ``jnp.sum`` keeps it (bool sums to int32)
    dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    return torch.sum(x, dim=dims, keepdim=keep, dtype=dtype)


def _prod_fn(x, dims, keep):
    # torch.prod takes one dim at a time; an integer input stays in its
    # dtype (torch.prod would widen it to int64)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep, dtype=x.dtype)
    return x


def _mean_fn(x, dims, keep):
    return torch.mean(_inexact(x), dim=dims, keepdim=keep)


def _nansum_fn(x, dims, keep):
    if not x.dtype.is_floating_point:
        return _sum_fn(x, dims, keep)
    return torch.nansum(x, dim=dims, keepdim=keep)


def _nanprod_fn(x, dims, keep):
    if x.dtype.is_floating_point:
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod_fn(x, dims, keep)


# max / min: torch.amax / amin split the gradient evenly between tied
# maxima, as jnp.max's does (torch.max(dim=) would give it to one)
for _name, _fn in (("sum", _sum_fn), ("mean", _mean_fn), ("prod", _prod_fn),
                   ("nansum", _nansum_fn), ("nanprod", _nanprod_fn),
                   ("max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
                   ("min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))):
    register(_name, inputs=("data",), attr_spec=dict(_REDUCE_ATTRS),
             simple=_reducer(_fn))

alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


def _arg_reduce(fn):
    """argmax / argmin as float32 (the first of tied extremes, as both
    libraries take); no axis: over the flattened input."""
    def impl(attrs, x):
        axis = attrs.get("axis", None)
        if axis is None:
            return fn(x.reshape(-1), 0).to(torch.float32)
        return fn(x, axis, attrs.get("keepdims", False)).to(torch.float32)
    return impl


register("argmax", inputs=("data",), attr_spec=dict(_REDUCE_ATTRS),
         simple=_arg_reduce(lambda x, d, k=False: torch.argmax(
             x, dim=d, keepdim=k)))
register("argmin", inputs=("data",), attr_spec=dict(_REDUCE_ATTRS),
         simple=_arg_reduce(lambda x, d, k=False: torch.argmin(
             x, dim=d, keepdim=k)))


@register("argmax_channel", inputs=("data",))
def _argmax_channel(attrs, x):
    return torch.argmax(x, dim=-1).to(torch.float32)


@register("norm", inputs=("data",), attr_spec=dict(_REDUCE_ATTRS))
def _norm(attrs, x):
    """``sqrt(sum(square(x)))``, the JAX package's composition (``exclude``
    unread). Trap: its gradient at x = 0 is NaN, as JAX's is;
    ``torch.linalg.norm`` would give 0."""
    axis = attrs.get("axis")
    dims = tuple(range(x.ndim)) if axis is None else \
        ((axis,) if isinstance(axis, int) else tuple(axis))
    sq = torch.square(x)
    total = torch.sum(sq, dim=dims, keepdim=attrs.get("keepdims", False)) \
        if dims else sq
    return torch.sqrt(total)


@register("softmax_cross_entropy", inputs=("data", "label"))
def _softmax_xent(attrs, data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = _take_along(logp, label.to(torch.int32)[:, None], -1)
    return -torch.sum(picked)


# --------------------------------------------------------------------------
# init ops: their tensors are made where the call runs (``dispatch`` runs
# an op with no tensor input under its device), never on the host first
# --------------------------------------------------------------------------
def _init_shape_infer(attrs, in_shapes):
    return [], [tuple(attrs.get("shape", ()))], []


_INIT_ATTRS = {"shape": (parse_tuple, ()), "dtype": (None, "float32")}


@register("_zeros", inputs=(), attr_spec=dict(_INIT_ATTRS),
          infer_shape=_init_shape_infer)
def _zeros_op(attrs):
    return torch.zeros(tuple(attrs.get("shape", ())),
                       dtype=_torch_dtype(attrs.get("dtype", "float32")))


@register("_ones", inputs=(), attr_spec=dict(_INIT_ATTRS),
          infer_shape=_init_shape_infer)
def _ones_op(attrs):
    return torch.ones(tuple(attrs.get("shape", ())),
                      dtype=_torch_dtype(attrs.get("dtype", "float32")))


@register("_full", inputs=(), attr_spec={**_INIT_ATTRS,
                                         "value": (parse_float, 0.0)},
          infer_shape=_init_shape_infer)
def _full_op(attrs):
    return torch.full(tuple(attrs.get("shape", ())), attrs.get("value", 0.0),
                      dtype=_torch_dtype(attrs.get("dtype", "float32")))


@register("_arange", inputs=(),
          attr_spec={"start": (parse_float, 0.0), "stop": (None, None),
                     "step": (parse_float, 1.0), "repeat": (parse_int, 1),
                     "dtype": (None, "float32")})
def _arange_op(attrs):
    start = attrs.get("start", 0.0)
    stop = attrs.get("stop")
    if stop in (None, "None"):
        start, stop = 0.0, start
    arr = torch.arange(start, float(stop), attrs.get("step", 1.0),
                       dtype=_torch_dtype(attrs.get("dtype", "float32")))
    if attrs.get("repeat", 1) > 1:
        arr = torch.repeat_interleave(arr, attrs["repeat"])
    return arr


@register("zeros_like", inputs=("data",), infer_shape=_infer_elemwise)
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("ones_like", inputs=("data",), infer_shape=_infer_elemwise)
def _ones_like(attrs, x):
    return torch.ones_like(x)


@register("_identity_with_attr_like_rhs", inputs=("lhs", "rhs"))
def _ident_like(attrs, lhs, rhs):
    return lhs


# --------------------------------------------------------------------------
# matrix ops
# --------------------------------------------------------------------------
_DOT_ATTRS = {"transpose_a": (parse_bool, False),
              "transpose_b": (parse_bool, False)}


@register("dot", inputs=("lhs", "rhs"), attr_spec=dict(_DOT_ATTRS))
def _dot(attrs, a, b):
    if attrs.get("transpose_a"):
        a = a.mT if a.ndim >= 2 else a
    if attrs.get("transpose_b"):
        b = b.mT if b.ndim >= 2 else b
    # MXNet dot on >2d collapses [a1..an-1, an] x [b1, b2..bm] over an==b1
    if a.ndim > 2 or b.ndim > 2:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.matmul(a, b)


@register("batch_dot", inputs=("lhs", "rhs"), attr_spec=dict(_DOT_ATTRS))
def _batch_dot(attrs, a, b):
    # on the card a float32 product runs under PyTorch's TF32 switch
    # (torch.backends.cuda.matmul.allow_tf32), as every matmul does
    if attrs.get("transpose_a"):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b"):
        b = b.transpose(-1, -2)
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


def _flatten_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None or any(d == 0 for d in s[1:]):
        return in_shapes, [None], []
    return in_shapes, [(s[0], int(np.prod(s[1:], dtype=np.int64)))], []


@register("Flatten", inputs=("data",), infer_shape=_flatten_infer)
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


def _box(attrs):
    return tuple(slice(b, e) for b, e in zip(attrs["begin"], attrs["end"]))


@register("slice", inputs=("data",),
          attr_spec={"begin": (parse_tuple, None), "end": (parse_tuple, None)})
def _slice(attrs, x):
    return x[_box(attrs)]


alias("crop", "slice")


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


@register("_slice_assign", inputs=("lhs", "rhs"),
          attr_spec={"begin": (parse_tuple, None), "end": (parse_tuple, None)})
def _slice_assign(attrs, lhs, rhs):
    out = lhs.clone()
    out[_box(attrs)] = rhs
    return out


@register("_crop_assign_scalar", inputs=("data",),
          attr_spec={"begin": (parse_tuple, None), "end": (parse_tuple, None),
                     "scalar": (parse_float, 0.0)})
def _crop_assign_scalar(attrs, x):
    out = x.clone()
    out[_box(attrs)] = attrs.get("scalar", 0.0)
    return out


@register("clip", inputs=("data",),
          attr_spec={"a_min": (parse_float, 0.0), "a_max": (parse_float, 0.0)},
          infer_shape=_infer_elemwise)
def _clip(attrs, x):
    """``jnp.clip``: ``minimum(a_max, maximum(a_min, x))``. Trap: at x ==
    a_min or a_max the tie gives half the gradient, as JAX's does, where
    ``torch.clamp`` passes all of it. An integer input clips to float32
    (the bounds are weakly typed floats)."""
    x = _inexact(x)
    x = torch.maximum(_const(attrs["a_min"], x), x)
    return torch.minimum(_const(attrs["a_max"], x), x)


@register("repeat", inputs=("data",),
          attr_spec={"repeats": (parse_int, 1), "axis": (_axis_param, None)})
def _repeat(attrs, x):
    return torch.repeat_interleave(x, attrs["repeats"], dim=attrs.get("axis"))


@register("tile", inputs=("data",), attr_spec={"reps": (parse_tuple, None)})
def _tile(attrs, x):
    return torch.tile(x, attrs["reps"])


@register("reverse", inputs=("data",), shape_passthrough=True,
          attr_spec={"axis": (_axis_param, 0)})
def _reverse(attrs, x):
    ax = attrs.get("axis", 0)
    return torch.flip(x, (ax,) if isinstance(ax, int) else tuple(ax))


alias("flip", "reverse")


@register("SwapAxis", inputs=("data",),
          attr_spec={"dim1": (parse_int, 0), "dim2": (parse_int, 0)})
def _swapaxis(attrs, x):
    return torch.swapaxes(x, attrs["dim1"], attrs["dim2"])


alias("swapaxes", "SwapAxis")


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of an axis of n padded by (lo,
    hi), as ``jnp.pad`` reads it: ``edge`` repeats the end values,
    ``reflect`` mirrors about them without repeating them (period 2(n-1),
    so a pad wider than the axis keeps reflecting)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("Pad", inputs=("data",),
          attr_spec={"mode": (None, "constant"),
                     "pad_width": (parse_tuple, None),
                     "constant_value": (parse_float, 0.0)})
def _pad(attrs, x):
    pw = attrs["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, flat, mode="constant",
                     value=attrs.get("constant_value", 0.0))
    if mode not in ("edge", "reflect"):
        raise ValueError(f"Pad mode {mode}")
    # F.pad's replicate / reflect modes pad the last 1-3 axes only:
    # gather each padded axis by its source index instead
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = torch.index_select(x, axis, _pad_index(
                x.shape[axis], lo, hi, mode, x.device))
    return x


alias("pad", "Pad")


# --------------------------------------------------------------------------
# indexing
# --------------------------------------------------------------------------
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


@register("take", inputs=("a", "indices"),
          attr_spec={"axis": (parse_int, 0), "mode": (None, "clip")})
def _take(attrs, a, indices):
    """``jnp.take``: float indices truncate toward zero (``astype(int32)``);
    mode ``clip`` (the default) clamps into [0, n), any other mode wraps
    (``wrap``: Python's modulo)."""
    axis = attrs.get("axis", 0) % a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int32).to(torch.int64)
    idx = idx.clamp(0, n - 1) if attrs.get("mode", "clip") == "clip" \
        else torch.remainder(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take", inputs=("a", "indices"))
def _batch_take(attrs, a, indices):
    return _take_along(a, indices.to(torch.int32)[:, None], 1)[:, 0]


@register("one_hot", inputs=("indices",),
          attr_spec={"depth": (parse_int, None), "on_value": (parse_float, 1.0),
                     "off_value": (parse_float, 0.0), "dtype": (None, "float32")})
def _one_hot(attrs, idx):
    """``jax.nn.one_hot``: an index outside [0, depth) gives a row of
    zeros (``F.one_hot`` raises on one); float indices truncate."""
    depth = attrs["depth"]
    dtype = _torch_dtype(attrs.get("dtype", "float32"))
    classes = torch.arange(depth, device=idx.device, dtype=torch.int32)
    oh = (idx.to(torch.int32)[..., None] == classes).to(dtype)
    on, off = attrs.get("on_value", 1.0), attrs.get("off_value", 0.0)
    if on != 1.0 or off != 0.0:
        oh = oh * (on - off) + off
    return oh


@register("pick", inputs=("data", "index"),
          attr_spec={"axis": (parse_int, -1), "keepdims": (parse_bool, False)})
def _pick(attrs, data, index):
    """``jnp.take_along_axis`` in its default mode: an index in [-n, 0)
    counts from the end, any other out-of-range index picks NaN."""
    axis = attrs.get("axis", -1) % data.ndim
    out = _take_along(data, index.to(torch.int32).unsqueeze(axis), axis)
    if not attrs.get("keepdims", False):
        out = out.squeeze(axis)
    return out


@register("where", inputs=("condition", "x", "y"))
def _where(attrs, cond, x, y):
    # a 1-D condition against an N-D x selects whole rows of axis 0
    if cond.ndim == 1 and x.ndim > 1:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond != 0, x, y)


# --------------------------------------------------------------------------
# ordering. Trap: jnp.sort / argsort are stable, and is_ascend=False FLIPS
# the stable ascending order (tied indices come out last-first), which is
# not torch.sort(descending=True, stable=True); topk follows lax.top_k,
# the lower index first among ties, which a stable descending sort gives
# (torch.topk orders ties arbitrarily on the card)
# --------------------------------------------------------------------------
def _ordering_axis(attrs, x):
    axis = attrs.get("axis", -1)
    if axis is None:
        return x.reshape(-1), 0
    return x, axis


@register("sort", inputs=("data",),
          attr_spec={"axis": (_axis_param, -1), "is_ascend": (parse_bool, True)})
def _sort(attrs, x):
    x, axis = _ordering_axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).values
    if not attrs.get("is_ascend", True):
        out = torch.flip(out, (axis,))
    return out


@register("argsort", inputs=("data",),
          attr_spec={"axis": (_axis_param, -1), "is_ascend": (parse_bool, True)})
def _argsort(attrs, x):
    x, axis = _ordering_axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).indices
    if not attrs.get("is_ascend", True):
        out = torch.flip(out, (axis,))
    return out.to(torch.float32)


def _topk_num_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", inputs=("data",),
          attr_spec={"axis": (_axis_param, -1), "k": (parse_int, 1),
                     "ret_typ": (None, "indices"),
                     "is_ascend": (parse_bool, False)},
          num_outputs=_topk_num_outputs)
def _topk(attrs, x):
    """``lax.top_k`` over ``axis`` (of ``-x`` for ``is_ascend``): values,
    indices (as float32), both, or a 0/1 mask of the chosen positions in
    x's dtype."""
    x, axis = _ordering_axis(attrs, x)
    k = attrs.get("k", 1)
    ret = attrs.get("ret_typ", "indices")
    xv = torch.movedim(x, axis, -1)
    key = -xv if attrs.get("is_ascend", False) else xv
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    if ret == "mask":
        mask = torch.zeros_like(xv).scatter(-1, idx, 1)
        return torch.movedim(mask, -1, axis)
    vals = torch.movedim(torch.gather(xv, -1, idx), -1, axis)
    idxs = torch.movedim(idx, -1, axis).to(torch.float32)
    if ret == "value":
        return vals
    if ret == "both":
        return vals, idxs
    return idxs


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
    shape = tuple(attrs.get("shape", ()))
    dtype = _torch_dtype(attrs.get("dtype", "float32"))

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
