"""NDArray: a mutable cell over a ``torch.Tensor``.

The drivers rely on handle semantics: an executor's ``arg_dict`` /
``aux_dict`` entries are cells that several modules may alias (the bucket
ladder's shared parameters), and a mutation must be seen through every
alias. ``_set`` swaps a new tensor into the cell; code that owns a cell
may also update its tensor in place (the KV-cache writes, cursor rewinds
and rung migrations do, and say so where they do).

Arithmetic: ``+ - * / % **`` (with their reflected and in-place
forms), unary ``-`` and ``abs``, the six comparisons (which return the
input's dtype), ``[]`` and ``[] =`` are one PyTorch op each on the
array's own device. Like ``imperative_invoke`` they record autograd
history only inside ``autograd.train_section()``; everywhere else they
run under ``torch.no_grad()``. ``__setitem__`` builds the new value and
swaps it in with ``_set``, so every alias of the cell sees it. A
variable marked with ``autograd.mark_variables`` stays a leaf that
requires grad whatever ``_set`` swaps in: ``backward`` differentiates
its current value.

The rest of the JAX package's NDArray surface: ``copy``, ``copyto``,
``as_in_context``, ``astype``, ``asscalar``, ``reshape`` (MXNet's 0 and
-1 codes), ``T``, ``size``, ``len()`` and iteration over the first axis;
the factories ``zeros``, ``ones``, ``full``, ``empty`` (zeros, as the JAX
package makes it), ``arange`` and ``concatenate``, each made on its
context's device; and the module helpers ``add`` ... ``lesser_equal``
(scalar or array operands, comparisons as float32 0/1), ``moveaxis`` and
``onehot_encode``. Every registry op is added to this module as
``mx.nd.<op>`` when the package is imported (``_op_gen``), so the
builtins that share an op's name (``slice``, ``max``, ...) are reached
here through ``_py_*`` names.

Sync points: ``asnumpy()`` and ``asscalar()`` copy to the host, which
waits for the device; so does ``bool()`` of a one-element array;
``wait_to_read`` / ``wait_to_write`` and ``waitall`` synchronize the card
(nothing on the CPU). Nothing else here synchronizes.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .context import Context, context_of, current_context
from .ops.registry import dispatch, get_op

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "waitall", "load", "save", "imperative_invoke",
           "to_torch_dtype", "add", "subtract", "multiply", "divide",
           "true_divide", "power", "maximum", "minimum", "equal",
           "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "moveaxis", "onehot_encode"]

_py_slice = slice

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16, np.dtype("uint8"): torch.uint8,
    np.dtype("int32"): torch.int32, np.dtype("int8"): torch.int8,
    np.dtype("int64"): torch.int64, np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}
# storage dtypes numpy has no name for without extension packages
_TORCH_BY_NAME = {"bfloat16": torch.bfloat16,
                  "float8_e4m3fn": torch.float8_e4m3fn,
                  "float8_e5m2": torch.float8_e5m2}


def to_torch_dtype(dtype):
    """Any dtype spelling (numpy dtype/type, string, torch dtype) ->
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else None
    if name in _TORCH_BY_NAME:
        return _TORCH_BY_NAME[name]
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (TypeError, KeyError):
        key = str(getattr(dtype, "name", dtype))
        if key in _TORCH_BY_NAME:
            return _TORCH_BY_NAME[key]
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def _np_dtype(tdtype):
    """The numpy dtype of a torch dtype, or the torch dtype itself where
    numpy has none (bfloat16, fp8)."""
    return _TORCH_TO_NP.get(tdtype, tdtype)


def _to_tensor(data):
    """Host data (numpy, lists, scalars) -> a CPU tensor that owns a copy."""
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    # reshape: ascontiguousarray makes a 0-d array 1-d
    return torch.tensor(np.ascontiguousarray(arr).reshape(arr.shape))


class NDArray:
    """Mutable handle over a ``torch.Tensor``."""

    __slots__ = ("_data", "_ctx", "writable", "_grad", "__weakref__")

    def __init__(self, data, ctx=None, writable=True):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _to_tensor(data)
        if ctx is not None:
            dev = ctx.torch_device()
            if data.device != dev:
                data = data.to(dev)
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data.device)
        self.writable = writable
        self._grad = None     # (grad cell, req) once autograd marks it

    # ------------------------------------------------------------------ core
    def astorch(self):
        """The underlying ``torch.Tensor`` (the counterpart of the JAX
        package's ``asjax()``)."""
        return self._data

    def _set(self, new_data):
        """Swap in a new tensor (the mutation primitive). A variable that
        autograd marked gets the new value as a fresh leaf that requires
        grad."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if self._grad is not None:
            new_data = new_data.detach().requires_grad_(True)
        self._data = new_data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def context(self):
        return self._ctx

    ctx = context

    def asnumpy(self):
        """Copy to host numpy (waits for the device). bfloat16 and fp8
        cells, which numpy cannot hold, come back as float32."""
        t = self._data.detach()
        if t.dtype not in _TORCH_TO_NP:
            t = t.float()
        if t.device.type == "cpu":
            # numpy() of a CPU tensor shares its storage: an in-place
            # update of the array (an optimizer step) would show through
            return t.numpy().copy()
        return t.cpu().numpy()

    def asscalar(self):
        """The one value of a one-element array, as a numpy scalar."""
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def wait_to_read(self):
        """Wait for the work that writes this array (the card's stream)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def copyto(self, other):
        """Copy into another NDArray (its dtype and device; shapes must
        match) or onto a Context (a new array there)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(
                    f"copyto shape mismatch {self.shape} vs {other.shape}")
            dst = other.astorch()
            other._set(self._data.detach().to(device=dst.device,
                                               dtype=dst.dtype, copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), ctx=other)
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx):
        """This array where ``ctx`` says: itself when it is there, else a
        copy."""
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def copy(self):
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def astype(self, dtype):
        return NDArray(self._data.detach().to(to_torch_dtype(dtype),
                                              copy=True), ctx=self._ctx)

    def reshape(self, shape, **kwargs):
        """A view of the new shape: 0 copies the input's dim at that
        position, -1 takes what is left (``reverse`` is not taken, as in
        the JAX package)."""
        if isinstance(shape, int):
            shape = (shape,)
        if kwargs.get("reverse"):
            raise NotImplementedError("reshape(reverse=True)")
        shape = _resolve_reshape(self.shape, tuple(int(s) for s in shape))
        with _grad_scope():
            return NDArray(self._data.reshape(shape), ctx=self._ctx)

    @property
    def T(self):
        """All axes reversed."""
        with _grad_scope():
            return NDArray(self._data.permute(*reversed(range(self.ndim))),
                           ctx=self._ctx)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")

    def __bool__(self):
        return bool(self._data)

    # ------------------------------------------------------------ indexing
    def __getitem__(self, key):
        with _grad_scope():
            out = self._data[_index(key)]
        return NDArray(out, ctx=self._ctx)

    def __setitem__(self, key, value):
        t = self._data
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(device=t.device, dtype=t.dtype)
        with _grad_scope():
            if isinstance(key, _py_slice) and key == _py_slice(None):
                new = torch.empty(t.shape, dtype=t.dtype, device=t.device)
                if isinstance(value, torch.Tensor):
                    new.copy_(value)
                else:
                    new.fill_(value)
            else:
                new = t.clone()
                new[_index(key)] = value
        self._set(new)

    # ---------------------------------------------------------- arithmetic
    def _binary(self, other, fn):
        """``fn(self, other)`` for an NDArray or a scalar ``other``."""
        if isinstance(other, NDArray):
            other = other._data
        elif isinstance(other, np.generic):
            other = other.item()
        elif not isinstance(other, (int, float)):
            return NotImplemented
        with _grad_scope():
            out = fn(self._data, other)
        return NDArray(out, ctx=self._ctx)

    def _inplace(self, result):
        if result is NotImplemented:
            return result
        self._set(result._data)
        return self

    def __add__(self, o): return self._binary(o, torch.add)
    __radd__ = __add__
    def __sub__(self, o): return self._binary(o, torch.sub)
    def __rsub__(self, o): return self._binary(o, lambda a, b: b - a)
    def __mul__(self, o): return self._binary(o, torch.mul)
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binary(o, torch.true_divide)
    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: torch.true_divide(b, a))
    def __mod__(self, o): return self._binary(o, torch.remainder)
    def __rmod__(self, o):
        return self._binary(o, lambda a, b: torch.remainder(b, a))
    def __pow__(self, o): return self._binary(o, torch.pow)
    def __rpow__(self, o): return self._binary(o, lambda a, b: torch.pow(b, a))
    def __iadd__(self, o): return self._inplace(self + o)
    def __isub__(self, o): return self._inplace(self - o)
    def __imul__(self, o): return self._inplace(self * o)
    def __itruediv__(self, o): return self._inplace(self / o)
    def __imod__(self, o): return self._inplace(self % o)
    def __ipow__(self, o): return self._inplace(self ** o)

    def __neg__(self):
        with _grad_scope():
            return NDArray(-self._data, ctx=self._ctx)

    def __abs__(self):
        with _grad_scope():
            return NDArray(torch.abs(self._data), ctx=self._ctx)

    def __eq__(self, o): return self._binary(o, _compare(torch.eq))
    def __ne__(self, o): return self._binary(o, _compare(torch.ne))
    def __gt__(self, o): return self._binary(o, _compare(torch.gt))
    def __ge__(self, o): return self._binary(o, _compare(torch.ge))
    def __lt__(self, o): return self._binary(o, _compare(torch.lt))
    def __le__(self, o): return self._binary(o, _compare(torch.le))
    __hash__ = object.__hash__


def _compare(fn):
    """A comparison whose 0/1 result takes the left operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


def _index(key):
    """An index with its NDArrays as tensors."""
    if isinstance(key, NDArray):
        return key._data
    if isinstance(key, tuple):
        return tuple(k._data if isinstance(k, NDArray) else k for k in key)
    return key


def _grad_scope(mutates=False):
    """Where an imperative op runs: recording autograd inside
    ``autograd.train_section()`` and ``grad_and_loss``, under
    ``torch.no_grad()`` everywhere else and for ops that update their
    inputs."""
    from . import autograd
    if autograd.is_recording() and not mutates:
        return torch.enable_grad()
    return torch.no_grad()


def _resolve_reshape(old, new):
    """MXNet's reshape codes as the JAX package reads them: 0 copies the
    old dim at that position, -1 takes the rest (floor division)."""
    out = [old[i] if s == 0 else s for i, s in enumerate(new)]
    if -1 in out:
        known = int(np.prod([s for s in out if s != -1], dtype=np.int64))
        total = int(np.prod(old, dtype=np.int64))
        out[out.index(-1)] = total // (known if known > 1 else 1)
    return tuple(out)


# ---------------------------------------------------------------- factories
def array(source_array, ctx=None, dtype=None):
    """Create an NDArray from any array-like, on ``ctx`` (default: the
    current context, ``gpu(0)`` unless a ``with mx.cpu():`` scope says
    otherwise). float64 host data narrows to float32."""
    ctx = ctx or (source_array.context if isinstance(source_array, NDArray)
                  else current_context())
    if isinstance(source_array, NDArray):
        src = source_array.astorch()
    else:
        src = _to_tensor(source_array)
    if dtype is not None:
        src = src.to(to_torch_dtype(dtype))
    return NDArray(src, ctx=ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.zeros(_shape(shape),
                               dtype=to_torch_dtype(dtype or "float32"),
                               device=ctx.torch_device()), ctx=ctx)


def ones(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.ones(_shape(shape),
                              dtype=to_torch_dtype(dtype or "float32"),
                              device=ctx.torch_device()), ctx=ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.full(_shape(shape), val,
                              dtype=to_torch_dtype(dtype or "float32"),
                              device=ctx.torch_device()), ctx=ctx)


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the JAX package makes an empty array (MXNet leaves it
    uninitialized)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """[start, stop) by step (``stop`` None: [0, start)), each value
    ``repeat`` times, made on ``ctx``'s device."""
    ctx = ctx or current_context()
    if stop is None:
        start, stop = 0, start
    arr = torch.arange(start, stop, step,
                       dtype=to_torch_dtype(dtype or "float32"),
                       device=ctx.torch_device())
    if repeat > 1:
        arr = torch.repeat_interleave(arr, repeat)
    return NDArray(arr, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """The arrays joined along ``axis``, on the first one's context."""
    if not arrays:
        raise ValueError("need at least one array")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    with _grad_scope():
        out = torch.cat([a.astorch() for a in arrays], dim=axis)
    return NDArray(out, ctx=arrays[0].context)


def waitall():
    """Wait for all work on every card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ------------------------------------------------------------- save / load
# The reference's .params container, byte for byte the JAX package's
# (mxnet_tpu/ndarray.py). Little-endian:
#   uint64 magic=0x112, uint64 reserved=0
#   uint64 narr; per array:
#     uint32 ndim, uint32[ndim] shape
#     [if ndim>0] int32 dev_type, int32 dev_id (Context)
#                 int32 type_flag, raw bytes   (mshadow type codes)
#   uint64 nkeys; per key: uint64 len, bytes
_MAGIC = 0x112
_DTYPE_CODE = {t: i for i, t in enumerate(
    [torch.float32, torch.float64, torch.float16, torch.uint8, torch.int32,
     torch.int8, torch.int64])}
# the fp8 storage dtypes' extension codes, parked far outside the
# reference range exactly as the JAX package parks them
_DTYPE_CODE[torch.float8_e4m3fn] = 100
_DTYPE_CODE[torch.float8_e5m2] = 101
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}


def _raw_bytes(t):
    """A CPU tensor's bytes (fp8 through a uint8 view: numpy has no fp8)."""
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.view(torch.uint8)
    return t.numpy().tobytes()


def save(fname, data):
    """Save a list or str->NDArray dict in the .params container.
    bfloat16 widens to float32 (the format predates bf16)."""
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    elif isinstance(data, NDArray):
        names, arrays = [], [data]
    else:
        raise TypeError("save requires dict/list/NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _MAGIC, 0, len(arrays)))
        for arr in arrays:
            t = arr.astorch() if isinstance(arr, NDArray) \
                else _to_tensor(arr)
            if t.dtype not in _DTYPE_CODE:
                t = t.float()
            f.write(struct.pack("<I", t.ndim))
            f.write(struct.pack(f"<{t.ndim}I", *t.shape))
            f.write(struct.pack("<ii", 1, 0))  # Context: cpu(0)
            f.write(struct.pack("<i", _DTYPE_CODE[t.dtype]))
            f.write(_raw_bytes(t))
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname):
    """Load NDArrays saved by :func:`save`, by the JAX package, or by the
    reference. Each array lands on the context its record names (files
    written by either package say ``cpu(0)``)."""
    with open(fname, "rb") as f:
        magic, _reserved, n_arr = struct.unpack("<QQQ", f.read(24))
        if magic != _MAGIC:
            raise MXNetError(f"invalid NDArray file {fname}")
        arrays = []
        for _ in range(n_arr):
            ndim, = struct.unpack("<I", f.read(4))
            shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim))
            if ndim == 0:  # is_none() array: shape only
                arrays.append(NDArray(torch.zeros((0,)), ctx=Context("cpu")))
                continue
            dev_type, dev_id = struct.unpack("<ii", f.read(8))
            dcode, = struct.unpack("<i", f.read(4))
            dt = _CODE_DTYPE[dcode]
            count = int(np.prod(shape, dtype=np.int64))
            buf = bytearray(f.read(count * dt.itemsize))
            t = torch.frombuffer(buf, dtype=torch.uint8).view(dt) \
                if count else torch.zeros(0, dtype=dt)
            ctx = Context("gpu", dev_id) if dev_type == 2 else Context("cpu")
            arrays.append(NDArray(t.reshape(shape), ctx=ctx))
        n_names, = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(n_names):
            ln, = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode())
    if names:
        return dict(zip(names, arrays))
    return arrays


# ------------------------------------------------------ imperative dispatch
def imperative_invoke(op_name, *inputs, out=None, **kwargs):
    """Run a registered op eagerly on NDArrays: normalize attrs, dispatch
    by device (kernel variant on CUDA, plain version on the CPU), write
    aux states back into their handles, wrap the outputs. An op that
    declares ``mutate_inputs`` (the optimizer updates) has output k
    written into the handle of input ``mutate_inputs[k]``; its CUDA
    kernel updates that tensor in place, so the write is the same tensor
    there. An op that needs randomness (Dropout, the samplers) draws one
    ``mx.random.next_key()`` a call; an op with no input (a sampler) runs
    on the current context. Inside ``autograd.train_section()`` the op runs with
    ``is_train=True`` and records autograd history (an op that updates
    its inputs records none); elsewhere with ``is_train=False`` under
    ``torch.no_grad()``."""
    from . import autograd
    opdef = get_op(op_name)
    attrs = opdef.normalize_attrs(kwargs)
    in_names = opdef.input_names(attrs)
    aux_n = len(opdef.aux_names(attrs))
    ctx = inputs[0].context if inputs and isinstance(inputs[0], NDArray) \
        else current_context()
    arrs = [x.astorch() if isinstance(x, NDArray)
            else NDArray(x, ctx=ctx).astorch() for x in inputs]
    regular, aux = (arrs[:len(arrs) - aux_n], arrs[len(arrs) - aux_n:]) \
        if aux_n else (arrs, [])
    is_train = autograd.is_training()
    rng = _random.next_key() if opdef.need_rng else None
    with _grad_scope(mutates=bool(opdef.mutate_inputs)):
        outputs, new_aux = dispatch(opdef, attrs, regular, aux, is_train,
                                    rng, ctx.torch_device())
    for mname, new_val in zip(opdef.mutate_inputs, outputs):
        handle = inputs[in_names.index(mname)]
        if isinstance(handle, NDArray):
            handle._set(new_val)
    if aux_n:
        for handle, new_val in zip(inputs[len(arrs) - aux_n:], new_aux):
            if isinstance(handle, NDArray):
                handle._set(new_val.detach())
    results = [NDArray(o, ctx=ctx) for o in outputs]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, results):
            dst._set(src.astorch())
        return out
    return results[0] if len(results) == 1 else results


# ---------------------------------------------------------------------
# module helpers: scalar-or-array operands over the broadcast ops
def _operand(x, like):
    """An operand as a tensor: an NDArray's own, a scalar as a 0-d tensor
    on ``like``'s device (its weak type: a Python float beside int32
    gives float32, beside float32 float32, as JAX's scalars do)."""
    if isinstance(x, NDArray):
        return x.astorch()
    if isinstance(x, np.generic):
        x = x.item()
    return torch.tensor(x, device=like.device if like is not None
                        else None)


def _binary_fn(op, name):
    def fn(lhs, rhs):
        lead = lhs if isinstance(lhs, NDArray) else \
            rhs if isinstance(rhs, NDArray) else None
        like = lead.astorch() if lead is not None else None
        with _grad_scope():
            out = op(_operand(lhs, like), _operand(rhs, like))
        if out.dtype == torch.bool:        # comparisons: 0/1 float32
            out = out.to(torch.float32)
        return NDArray(out, ctx=lead.context if lead is not None else None)
    fn.__name__ = name
    fn.__doc__ = (f"Element-wise broadcasting ``{name}`` of scalar or array "
                  "operands.")
    return fn


add = _binary_fn(torch.add, "add")
subtract = _binary_fn(torch.sub, "subtract")
multiply = _binary_fn(torch.mul, "multiply")
divide = _binary_fn(torch.true_divide, "divide")
true_divide = _binary_fn(torch.true_divide, "true_divide")
# integer bases to a negative exponent truncate (ROADMAP.md §C)
power = _binary_fn(torch.pow, "power")
maximum = _binary_fn(torch.maximum, "maximum")
minimum = _binary_fn(torch.minimum, "minimum")
equal = _binary_fn(torch.eq, "equal")
not_equal = _binary_fn(torch.ne, "not_equal")
greater = _binary_fn(torch.gt, "greater")
greater_equal = _binary_fn(torch.ge, "greater_equal")
lesser = _binary_fn(torch.lt, "lesser")
lesser_equal = _binary_fn(torch.le, "lesser_equal")


def moveaxis(tensor, source, destination):
    """``tensor`` with axis ``source`` moved to ``destination``."""
    with _grad_scope():
        return NDArray(torch.movedim(tensor.astorch(), source, destination),
                       ctx=tensor.context)


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` (depth ``out.shape[1]``, an
    index outside it a row of zeros) into ``out``."""
    depth = out.shape[1]
    t = out.astorch()
    idx = indices.astorch().to(torch.int32).reshape(-1)
    classes = torch.arange(depth, dtype=torch.int32, device=t.device)
    out._set((idx.to(t.device)[:, None] == classes).to(t.dtype))
    return out
