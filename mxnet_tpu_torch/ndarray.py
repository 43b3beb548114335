"""NDArray: a mutable cell over a ``torch.Tensor``.

The drivers rely on handle semantics: an executor's ``arg_dict`` /
``aux_dict`` entries are cells that several modules may alias (the bucket
ladder's shared parameters), and a mutation must be seen through every
alias. ``_set`` swaps a new tensor into the cell; code that owns a cell
may also update its tensor in place (the KV-cache writes, cursor rewinds
and rung migrations do, and say so where they do).

Sync points: ``asnumpy()`` copies to the host, which waits for the
device. Nothing else here synchronizes.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context, context_of, current_context
from .ops.registry import dispatch, get_op

__all__ = ["NDArray", "array", "zeros", "load", "save", "imperative_invoke",
           "to_torch_dtype"]

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
    return torch.tensor(np.ascontiguousarray(arr))


class NDArray:
    """Mutable handle over a ``torch.Tensor``."""

    __slots__ = ("_data", "_ctx", "writable")

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

    # ------------------------------------------------------------------ core
    def astorch(self):
        """The underlying ``torch.Tensor`` (the counterpart of the JAX
        package's ``asjax()``)."""
        return self._data

    def _set(self, new_data):
        """Swap in a new tensor (the mutation primitive)."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
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
    def context(self):
        return self._ctx

    def asnumpy(self):
        """Copy to host numpy (waits for the device). bfloat16 and fp8
        cells, which numpy cannot hold, come back as float32."""
        t = self._data.detach()
        if t.dtype not in _TORCH_TO_NP:
            t = t.float()
        return t.cpu().numpy()

    def __repr__(self):
        return (f"{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")


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


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.zeros(tuple(shape),
                               dtype=to_torch_dtype(dtype or "float32"),
                               device=ctx.torch_device()), ctx=ctx)


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
    there."""
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
    outputs, new_aux = dispatch(opdef, attrs, regular, aux, False, None)
    for mname, new_val in zip(opdef.mutate_inputs, outputs):
        handle = inputs[in_names.index(mname)]
        if isinstance(handle, NDArray):
            handle._set(new_val)
    if aux_n:
        for handle, new_val in zip(inputs[len(arrs) - aux_n:], new_aux):
            if isinstance(handle, NDArray):
                handle._set(new_val)
    results = [NDArray(o, ctx=ctx) for o in outputs]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, results):
            dst._set(src.astorch())
        return out
    return results[0] if len(results) == 1 else results
