"""``mx.rtc``: user CUDA kernels (``Rtc``, ``register_cuda_op``), the
attention ops of the transformer LM (``attention``, its explicit name
``pallas_flash_attention``, and the KV-cache ``attention_decode``), the
``pallas_sgd_mom_update`` op name, and the JAX package's functions of
the same kernels (``flash_attention``, ``flash_attention_partial``,
``pallas_sgd_mom_update``).

User kernels are MXNet's original ``mx.rtc`` shape: CUDA C++ source,
compiled at first use and launched on NDArrays. The JAX package's
counterparts (``mxnet_tpu/rtc.py`` ``Rtc`` and ``register_pallas_op``)
take Pallas kernels; the port has no Pallas and no interpreter, so a
user kernel runs on CUDA tensors only, and an op registered without a
plain ``reference`` raises on the CPU. The user writes the body of a
``__global__`` function; the port writes its signature from the names
and dtypes (float32 -> ``float``, bfloat16 -> ``__nv_bfloat16``, int32
-> ``int``), ``extern "C"`` so the symbol keeps its name. The source is
compiled for sm_90a by NVRTC (``libnvrtc`` of the CUDA toolkit, through
``ctypes``) into a cubin cached under ``build/kernels/`` by the hash of
its source; the cubin is loaded into the device's primary context (the one
PyTorch uses) with the driver API, one module per device, and launched
with ``cuLaunchKernel`` on PyTorch's current stream. Every user kernel
counts its launches under its name (``launch_counts()``).

``attention_decode`` is the decode path's stateful op: its K/V caches and
int32 cursor are op AUX state, read AND written on inference forwards
(``stateful_infer``), so N incremental steps reproduce the length-N full
forward. Two cursor layouts, one op:

* scalar (default) — ONE (1,) cursor: every batch row decodes the same
  sequence position (``KVCacheDecoder``);
* ``per_slot=True`` — a (B, 1) cursor vector: each batch row is an
  independent decode slot at its own position in its own slice of the
  slot-pooled (B, H, C, Dh) cache (``BatchedKVCacheDecoder``). S=1 writes
  land per slot at the slot's cursor and leave every other cache position
  bit-identical (a cursor past capacity writes nothing); S>1 windows
  (chunked prefill, speculative verify) land per row at the row's cursor,
  clamped as the JAX package's ``dynamic_update_slice`` clamps.

The cache cells are float32, or fp8 storage (``cache_dtype`` "fp8" /
"e4m3" -> ``float8_e4m3fn``, "e5m2" -> ``float8_e5m2``): rows are cast on
store and read back exactly (``.to(float32)``). The store cast is
``fp8_cast``, which gives the bytes XLA's cast gives — PyTorch's own cast
saturates float8_e4m3fn overflow at +-448 where XLA writes NaN — and every
write goes through a ``uint8`` view of an fp8 cell (PyTorch has no
``index_copy_`` for float8 on the CPU), so the same bytes land on both
devices.

The cache writes update the aux tensors IN PLACE (the executor's cells
own them), where the JAX package builds new arrays: this saves two full
cache copies per layer per step. RoPE and the writes are plain PyTorch on
both devices, exactly as the JAX package keeps them outside its kernel;
only the attention READ has a kernel — ``cuda_kernels.decode_attention``,
the op's ``"cuda"`` variant, which reads float32 and fp8 cells alike.

``attention`` (the full-sequence op of ``get_symbol``, which the LM
trains through and the decode parity tests compare against) is the plain
composition on the CPU and the flash-attention kernel
(``cuda_kernels.flash_attention``, the port of ``mxnet_tpu/rtc.py``
``_flash_kernel``) on the card. The card's variant is an
``autograd.Function`` whose backward recomputes the plain composition and
takes its vector-Jacobian product, as the JAX package's ``custom_vjp``
does: the forward never holds the (T, T) scores, the backward holds them
for one layer at a time (at B=8, H=8, T=1024 one float32 score tensor is
268 MB). ``pallas_flash_attention`` is the same op under the name the
JAX package registers for its kernel. Under ``compute_dtype="bfloat16"``
or ``"float16"`` the forward is the kernel's instance of that dtype and
the recompute runs on the 16-bit q, k, v and returns 16-bit gradients,
as ``jax.vjp`` of the JAX package's ``attention`` does. Its scale is the
float32 Dh^-1/2, the forward kernel's; the JAX recompute takes
``1/sqrt(Dh)`` in q's dtype, which bfloat16 and float16 both round at
Dh = 128 (0.08837890625 for 0.0883883) and keep exact at Dh = 64, so
16-bit gradients at Dh = 128 differ from the JAX package's by that much
more than the rounding of their type. The decode read
(``attention_decode``'s ``"cuda"`` variant) takes float16 q and caches
as it takes bfloat16 ones.

Under a sequence-parallel plan (a ``parallel.SpmdPlan`` whose mesh has a
``seq`` axis longer than 1, armed by the executor around its forward and
backward) both attention ops lower to ring attention over that axis
(``parallel.ring_attention_sharded``; the batch split over the ``data``
axis too when that divides B) wherever the JAX package's ``ring``
variant is eligible (``_attention_ring_eligible``: self-attention shapes,
T and B divisible by the shard counts): on the card the ring's local
block is ``cuda_kernels.flash_attention_partial``, on the CPU the plain
ring. The plan decides inside the op, not as a third variant: the
registry keeps one variant per device. ``ring_decisions()`` records each
lowering once per op, shapes and dtypes.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import threading

import numpy as np
import torch
from torch.autograd.graph import increment_version

from .base import MXNetError, parse_bool, parse_float
from .ndarray import to_torch_dtype
from .ops import cuda_kernels
from .ops.nn import rope_apply
from .ops.optimizer_op import sgd_mom_step
from .ops.registry import OP_REGISTRY, register
from .parallel import spmd as _spmd
from .parallel.ring_attention import ring_attention_sharded

__all__ = ["Rtc", "register_cuda_op", "kernel_source", "launch_counts",
           "reset_launch_counts", "flash_attention_fn", "flash_attention",
           "flash_attention_partial", "pallas_sgd_mom_update",
           "ring_decisions",
           "clear_ring_decisions",
           "fp8_cast"]


# --------------------------------------------------------------------------
# attention: the plain composition, and the flash kernel on the card
# --------------------------------------------------------------------------
def _attention_plain(attrs, q, k, v):
    """Softmax attention, q/k/v (B, H, T, D), float32 logits and
    softmax, optional causal mask."""
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if parse_bool(attrs.get("causal", False)):
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)


class _FlashAttentionFn(torch.autograd.Function):
    """Forward: the flash kernel (its instance of q's dtype). Backward:
    the vector-Jacobian product of ``_attention_plain`` recomputed from
    the saved q, k, v (the JAX package's flash recompute,
    ``mxnet_tpu/rtc.py`` ``flash_attention``), in float32 from the
    leaves' values, each gradient returned in its leaf's dtype; the
    recompute is plain PyTorch, as the JAX package's is XLA."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return cuda_kernels.flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _attention_plain({"causal": ctx.causal}, *leaves)
        return (*torch.autograd.grad(out, leaves, ct), None)


def flash_attention_fn(q, k, v, causal=False):
    """Differentiable flash attention of q, k, v (B, H, T, Dh)."""
    return _FlashAttentionFn.apply(q, k, v, bool(causal))


def flash_attention(q, k, v, causal=False, block_q=128, block_k=128):
    """Flash attention of q, k, v (B, H, T, Dh) -> (B, H, T, Dh), the JAX
    package's ``mx.rtc.flash_attention``: the flash kernel on the card,
    the plain composition on the CPU, differentiable (the backward
    recomputes the plain composition, ``_FlashAttentionFn``). The block
    sizes are the TPU kernel's tiling and decide nothing here but the
    JAX function's refusal: T must be a multiple of min(block, T)."""
    T = q.shape[2]
    block_q, block_k = min(block_q, T), min(block_k, T)
    if T % block_q or T % block_k:
        raise MXNetError(f"flash_attention: T={T} must be a multiple of "
                         f"block sizes ({block_q}, {block_k})")
    return flash_attention_fn(q, k, v, causal)


def flash_attention_partial(q, k, v, q_off, k_off, causal=False,
                            block_q=128, block_k=128, scale=None):
    """The unnormalized flash-attention block of ring attention, the JAX
    package's ``mx.rtc.flash_attention_partial``: q (B, H, Tq, Dh) over
    the K/V shard k, v (B, H, Tk, Dh) at absolute offsets ``q_off`` and
    ``k_off`` -> (acc (B, H, Tq, Dh), m (B, H, Tq), l (B, H, Tq)) float32
    (``cuda_kernels.flash_attention_partial``). ``scale`` defaults to
    1/sqrt(Dh); the block sizes only decide the JAX function's refusal
    (Tq and Tk multiples of their blocks)."""
    tq, tk = q.shape[2], k.shape[2]
    if tq % min(block_q, tq) or tk % min(block_k, tk):
        raise MXNetError("flash_attention_partial: T must divide blocks")
    return cuda_kernels.flash_attention_partial(q, k, v, int(q_off),
                                                int(k_off), bool(causal),
                                                scale)


# --------------------------------------------------------------------------
# attention under a sequence-parallel plan: the ring lowering
# --------------------------------------------------------------------------
_RING_DECISIONS = []
_ring_noted = set()       # (op, shapes, dtypes) keys already recorded


def ring_decisions():
    """The ring lowerings taken so far, one record per (op, shapes,
    dtypes): op, variant "ring", shapes, dtypes, backend, the reason and
    its source "plan" (the JAX package's ``kernel_tier.decisions()``
    records of its ``ring`` variant)."""
    return list(_RING_DECISIONS)


def clear_ring_decisions():
    _RING_DECISIONS.clear()
    _ring_noted.clear()


def _attention_ring_eligible(attrs, in_shapes, in_dtypes):
    """Eligible only under an active seq-sharded plan whose shard counts
    divide (B, T); self-attention shapes only (q/k/v agree)."""
    plan = _spmd.active_plan()
    if plan is None:
        return False
    n_seq = plan.n_seq_shards()
    if n_seq <= 1:
        return False
    if len(in_shapes) < 3 or len(in_shapes[0]) != 4:
        return False
    if not (tuple(in_shapes[0]) == tuple(in_shapes[1])
            == tuple(in_shapes[2])):
        return False
    b, _h, t, _d = in_shapes[0]
    if t < n_seq or t % n_seq:
        return False
    nd = plan.n_data_shards()
    return not (nd > 1 and b % nd)


def _attention_ring(op, attrs, q, k, v):
    """Ring attention over the active plan's ``seq`` axis (the batch over
    its ``data`` axis too when that divides B) when the plan and the
    shapes take it, recording the decision; else None."""
    plan = _spmd.active_plan()
    shapes = [tuple(t.shape) for t in (q, k, v)]
    dtypes = [str(t.dtype).replace("torch.", "") for t in (q, k, v)]
    if not _attention_ring_eligible(attrs, shapes, dtypes):
        return None
    n_seq, nd = plan.n_seq_shards(), plan.n_data_shards()
    key = (op, tuple(shapes), tuple(dtypes))
    if key not in _ring_noted:
        _ring_noted.add(key)
        _RING_DECISIONS.append({
            "op": op, "variant": "ring", "shapes": [list(x) for x in shapes],
            "dtypes": dtypes, "backend": q.device.type,
            "reason": f"sequence-sharded plan (seq={n_seq}): ring attention "
                      "over ppermute", "source": "plan"})
    data_axis = plan.data_axis if nd > 1 and q.shape[0] % nd == 0 else None
    return ring_attention_sharded(q, k, v, plan.mesh,
                                  parse_bool(attrs.get("causal", False)),
                                  plan.seq_axis, data_axis)


def _attention_forwards(op):
    """The plain forward and the ``"cuda"`` variant of attention op
    ``op``: ring attention under a sequence-parallel plan, else the plain
    composition and the flash kernel."""
    def plain(attrs, q, k, v):
        out = _attention_ring(op, attrs, q, k, v)
        return _attention_plain(attrs, q, k, v) if out is None else out

    def cuda(attrs, inputs, aux, is_train, rng):
        q, k, v = (t.contiguous() for t in inputs)
        out = _attention_ring(op, attrs, q, k, v)
        if out is None:
            out = flash_attention_fn(q, k, v,
                                     parse_bool(attrs.get("causal", False)))
        return [out], []
    return plain, cuda


# --------------------------------------------------------------------------
# attention_decode
# --------------------------------------------------------------------------
def _decode_check_overflow(pos, S, capacity, per_slot):
    """Overflow raises cleanly when the cursor lies on the host. A CUDA
    cursor is never read back (that would synchronize the device every
    step): the decode drivers check their host-side mirrors before each
    dispatch instead."""
    if pos.device.type != "cpu":
        return
    if per_slot:
        over = [int(i) for i in np.nonzero(
            pos.numpy().astype(np.int64) + S > capacity)[0]]
        if over:
            raise MXNetError(
                f"attention_decode: cache overflow in slot(s) {over} "
                f"(cursor + {S} > capacity {capacity}); retire the "
                "sequence or re-bind with a larger capacity=")
    elif int(pos) + S > capacity:
        raise MXNetError(
            f"attention_decode: cache overflow (pos {int(pos)} + {S} new "
            f"tokens > capacity {capacity}); re-bind with a larger "
            "capacity= or reset the cache")


#: fp8 storage -> (the least magnitude XLA's cast overflows at, its NaN
#: code, its overflow code); the sign bit is or-ed in. float8_e4m3fn has no
#: infinity: past 464, the midpoint above its largest finite 448, and at
#: +-inf the cast gives NaN. float8_e5m2 rounds to +-inf from 61440 on.
_FP8_XLA = {
    torch.float8_e4m3fn: (float(np.nextafter(np.float32(464.0),
                                             np.float32(np.inf))), 0x7F, 0x7F),
    torch.float8_e5m2: (61440.0, 0x7E, 0x7C),
}


def fp8_cast(x, dtype):
    """``x`` cast to the fp8 ``dtype`` as XLA casts float32 (the JAX
    package's ``astype``): round to nearest even; magnitudes from the
    overflow point on (and +-inf) become NaN for float8_e4m3fn, where
    PyTorch's cast saturates at +-448, and +-inf for float8_e5m2; NaN
    becomes sign | 0x7f (e4m3fn) or sign | 0x7e (e5m2). In-range values
    take PyTorch's cast, which rounds as XLA does."""
    over, nan_code, over_code = _FP8_XLA[dtype]
    x = x.to(torch.float32)
    codes = x.to(dtype).view(torch.uint8)
    sign = torch.signbit(x).to(torch.uint8) << 7
    codes = torch.where(x.abs() >= over, sign | over_code, codes)
    codes = torch.where(torch.isnan(x), sign | nan_code, codes)
    return codes.view(dtype)


def _store_views(cache, new):
    """(cell, rows) as a cache write sees them: a float32 cell and the
    rows as they are; an fp8 cell as its ``uint8`` bytes and the rows as
    ``fp8_cast``'s codes."""
    if cache.dtype in _FP8_XLA:
        return (cache.view(torch.uint8),
                fp8_cast(new, cache.dtype).view(torch.uint8))
    return cache, new.to(cache.dtype)


def _decode_rope_write(attrs, q, k, v, k_cache, v_cache, pos, per_slot):
    """RoPE + cache write, shared by the plain forward and the CUDA
    variant, so the cache contents are bit-identical across the two.
    ``pos`` is a 0-d tensor (scalar layout) or (B,) (slot pool). Writes
    the caches in place; returns the rotated q."""
    B, H, S, Dh = q.shape
    capacity = k_cache.shape[2]
    dev = q.device
    if parse_bool(attrs.get("rope", False)):
        base = parse_float(attrs.get("rope_base", 10000.0))
        steps = torch.arange(S, device=dev)
        positions = pos[:, None] + steps[None, :] if per_slot \
            else pos + steps
        q = rope_apply(q, positions, base)
        k = rope_apply(k, positions, base)
    pairs = (_store_views(k_cache, k), _store_views(v_cache, v))
    if not per_slot:
        # one window for every row at the shared cursor; the start clamps
        # to [0, C - S] like dynamic_update_slice
        idx = pos.clamp(0, capacity - S) + torch.arange(S, device=dev)
        for cache, new in pairs:
            cache.index_copy_(2, idx, new)
    elif S == 1:
        # each slot's token at its own cursor; a cursor past capacity
        # writes back the value already there (no clamped write), so
        # untouched positions stay bit-identical
        rows = torch.arange(B, device=dev)
        at = pos.clamp(0, capacity - 1)
        hit = ((pos >= 0) & (pos < capacity))[:, None, None]
        for cache, new in pairs:
            cache[rows, :, at, :] = torch.where(hit, new[:, :, 0, :],
                                                cache[rows, :, at, :])
    else:
        # window write: each slot lands its S rows at its own cursor,
        # start clamped per row as the per-row dynamic_update_slice does
        rows = torch.arange(B, device=dev)[:, None]
        idx = pos.clamp(0, capacity - S)[:, None] + \
            torch.arange(S, device=dev)[None, :]
        for cache, new in pairs:
            cache[rows, :, idx, :] = new.transpose(1, 2)
    return q


def _decode_pos(attrs, cursor, B, S, capacity):
    """(pos, new_cursor, per_slot) from the cursor aux cell."""
    per_slot = parse_bool(attrs.get("per_slot", False))
    if per_slot:
        pos = cursor.reshape(B).to(torch.int32)
        new_cursor = (pos + S).reshape(B, 1).to(torch.int32)
    else:
        pos = cursor.reshape(()).to(torch.int32)
        new_cursor = (pos + S).reshape(1).to(torch.int32)
    _decode_check_overflow(pos, S, capacity, per_slot)
    return pos, new_cursor, per_slot


def _attention_decode_fwd(attrs, inputs, aux, is_train, rng):
    """Plain forward: RoPE + cache write, then masked float32 softmax
    attention over each row's prefix (key_pos <= cursor + s)."""
    q, k, v = inputs                       # (B, H, S, Dh), S new tokens
    k_cache, v_cache, cursor = aux         # (B,H,C,Dh) x2 + cursor
    if is_train:
        raise MXNetError("attention_decode is an inference op (train "
                         "with the full-sequence `attention` graph)")
    B, H, S, Dh = q.shape
    capacity = k_cache.shape[2]
    pos, new_cursor, per_slot = _decode_pos(attrs, cursor, B, S, capacity)
    q = _decode_rope_write(attrs, q, k, v, k_cache, v_cache, pos, per_slot)
    scale = 1.0 / float(np.sqrt(Dh))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    pos_rows = pos if per_slot else pos.expand(B)
    q_pos = pos_rows.to(torch.int64)[:, None] + \
        torch.arange(S, device=q.device)[None, :]          # (B, S)
    key_pos = torch.arange(capacity, device=q.device)
    mask = (key_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs,
                       v_cache.to(torch.float32))
    return [out.to(q.dtype)], [k_cache, v_cache, new_cursor]


def _attention_decode_cuda(attrs, inputs, aux, is_train, rng):
    """CUDA variant: the same RoPE + cache write, then the attention read
    through the flash-decode kernel, which reads only each row's live
    prefix [0, cursor_b + S) and dequantizes fp8 cells as it reads."""
    q, k, v = inputs
    k_cache, v_cache, cursor = aux
    if is_train:
        raise MXNetError("attention_decode is an inference op (train "
                         "with the full-sequence `attention` graph)")
    B, H, S, Dh = q.shape
    capacity = k_cache.shape[2]
    pos, new_cursor, per_slot = _decode_pos(attrs, cursor, B, S, capacity)
    q = _decode_rope_write(attrs, q, k, v, k_cache, v_cache, pos, per_slot)
    # the kernel is row-cursor uniform: the scalar layout is the per-slot
    # layout with every row at the same position
    pos_rows = pos if per_slot else pos.expand(B).contiguous()
    out = cuda_kernels.decode_attention(q.contiguous(), k_cache, v_cache,
                                        pos_rows)
    return [out.to(q.dtype)], [k_cache, v_cache, new_cursor]


def _attention_decode_infer(attrs, in_shapes):
    q_s = in_shapes[0]
    c = int(attrs.get("capacity", 256))
    per_slot = parse_bool(attrs.get("per_slot", False))
    if q_s is None:
        return in_shapes, [None], [None, None, None if per_slot else (1,)]
    b, h, _s, dh = q_s
    cache = (b, h, c, dh)
    cur = (b, 1) if per_slot else (1,)
    return [q_s, q_s, q_s], [q_s], [cache, cache, cur]


#: aliases accepted by the ``cache_dtype`` attr (fp8 KV storage)
_CACHE_DTYPE_ALIASES = {"fp8": "float8_e4m3fn",
                        "e4m3": "float8_e4m3fn",
                        "e5m2": "float8_e5m2"}


def _cache_dtype_of(attrs):
    """The declared KV-cache storage dtype, or None for the default
    (float32) cells — only non-default graphs stamp ``__dtype__`` on the
    cache cells, so graphs serialize as the JAX package serializes them."""
    val = str(attrs.get("cache_dtype", "") or "").strip()
    if not val:
        return None
    return _CACHE_DTYPE_ALIASES.get(val, val)


# --------------------------------------------------------------------------
# pallas_sgd_mom_update: the explicit op name of the fused SGD-momentum
# update (mxnet_tpu/rtc.py). Unlike sgd_mom_update it is functional — it
# returns the new weight and momentum and leaves its inputs alone — so the
# CUDA variant runs the in-place kernel on copies.
# --------------------------------------------------------------------------
def _pallas_sgd_hyper(attrs):
    clip = attrs.get("clip_gradient")
    return dict(lr=float(attrs["lr"]),
                momentum=float(attrs.get("momentum", 0.0)),
                wd=float(attrs.get("wd", 0.0)),
                rescale=float(attrs.get("rescale_grad", 1.0)),
                clip=-1.0 if clip is None else float(clip))


def _pallas_sgd_mom_plain(attrs, weight, grad, mom):
    return sgd_mom_step(weight, grad, mom, **_pallas_sgd_hyper(attrs))


def _pallas_sgd_mom_cuda(attrs, inputs, aux, is_train, rng):
    w, g, m = inputs
    return list(cuda_kernels.sgd_mom_update(
        w.clone(), g, m.clone(), **_pallas_sgd_hyper(attrs))), []


def pallas_sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                          rescale_grad=1.0, clip_gradient=None):
    """The fused SGD-momentum update as a function, the JAX package's
    ``mx.rtc.pallas_sgd_mom_update``: (weight', mom'), its inputs left
    alone; the ``sgd_mom`` kernel on copies on the card, the plain update
    on the CPU."""
    hyper = _pallas_sgd_hyper({"lr": lr, "momentum": momentum, "wd": wd,
                               "rescale_grad": rescale_grad,
                               "clip_gradient": clip_gradient})
    return cuda_kernels.sgd_mom_update(weight.clone(), grad, mom.clone(),
                                       **hyper)


def _register():
    for name in ("attention", "pallas_flash_attention"):
        if name not in OP_REGISTRY:
            plain, cuda = _attention_forwards(name)
            register(name, inputs=("q", "k", "v"),
                     simple=plain, shape_passthrough=True,
                     attr_spec={"causal": (None, False),
                                "block_q": (int, 128),
                                "block_k": (int, 128)},
                     variants={"cuda": cuda})
    if "attention_decode" not in OP_REGISTRY:
        register("attention_decode", inputs=("q", "k", "v"),
                 aux=("k_cache", "v_cache", "cache_pos"),
                 full=_attention_decode_fwd,
                 stateful_infer=True,
                 aux_dtypes={"cache_pos": "int32",
                             "k_cache": _cache_dtype_of,
                             "v_cache": _cache_dtype_of},
                 infer_shape=_attention_decode_infer,
                 attr_spec={"capacity": (int, 256),
                            "rope": (None, False),
                            "rope_base": (float, 10000.0),
                            "per_slot": (None, False),
                            "cache_dtype": (str, "")}).add_variant(
            "cuda", _attention_decode_cuda,
            backward_pending="a decode-attention backward (the op is "
                             "inference-only; training takes the "
                             "full-sequence attention graph)")
    if "pallas_sgd_mom_update" not in OP_REGISTRY:
        register("pallas_sgd_mom_update", inputs=("weight", "grad", "mom"),
                 simple=_pallas_sgd_mom_plain, num_outputs=2,
                 output_names=["weight_out", "mom_out"],
                 attr_spec={"lr": (float, None), "momentum": (float, 0.0),
                            "wd": (float, 0.0),
                            "rescale_grad": (float, 1.0),
                            "clip_gradient": (float, None)}).add_variant(
            "cuda", _pallas_sgd_mom_cuda,
            backward_pending="a gradient of the update itself, which the "
                             "JAX package takes through its composition")


_register()

# --------------------------------------------------------------------------
# user CUDA kernels: the build (NVRTC) and the driver API
# --------------------------------------------------------------------------
_CTYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
           torch.int32: "int"}
_ARCH = "sm_90a"
_lock = threading.Lock()
_LAUNCHES = {}         # user kernel name -> launches
_FUNCS = {}            # (source, device index) -> CUfunction
_CONTEXTS = {}         # device index -> its primary CUcontext
#: "cuda" -> the driver library; "nvrtc" -> (NVRTC, its include dir) or
#: None where the toolkit has no NVRTC
_libs = {}


def kernel_source(name, params, body, with_n):
    """The CUDA source of user kernel ``name``: ``extern "C" __global__
    void name(<params>[, long long n]) { body }``, where ``params`` is a
    list of (name, torch dtype, read-only) and ``with_n`` adds the
    element count ``n``. Dtypes other than float32, bfloat16 and int32
    raise."""
    args = []
    for pname, dtype, const in params:
        ctype = _CTYPES.get(dtype)
        if ctype is None:
            raise MXNetError(
                f"user kernel {name!r}: {pname!r} is {dtype}; a user "
                "kernel takes float32, bfloat16 or int32")
        args.append(f"{'const ' if const else ''}{ctype}* {pname}")
    if with_n:
        args.append("long long n")
    head = "#include <cuda_bf16.h>\n" if any(
        dt == torch.bfloat16 for _, dt, _ in params) else ""
    return (f'{head}extern "C" __global__ void {name}({", ".join(args)})\n'
            f"{{\n{body}\n}}\n")


def _cuda_homes():
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    return [h for h in dict.fromkeys(homes) if h and os.path.isdir(h)]


def _nvrtc():
    """(the NVRTC library, its CUDA include dir), its builtins loaded
    first so that NVRTC finds them; None where no CUDA home has one."""
    if "nvrtc" in _libs:
        return _libs["nvrtc"]
    found_lib = None
    for home in _cuda_homes():
        found = sorted(glob.glob(os.path.join(home, "lib64", "libnvrtc.so*")))
        if not found:
            continue
        for builtins in sorted(glob.glob(os.path.join(
                home, "lib64", "libnvrtc-builtins.so*"))):
            ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
            break
        lib = ctypes.CDLL(found[0])
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        found_lib = (lib, os.path.join(home, "include"))
        break
    _libs["nvrtc"] = found_lib
    return found_lib


def _nvrtc_cubin(nvrtc, name, source):
    lib, include = nvrtc

    def check(res, what):
        if res != 0:
            raise MXNetError(f"user kernel {name!r}: {what} failed: "
                             f"{lib.nvrtcGetErrorString(res).decode()}")

    prog = ctypes.c_void_p()
    check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                 f"{name}.cu".encode(), 0, None, None),
          "nvrtcCreateProgram")
    try:
        opts = [f"--gpu-architecture={_ARCH}".encode(),
                f"-I{include}".encode()]
        res = lib.nvrtcCompileProgram(prog, len(opts),
                                      (ctypes.c_char_p * len(opts))(*opts))
        size = ctypes.c_size_t()
        check(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
              "nvrtcGetProgramLogSize")
        log = ctypes.create_string_buffer(size.value)
        check(lib.nvrtcGetProgramLog(prog, log), "nvrtcGetProgramLog")
        log = log.value.decode(errors="replace")
        if res != 0:
            raise MXNetError(
                f"user kernel {name!r} does not compile (NVRTC: "
                f"{lib.nvrtcGetErrorString(res).decode()}):\n{log}\n"
                f"--- source ---\n{source}")
        check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
              "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _cubin(name, source):
    """The sm_90a cubin of ``source``, from ``build/kernels/`` when an
    earlier run compiled the same source."""
    digest = hashlib.sha256(f"{_ARCH}\n{source}".encode()).hexdigest()[:16]
    path = cuda_kernels._BUILD_DIR / f"rtc_{name}_{digest}.cubin"
    if path.exists():
        return path.read_bytes()
    nvrtc = _nvrtc()
    if nvrtc is None:
        looked = ", ".join(os.path.join(h, "lib64") for h in _cuda_homes())
        raise MXNetError(
            f"user kernel {name!r} compiles with NVRTC, and no libnvrtc.so "
            "was found under $CUDA_HOME, $CUDA_PATH or /usr/local/cuda "
            f"(looked in: {looked or 'none of them exists'})")
    cubin = _nvrtc_cubin(nvrtc, name, source)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(cubin)
    os.replace(tmp, path)
    return cubin


def _driver():
    lib = _libs.get("cuda")
    if lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuLaunchKernel.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_uint] * 7 + [ctypes.c_void_p] * 3
        _check(lib, lib.cuInit(0), "cuInit")
        _libs["cuda"] = lib
    return lib


def _check(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError(f"{what} failed: CUresult {res} "
                         f"({(msg.value or b'?').decode()})")


def _make_current(lib, index):
    """Make device ``index``'s primary context (PyTorch's) current on
    this thread; modules and launches belong to it."""
    ctx = _CONTEXTS.get(index)
    if ctx is None:
        torch.cuda.current_device()
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        _check(lib, lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        if not ctx.value:
            raise MXNetError(f"no CUDA context for device {index}")
        _CONTEXTS[index] = ctx
    cur = ctypes.c_void_p()
    _check(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def _function(lib, name, source, index):
    key = (source, index)
    fn = _FUNCS.get(key)
    if fn is None:
        with _lock:
            fn = _FUNCS.get(key)
            if fn is None:
                image = _cubin(name, source)
                mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
                _check(lib, lib.cuModuleLoadData(ctypes.byref(mod), image),
                       f"loading user kernel {name!r}")
                _check(lib, lib.cuModuleGetFunction(
                    ctypes.byref(fn), mod, name.encode()),
                    f"finding user kernel {name!r}")
                _FUNCS[key] = fn
    return fn


def _dims(dims, what):
    dims = (dims,) if isinstance(dims, int) else tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


def _launch_user(counter, name, source, tensors, n, grid, block):
    """Launch user kernel ``name`` (compiled from ``source``) over the
    contiguous CUDA ``tensors`` (then ``n``, when not None) on the current
    stream, and count it under ``counter``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise MXNetError(f"user kernel {name!r}: tensors span {dev} and "
                             f"{t.device}")
    lib = _driver()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with torch.cuda.device(index):
        _make_current(lib, index)
        fn = _function(lib, name, source, index)
        args = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
        if n is not None:
            args.append(ctypes.c_longlong(n))
        params = (ctypes.c_void_p * len(args))(
            *[ctypes.addressof(a) for a in args])
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.cuLaunchKernel(fn, *_dims(grid, "grid"),
                                       *_dims(block, "block"), 0, stream,
                                       params, None),
               f"launching user kernel {name!r}")
    _LAUNCHES[counter] = _LAUNCHES.get(counter, 0) + 1


def launch_counts():
    """{user kernel name: launches so far}."""
    return dict(_LAUNCHES)


def reset_launch_counts():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _on_card(name, tensors):
    if any(t.device.type != "cuda" for t in tensors):
        raise MXNetError(
            f"user kernel {name!r} runs on CUDA tensors only: the port "
            "compiles CUDA source for the card and has no interpreter for "
            "it on the host")


class Rtc:
    """A user CUDA kernel pushed onto NDArrays (MXNet's ``mx.rtc.Rtc``).

    ``inputs`` / ``outputs`` are (name, NDArray) pairs that fix each
    argument's name, shape and dtype; ``kernel`` is the body of the
    ``__global__`` function, whose signature the port writes as
    ``extern "C" __global__ void <name>(const T* <input>..., T* <output>
    ...)`` (``source`` holds the whole text). The kernel compiles at the
    first push."""

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self._ins = [(nm, tuple(a.shape), a.astorch().dtype)
                     for nm, a in inputs]
        self._outs = [(nm, tuple(a.shape), a.astorch().dtype)
                      for nm, a in outputs]
        self.source = kernel_source(
            name, [(nm, dt, True) for nm, _, dt in self._ins] +
            [(nm, dt, False) for nm, _, dt in self._outs], kernel, False)
        _LAUNCHES.setdefault(name, 0)

    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Launch on ``ins`` and write ``outs`` in place, over
        ``grid_dims`` blocks of ``block_dims`` threads (each 1 to 3
        ints); by default a 1-D grid of 256-thread blocks over the first
        output's elements. The kernel sees contiguous arrays: a
        non-contiguous output is computed in a contiguous copy, which is
        then written back through it, so the array it views sees the
        result."""
        if len(ins) != len(self._ins):
            raise MXNetError(f"{self.name}: expected "
                             f"{len(self._ins)} inputs")
        if len(outs) != len(self._outs):
            raise MXNetError(f"{self.name}: expected "
                             f"{len(self._outs)} outputs, "
                             f"got {len(outs)}")
        for a, (nm, shp, _) in zip(ins, self._ins):
            if tuple(a.shape) != shp:
                raise MXNetError(f"{self.name}: input {nm!r} shape "
                                 f"{tuple(a.shape)} != declared {shp}")
        for i, (o, (_, shp, _)) in enumerate(zip(outs, self._outs)):
            if tuple(o.shape) != shp:
                raise MXNetError(f"{self.name}: output {i} shape "
                                 f"{tuple(o.shape)} != declared {shp}")
        for a, (nm, _, dt) in zip(list(ins) + list(outs),
                                  self._ins + self._outs):
            if a.astorch().dtype != dt:
                raise MXNetError(f"{self.name}: {nm!r} is "
                                 f"{a.astorch().dtype}, declared {dt}")
        src = [a.astorch().contiguous() for a in ins]
        dst = [o.astorch().contiguous() for o in outs]
        _on_card(self.name, src + dst)
        n = dst[0].numel() if dst else 0
        block = (256,) if block_dims is None else block_dims
        grid = (max(1, -(-n // 256)),) if grid_dims is None else grid_dims
        _launch_user(self.name, self.name, self.source, src + dst, None,
                     grid, block)
        for o, t in zip(outs, dst):
            if t is o.astorch():
                increment_version(t)
            else:                   # a view: write back through it
                with torch.no_grad():
                    o.astorch().copy_(t)
        return outs


class _CudaOp:
    """A registered user op's kernels: the forward ``name`` over
    ``(inputs..., out | out0, out1..., n)`` and the VJP ``name_vjp`` over
    ``(inputs..., ct | ct0, ct1..., grad_<input>..., n)``."""

    def __init__(self, name, kernel, vjp_kernel, out_shapes, inputs, grid,
                 block):
        self.name, self.kernel, self.vjp_kernel = name, kernel, vjp_kernel
        self.out_shapes, self.inputs = out_shapes, tuple(inputs)
        self.grid, self.block = grid, block

    def _launch(self, kname, body, attrs, in_shapes, ins, outs, names):
        params = [(nm, t.dtype, i < len(ins))
                  for i, (nm, t) in enumerate(zip(names, ins + outs))]
        source = kernel_source(kname, params, body, True)
        n = outs[0].numel()
        block = self.block(attrs, in_shapes) if callable(self.block) \
            else self.block
        block = (256,) if block is None else block
        grid = self.grid(attrs, in_shapes) if callable(self.grid) \
            else self.grid
        if grid is None:
            grid = (max(1, -(-n // math.prod(_dims(block, "block")))),)
        _launch_user(kname, kname, source, ins + outs, n, grid, block)
        return outs

    def forward(self, attrs, ins):
        ins = [t.contiguous() for t in ins]
        _on_card(self.name, ins)
        in_shapes = [tuple(t.shape) for t in ins]
        outs = [torch.empty(tuple(s), device=ins[0].device,
                            dtype=ins[0].dtype if dt is None
                            else to_torch_dtype(dt))
                for s, dt in self.out_shapes(attrs, in_shapes)]
        names = list(self.inputs) + (["out"] if len(outs) == 1 else
                                     [f"out{i}" for i in range(len(outs))])
        return self._launch(self.name, self.kernel(attrs), attrs, in_shapes,
                            ins, outs, names)

    def vjp(self, attrs, ins, cts):
        ins = [t.contiguous() for t in ins]
        cts = [c.contiguous() for c in cts]
        in_shapes = [tuple(t.shape) for t in ins]
        grads = [torch.empty_like(t) for t in ins]
        cts_names = ["ct"] if len(cts) == 1 else \
            [f"ct{i}" for i in range(len(cts))]
        names = list(self.inputs) + cts_names + \
            [f"grad_{nm}" for nm in self.inputs]
        return self._launch(f"{self.name}_vjp", self.vjp_kernel(attrs),
                            attrs, in_shapes, ins + cts, grads, names)


class _CudaOpFn(torch.autograd.Function):
    """A user op with a VJP kernel: the forward kernel forward, the VJP
    kernel backward."""

    @staticmethod
    def forward(ctx, op, attrs, *ins):
        ctx.op, ctx.attrs = op, attrs
        ctx.save_for_backward(*ins)
        return tuple(op.forward(attrs, list(ins)))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *ctx.op.vjp(ctx.attrs, ctx.saved_tensors,
                                        list(cts)))


def register_cuda_op(name, kernel, out_shapes, inputs=("data",),
                     vjp_kernel=None, grid=None, block=None, attr_spec=None,
                     reference=None):
    """Register a user CUDA kernel as the op ``name`` (``mx.nd.<name>``,
    ``mx.sym.<name>``): the counterpart of the JAX package's
    ``register_pallas_op``.

    Parameters
    ----------
    kernel : fn(attrs) -> the body of the forward kernel, attrs formatted
        in. Its signature: one ``const T*`` per input (named as in
        ``inputs``), one ``T*`` per output (``out``, or ``out0``,
        ``out1`` ...), then ``long long n``, the first output's element
        count.
    out_shapes : fn(attrs, in_shapes) -> [(shape, dtype or None)]; None
        takes input 0's dtype. In a graph the op has one output.
    vjp_kernel : optional fn(attrs) -> the body of the backward kernel,
        over the inputs, the cotangents (``ct``, or ``ct0`` ...) and one
        gradient per input (``grad_<input>``), then ``n`` (input 0's
        element count). With it the op is differentiable on the card;
        without it the card refuses inputs that require grad.
    grid, block : each a value (1 to 3 ints) or fn(attrs, in_shapes);
        by default 256-thread blocks, as many as cover ``n`` once. Both
        kernels launch with them.
    reference : optional plain PyTorch version fn(attrs, *inputs) with
        the kernel's semantics: the op's forward on CPU tensors (and its
        gradient there, through PyTorch's autograd). Without it a CPU
        call raises.

    Each source compiles once (cached per its text, which holds the
    dtypes); launches count under ``name`` and ``name_vjp``. The op's
    ``variants["cuda"]["kernels"]`` launches either kernel alone:
    ``forward(attrs, inputs)`` and ``vjp(attrs, inputs, cotangents)``
    return new tensors."""
    op = _CudaOp(name, kernel, vjp_kernel, out_shapes, inputs, grid, block)

    def cuda_variant(attrs, ins, aux, is_train, rng):
        if vjp_kernel is None:
            return op.forward(attrs, list(ins)), []
        return list(_CudaOpFn.apply(op, attrs, *ins)), []

    def no_plain(attrs, ins, aux, is_train, rng):
        raise MXNetError(
            f"op {name!r} has no plain version (register_cuda_op(..., "
            "reference=...)): the port has no interpreter for CUDA "
            "source, so it runs on CUDA tensors only")

    def infer(attrs, in_shapes):
        if any(s is None for s in in_shapes):
            return in_shapes, [None], []
        return in_shapes, [tuple(s) for s, _ in out_shapes(
            attrs, [tuple(s) for s in in_shapes])], []

    def nbytes(attrs, in_shapes):
        # the accounting sees shapes alone: inputs count at its 4 B an
        # element (ops/cost.py), outputs at their declared dtype's width
        outs = out_shapes(attrs, [tuple(s) for s in in_shapes])
        return 4.0 * sum(math.prod(s) for s in in_shapes) + sum(
            math.prod(s) * (4 if dt is None else to_torch_dtype(dt).itemsize)
            for s, dt in outs)

    kw = dict(inputs=tuple(inputs), attr_spec=attr_spec or {},
              infer_shape=infer)
    opdef = register(name, simple=reference, **kw) if reference is not None \
        else register(name, full=no_plain, **kw)
    opdef.add_variant(
        "cuda", cuda_variant,
        backward_pending=None if vjp_kernel is not None else
        f"{name}'s vjp_kernel (register_cuda_op(..., vjp_kernel=...))")
    opdef.variants["cuda"]["kernels"] = op
    # a user kernel's operations are unknown to the port: 0 FLOPs; its
    # bytes are each input read once and each output written once
    opdef.set_cost(flops=lambda attrs, in_shapes: 0.0, bytes_moved=nbytes)
    _LAUNCHES.setdefault(name, 0)
    if vjp_kernel is not None:
        _LAUNCHES.setdefault(f"{name}_vjp", 0)
    from . import _op_gen, ndarray, symbol
    _op_gen.init_ndarray_module(ndarray.__dict__)
    symbol._init_symbol_module(symbol.__dict__)
    return opdef


# rtc's ops register after ops/cost.py's import-time pass — re-seed so
# attention / attention_decode / pallas_sgd_mom_update carry estimators
from .ops import cost as _cost          # noqa: E402
_cost.seed_costs()
