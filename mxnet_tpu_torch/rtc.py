"""Attention ops of the transformer LM (``attention``, its explicit name
``pallas_flash_attention``, and the KV-cache ``attention_decode``), and
the ``pallas_sgd_mom_update`` op name.

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
JAX package registers for its kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, parse_bool, parse_float
from .ops import cuda_kernels
from .ops.nn import rope_apply
from .ops.optimizer_op import sgd_mom_step
from .ops.registry import OP_REGISTRY, register

__all__ = ["flash_attention_fn", "fp8_cast"]


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
    """Forward: the flash kernel. Backward: the vector-Jacobian product
    of ``_attention_plain`` recomputed from the saved q, k, v (the JAX
    package's flash recompute, ``mxnet_tpu/rtc.py`` ``flash_attention``);
    the recompute is plain PyTorch, as the JAX package's is XLA."""

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


def _attention_cuda(attrs, inputs, aux, is_train, rng):
    q, k, v = (t.contiguous() for t in inputs)
    return [flash_attention_fn(q, k, v,
                               parse_bool(attrs.get("causal", False)))], []


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


def _register():
    for name in ("attention", "pallas_flash_attention"):
        if name not in OP_REGISTRY:
            register(name, inputs=("q", "k", "v"),
                     simple=_attention_plain, shape_passthrough=True,
                     attr_spec={"causal": (None, False),
                                "block_q": (int, 128),
                                "block_k": (int, 128)},
                     variants={"cuda": _attention_cuda})
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

# rtc's ops register after ops/cost.py's import-time pass — re-seed so
# attention / attention_decode / pallas_sgd_mom_update carry estimators
from .ops import cost as _cost          # noqa: E402
_cost.seed_costs()
