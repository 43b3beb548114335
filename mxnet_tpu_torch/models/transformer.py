"""Decoder-only transformer LM + KV-cache incremental decoders.

The JAX package's model, node for node and name for name: a pre-LN,
tied-embedding language model over ``Embedding`` (CUDA gather kernel),
``LayerNorm`` (CUDA kernel), ``attention_decode`` (CUDA flash-decode
kernel for the attention read), ``FusedBiasGeLU`` (CUDA epilogue kernel)
and ``FullyConnected`` / ``dot`` (``torch.matmul``). A parameter set from
``mxnet_tpu`` loads unchanged.

* ``get_decode_symbol`` — the inference decoder: ``(B, S)`` new tokens per
  step, per-layer K/V caches riding executor aux state.
* ``get_symbol(include_loss=False)`` — the full-sequence forward, logits
  ``(B, T, V)``: the reference the decode parity tests compare against.

``KVCacheDecoder`` (one shared cursor) and ``BatchedKVCacheDecoder`` (one
cursor per slot) drive a bound decode module and own what the device
cannot check cheaply: host-side cursor mirrors, so capacity overflow is
caught before dispatch without reading the device cursor back.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import symbol as sym
from ..base import MXNetError

__all__ = ["get_symbol", "get_decode_symbol", "KVCacheDecoder",
           "BatchedKVCacheDecoder", "default_cache_capacity"]


def default_cache_capacity():
    """Decode cache capacity default: ``MXNET_LM_CACHE_CAPACITY``, else
    256 positions."""
    try:
        return int(os.environ.get("MXNET_LM_CACHE_CAPACITY", "256"))
    except ValueError:
        return 256


def _proj(x, num_hidden, name, no_bias=False):
    """FullyConnected over the flattened (B*T, D) token axis."""
    flat = sym.Reshape(x, shape=(-3, 0), name=f"{name}_fold")
    return sym.FullyConnected(flat, num_hidden=num_hidden, name=name,
                              no_bias=no_bias)


def _block(x, *, i, seq_len, d_model, n_head, pos_embed, rope_base, name,
           decode=False, capacity=None, per_slot=False):
    """One pre-LN transformer block; ``decode=True`` swaps the full
    ``attention`` for the KV-cache ``attention_decode`` (same parameter
    names either way)."""
    pfx = f"{name}_l{i}"
    dh = d_model // n_head
    T = seq_len

    ln1 = sym.LayerNorm(x, name=f"{pfx}_ln1")
    qkv = _proj(ln1, 3 * d_model, f"{pfx}_qkv")          # (B*T, 3D)
    qkv = sym.Reshape(qkv, shape=(-1, T, 3 * n_head, dh),
                      name=f"{pfx}_qkv_split")
    qkv = sym.transpose(qkv, axes=(0, 2, 1, 3),
                        name=f"{pfx}_qkv_t")             # (B, 3H, T, dh)
    q = sym.slice_axis(qkv, axis=1, begin=0, end=n_head, name=f"{pfx}_q")
    k = sym.slice_axis(qkv, axis=1, begin=n_head, end=2 * n_head,
                       name=f"{pfx}_k")
    v = sym.slice_axis(qkv, axis=1, begin=2 * n_head, end=3 * n_head,
                       name=f"{pfx}_v")
    if decode:
        att = sym.attention_decode(
            q, k, v, capacity=capacity, rope=(pos_embed == "rotary"),
            rope_base=rope_base, per_slot=per_slot, cache_dtype="",
            name=f"{pfx}_attn")
    else:
        if pos_embed == "rotary":
            q = sym.RoPE(q, base=rope_base, name=f"{pfx}_rope_q")
            k = sym.RoPE(k, base=rope_base, name=f"{pfx}_rope_k")
        att = sym.attention(q, k, v, causal=True, name=f"{pfx}_attn")
    att = sym.transpose(att, axes=(0, 2, 1, 3),
                        name=f"{pfx}_attn_t")            # (B, T, H, dh)
    att = sym.Reshape(att, shape=(-3, -3), name=f"{pfx}_attn_merge")
    proj = sym.FullyConnected(att, num_hidden=d_model, name=f"{pfx}_proj")
    proj = sym.Reshape(proj, shape=(-1, T, d_model),
                       name=f"{pfx}_proj_unfold")
    x = x + proj

    ln2 = sym.LayerNorm(x, name=f"{pfx}_ln2")
    # dense -> GeLU as the fused epilogue pair: the matmul emits raw rows
    # (no_bias) and FusedBiasGeLU folds bias + erf-GeLU in one pass
    h = _proj(ln2, 4 * d_model, f"{pfx}_ffn1", no_bias=True)
    h = sym.FusedBiasGeLU(h, name=f"{pfx}_ffn_gelu")
    h = sym.FullyConnected(h, num_hidden=d_model, name=f"{pfx}_ffn2")
    h = sym.Reshape(h, shape=(-1, T, d_model), name=f"{pfx}_ffn_unfold")
    return x + h


def _validate(d_model, n_head, pos_embed):
    if d_model % n_head:
        raise MXNetError(f"d_model {d_model} must divide n_head {n_head}")
    if (d_model // n_head) % 2:
        raise MXNetError("head dim must be even (RoPE rotates pairs)")
    if pos_embed not in ("rotary", "learned"):
        raise MXNetError(f"pos_embed {pos_embed!r}: 'rotary' or 'learned'")


def _embed(data, tok_w, *, seq_len, vocab_size, d_model, pos_embed,
           max_seq_len, name, pos_ids=None, per_slot=False):
    """Token embedding scaled by sqrt(D), plus the learned position table
    when ``pos_embed='learned'``."""
    x = sym.Embedding(data=data, weight=tok_w, input_dim=vocab_size,
                      output_dim=d_model, scale=float(np.sqrt(d_model)),
                      name=f"{name}_tok_embed")          # (B, T, D)
    if pos_embed == "learned":
        if pos_ids is None:
            pos_ids = sym._arange(start=0, stop=float(seq_len),
                                  name=f"{name}_pos_ids")
        pos_w = sym.var(f"{name}_pos_embed_weight")
        pos = sym.Embedding(data=pos_ids, weight=pos_w,
                            input_dim=max_seq_len, output_dim=d_model,
                            name=f"{name}_pos_embed")
        if per_slot:
            x = x + pos
        else:
            pos = sym.expand_dims(pos, axis=0, name=f"{name}_pos_b")
            x = sym.broadcast_add(x, pos, name=f"{name}_add_pos")
    return x


def get_symbol(vocab_size=256, d_model=64, n_layer=2, n_head=4,
               seq_len=32, pos_embed="rotary", rope_base=10000.0,
               dropout=0.0, include_loss=False, max_seq_len=None,
               name="lm"):
    """Full-sequence forward: data ``(B, seq_len)`` token ids -> logits
    ``(B, seq_len, vocab)``. Only the loss-free graph is ported (the loss
    head belongs to training), and its ``attention`` runs on the CPU
    until its flash kernel is ported."""
    if include_loss or dropout:
        raise MXNetError("get_symbol: the training graph (loss head, "
                         "dropout) is not ported yet; use "
                         "include_loss=False, dropout=0")
    _validate(d_model, n_head, pos_embed)
    max_seq_len = max_seq_len or seq_len
    T = seq_len
    data = sym.var("data")
    tok_w = sym.var(f"{name}_tok_embed_weight")
    x = _embed(data, tok_w, seq_len=T, vocab_size=vocab_size,
               d_model=d_model, pos_embed=pos_embed,
               max_seq_len=max_seq_len, name=name)
    for i in range(n_layer):
        x = _block(x, i=i, seq_len=T, d_model=d_model, n_head=n_head,
                   pos_embed=pos_embed, rope_base=rope_base, name=name)
    x = sym.LayerNorm(x, name=f"{name}_ln_f")
    flat = sym.Reshape(x, shape=(-3, 0), name=f"{name}_head_fold")
    # tied-embedding head: logits = x @ E^T over the token table
    logits = sym.dot(flat, tok_w, transpose_b=True,
                     name=f"{name}_logits")              # (B*T, V)
    return sym.Reshape(logits, shape=(-1, T, vocab_size),
                       name=f"{name}_logits_btv")


def get_decode_symbol(vocab_size=256, d_model=64, n_layer=2, n_head=4,
                      pos_embed="rotary", rope_base=10000.0,
                      capacity=None, step_len=1, max_seq_len=None,
                      per_slot=False, cache_dtype=None, name="lm"):
    """Incremental KV-cache decoder: ``(B, step_len)`` new token ids in,
    logits ``(B, step_len, vocab)`` out, per-layer float32 K/V caches of
    ``capacity`` positions riding executor aux state. ``per_slot=True``
    builds the slot-pooled graph (a (B, 1) cursor per slot) that
    ``BatchedKVCacheDecoder`` and ``serve.decode`` drive. The fp8 cache
    (``cache_dtype``) is not ported yet and raises."""
    if cache_dtype:
        raise MXNetError("get_decode_symbol: the fp8 KV cache "
                         f"(cache_dtype={cache_dtype!r}) is not ported yet")
    _validate(d_model, n_head, pos_embed)
    capacity = capacity or default_cache_capacity()
    max_seq_len = max_seq_len or capacity
    S = step_len
    data = sym.var("data")
    tok_w = sym.var(f"{name}_tok_embed_weight")
    pos_ids = sym.var("pos_ids") if pos_embed == "learned" else None
    x = _embed(data, tok_w, seq_len=S, vocab_size=vocab_size,
               d_model=d_model, pos_embed=pos_embed,
               max_seq_len=max_seq_len, name=name, pos_ids=pos_ids,
               per_slot=per_slot)
    for i in range(n_layer):
        x = _block(x, i=i, seq_len=S, d_model=d_model, n_head=n_head,
                   pos_embed=pos_embed, rope_base=rope_base, name=name,
                   decode=True, capacity=capacity, per_slot=per_slot)
    x = sym.LayerNorm(x, name=f"{name}_ln_f")
    flat = sym.Reshape(x, shape=(-3, 0), name=f"{name}_head_fold")
    logits = sym.dot(flat, tok_w, transpose_b=True, name=f"{name}_logits")
    return sym.Reshape(logits, shape=(-1, S, vocab_size),
                       name=f"{name}_logits_bsv")


def _cells(module, suffixes):
    exe = module._exec_group.executor
    return [cell for nm, cell in exe.aux_dict.items()
            if nm.endswith(suffixes)]


class KVCacheDecoder:
    """Host-side driver for a bound decode module (one shared cursor).

    Owns the absolute position (capacity overflow raises HERE, before a
    write would clamp), the ``pos_ids`` feed for learned positions, and
    cache reset between sequences. The module must be bound
    ``for_training=False`` over ``get_decode_symbol``'s graph."""

    def __init__(self, module, capacity, pos_embed="rotary"):
        self._mod = module
        self.capacity = int(capacity)
        self.pos_embed = pos_embed
        self.pos = 0

    def reset(self):
        """Zero every decode cache and cursor (in place) and rewind."""
        for cell in _cells(self._mod, ("k_cache", "v_cache", "cache_pos")):
            cell.astorch().zero_()
        self.pos = 0

    def step(self, tokens):
        """Decode one window: tokens ``(B, S)`` -> logits ``(B, S, V)``
        NDArray. Advances the device caches and the host cursor."""
        from .. import ndarray as nd
        from ..io import DataBatch
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        S = tokens.shape[1]
        if self.pos + S > self.capacity:
            raise MXNetError(
                f"KV cache overflow: position {self.pos} + {S} new "
                f"tokens exceeds capacity {self.capacity}; reset() or "
                "re-bind with a larger capacity")
        data = [nd.array(tokens.astype(np.int32), ctx=self._ctx())]
        if self.pos_embed == "learned":
            data.append(nd.array(
                np.arange(self.pos, self.pos + S, dtype=np.float32),
                ctx=self._ctx()))
        self._mod.forward(DataBatch(data=data, label=[]), is_train=False)
        self.pos += S
        return self._mod.get_outputs()[0]

    def _ctx(self):
        return self._mod._exec_group.context


class BatchedKVCacheDecoder:
    """Host-side driver for a bound SLOT-POOLED decode module.

    The module is bound ``for_training=False`` over
    ``get_decode_symbol(per_slot=True)``'s graph at a fixed slot count.
    Each slot is an independent sequence: ``join`` claims a slot (rewinds
    its device cursor), ``leave`` releases it host-side only (the retired
    row keeps advancing harmlessly inside its own slot), and ``step``
    advances EVERY slot by one token in one dispatch. ``pos`` mirrors the
    device cursors on the host, so overflow is caught before dispatch and
    the device cursor is never read back. The cursor pokes (``join``,
    ``rewind_many``) write the cursor cells in place."""

    def __init__(self, module, capacity, slots=None, pos_embed="rotary"):
        self._mod = module
        self.capacity = int(capacity)
        self.pos_embed = pos_embed
        if slots is None:
            slots = module.data_shapes[0].shape[0]
        self.slots = int(slots)
        self.pos = np.zeros(self.slots, np.int64)    # device-cursor mirror
        self.active = np.zeros(self.slots, bool)

    def _cursor_cells(self):
        return _cells(self._mod, ("cache_pos",))

    def join(self, slot):
        """Claim ``slot`` for a new sequence: rewind its cursor to 0 in
        every layer and mark it active. Cache rows are not zeroed: every
        position a fresh sequence attends is rewritten by it first, and
        positions past its prefix carry exactly zero softmax weight."""
        slot = int(slot)
        if self.active[slot]:
            raise MXNetError(f"slot {slot} already holds an active "
                             "sequence (leave() it first)")
        for cell in self._cursor_cells():
            cell.astorch()[slot, 0] = 0
        self.pos[slot] = 0
        self.active[slot] = True
        return slot

    def leave(self, slot):
        """Release ``slot`` host-side; no device work."""
        self.active[int(slot)] = False

    def rewind(self, slot, pos):
        """Poke ``slot``'s device cursor to ``pos`` in every layer."""
        self.rewind_many([slot], [pos])

    def rewind_many(self, slots, positions):
        """Batched ``rewind``: one indexed write per layer cursor."""
        if not len(slots):
            return
        idx = np.asarray(slots, np.int64)
        val = np.asarray(positions, np.int32)
        for cell in self._cursor_cells():
            t = cell.astorch()
            t[torch.as_tensor(idx, device=t.device), 0] = \
                torch.as_tensor(val, device=t.device)
        self.pos[idx] = val.astype(np.int64)

    def overflowing(self, window=1):
        """Active slots whose next ``window``-token dispatch would pass
        capacity — the scheduler retires these (alone) before dispatch."""
        return [i for i in range(self.slots)
                if self.active[i] and self.pos[i] + window > self.capacity]

    def step(self, tokens):
        """Advance every slot by one token: ``tokens`` (slots,) or
        (slots, 1) int ids (retired slots ride any valid id, 0 by
        convention) -> logits (slots, 1, V) NDArray. Raises BEFORE
        dispatch when an active slot would overflow its cache."""
        from .. import ndarray as nd
        from ..io import DataBatch
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        if tokens.shape != (self.slots, 1):
            raise MXNetError(
                f"step() wants ({self.slots}, 1) tokens, got "
                f"{tokens.shape} (S>1 windows — chunked prefill and "
                "speculative verify — are not ported yet)")
        over = self.overflowing(1)
        if over:
            raise MXNetError(
                f"KV cache overflow in slot(s) {over}: position "
                f"{[int(self.pos[i]) for i in over]} + 1 exceeds "
                f"capacity {self.capacity}; retire the sequence(s) or "
                "re-bind with a larger capacity")
        ctx = self._mod._exec_group.context
        data = [nd.array(tokens.astype(np.int32), ctx=ctx)]
        if self.pos_embed == "learned":
            data.append(nd.array(np.minimum(
                self.pos[:, None], self.capacity - 1).astype(np.float32),
                ctx=ctx))
        self._mod.forward(DataBatch(data=data, label=[]), is_train=False)
        self.pos += 1            # the program advances EVERY slot
        return self._mod.get_outputs()[0]
