"""Ring attention: exact attention over sequence-sharded q, k, v.

The port of ``mxnet_tpu/parallel/ring_attention.py``. The sequence axis
is split into ``n`` contiguous shards, one per position of the mesh's
``seq`` axis; each position keeps its query shard while the K/V shards
rotate around the ring (``collectives.ppermute``, position i to i + 1),
so at ring step s position i holds the K/V of shard (i - s) mod n. Each
step folds one K/V shard into a flash-style online softmax (running max
``m`` and normalizer ``l`` per query row, float32, the accumulator
rescaled when the max moves): exact attention for any ``n``. The causal
mask uses absolute positions (mesh order is sequence order).

One process drives every position (the single-controller mesh of
``parallel.mesh``): a sharded value is a list of per-shard tensors.

One loop, ``_ring``, serves both rings: at each (position, step) a
partial block returns the held shard's unnormalized (acc, m, l), which
``_merge``, the two-block online-softmax combine in plain PyTorch, folds
into the carry (the JAX package merges in XLA, outside its kernel).
Under the causal mask a wholly future shard (position i < step s: the
wrapped shard) is not computed: it adds nothing, as the JAX package's
``valid`` gate makes its terms zero. A causal ring of n therefore takes
n (n + 1) / 2 blocks, a non-causal one n^2.

* ``_ring_attention_plain`` is the JAX package's XLA ring
  (``_ring_attention_xla``): its blocks are
  ``cuda_kernels.flash_attention_partial_plain``, in float32 whatever
  q's dtype (the JAX ring's ``_block_attn_update`` is that block and
  ``_merge``).
* ``_RingFlashFn`` is its kernel ring (``_ring_attention_flash``), an
  ``autograd.Function``. Forward: one ``cuda_kernels.flash_attention_
  partial`` launch per block. Backward: the vector-Jacobian product of
  ``_ring_attention_plain`` recomputed from the saved q, k, v (the JAX
  ``custom_vjp``'s recompute), skipping the same future shards; each
  gradient comes back in its leaf's dtype.

``ring_attention`` picks by device alone: CUDA shards take the kernel
ring, CPU shards the plain ring. ``ring_attention_sharded`` splits
(B, H, T, D) tensors over a mesh's ``seq`` axis (and the batch over a
``data`` axis when asked), runs one ring per ``data`` position and
concatenates the output back.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import cuda_kernels
from .collectives import axis_size, ppermute

__all__ = ["attention", "ring_attention", "ring_attention_sharded"]

_NEG_INF = float("-inf")


def attention(q, k, v, causal=False, scale=None):
    """Plain softmax attention. q, k, v: (B, H, T, D). The default scale
    is 1/sqrt(D) rounded to q's dtype, as the JAX package's."""
    if scale is None:
        root = torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype)
        scale = float(1.0 / root)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def _merge(carry, block):
    """The two-block online-softmax combine: fold one K/V block's
    unnormalized (acc, m, l) into the running carry of the rows it serves
    (the JAX package's merge after each ``flash_attention_partial``). A
    row whose max is -inf adds nothing, on either side."""
    acc, m, l = carry
    acc_s, m_s, l_s = block
    m_new = torch.maximum(m, m_s)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    c_old = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    c_new = torch.where(torch.isfinite(m_s), torch.exp(m_s - m_safe), 0.0)
    return (acc * c_old[..., None] + acc_s * c_new[..., None], m_new,
            l * c_old + l_s * c_new)


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring(q_shards, k_shards, v_shards, causal, scale, contexts, partial):
    """The ring (see the module docstring): at step s position i folds
    ``partial``'s (acc, m, l) of the K/V shard it holds, (i - s) mod n,
    into its carry, skipping a causal ring's wholly future shard; then
    the K/V shards move on by one. Returns the normalized output shards
    in q's dtype."""
    n = len(q_shards)
    T = q_shards[0].shape[2]
    carry = [None] * n
    k_held, v_held = list(k_shards), list(v_shards)
    for step in range(n):
        for i, q in enumerate(q_shards):
            if causal and i < step:
                continue        # the wrapped future shard adds nothing
            block = partial(q, k_held[i], v_held[i], i * T,
                            ((i - step) % n) * T, causal, scale)
            carry[i] = block if carry[i] is None else _merge(carry[i], block)
        if step < n - 1:
            k_held = ppermute(k_held, _ring_perm(n), contexts)
            v_held = ppermute(v_held, _ring_perm(n), contexts)
    return [(acc / torch.clamp_min(l[..., None], 1e-20)).to(q.dtype)
            for (acc, _m, l), q in zip(carry, q_shards)]


def _ring_attention_plain(q_shards, k_shards, v_shards, causal, scale,
                          contexts):
    """The plain ring (the JAX package's XLA ring, also the kernel ring's
    backward recompute): each block by ``flash_attention_partial_plain``,
    differentiable torch ops in float32."""
    return _ring(q_shards, k_shards, v_shards, causal, scale, contexts,
                 cuda_kernels.flash_attention_partial_plain)


class _RingFlashFn(torch.autograd.Function):
    """The kernel ring: forward ``_ring`` over the partial kernel,
    backward the VJP of ``_ring_attention_plain`` recomputed from the
    saved shards.
    Inputs: ``causal``, ``scale``, the ring's contexts, then the q, k and
    v shards (n each); outputs: the n output shards."""

    @staticmethod
    def forward(ctx, causal, scale, contexts, *qkv):
        n = len(contexts)
        ctx.save_for_backward(*qkv)
        ctx.ring = (causal, scale, contexts)
        return tuple(_ring(qkv[:n], qkv[n:2 * n], qkv[2 * n:], causal,
                           scale, contexts,
                           cuda_kernels.flash_attention_partial))

    @staticmethod
    def backward(ctx, *cts):
        causal, scale, contexts = ctx.ring
        n = len(contexts)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            outs = _ring_attention_plain(leaves[:n], leaves[n:2 * n],
                                         leaves[2 * n:], causal, scale,
                                         contexts)
        return (None, None, None,
                *torch.autograd.grad(outs, leaves, cts))


def ring_attention(q_shards, k_shards, v_shards, contexts, causal=False,
                   scale=None):
    """Exact attention over sequence shards: lists of (B, H, T/n, D)
    tensors, shard j on ``contexts[j]``'s device, mesh order being
    sequence order. Returns the output shards. CUDA shards run the kernel
    ring, CPU shards the plain ring; the scale defaults to 1/sqrt(D)."""
    if scale is None:
        scale = 1.0 / float(q_shards[0].shape[-1]) ** 0.5
    kinds = {t.device.type for t in (*q_shards, *k_shards, *v_shards)}
    if kinds == {"cuda"}:
        return list(_RingFlashFn.apply(bool(causal), float(scale),
                                       list(contexts), *q_shards,
                                       *k_shards, *v_shards))
    if kinds == {"cpu"}:
        return _ring_attention_plain(q_shards, k_shards, v_shards,
                                     bool(causal), float(scale), contexts)
    raise MXNetError(f"ring_attention: shards on {sorted(kinds)}; the kernel "
                     "ring takes CUDA shards, the plain ring CPU shards")


def ring_attention_sharded(q, k, v, mesh, causal=False, seq_axis="seq",
                           data_axis=None):
    """Split (B, H, T, D) q, k, v over ``mesh``'s ``seq_axis`` (and B
    over ``data_axis`` when given), run one ring per data position on the
    contexts of its row of the mesh, and return the (B, H, T, D) output
    on q's device."""
    B, _H, T, _D = q.shape
    n_seq = axis_size(seq_axis, mesh)
    n_data = axis_size(data_axis, mesh) if data_axis else 1
    if T % n_seq or B % n_data:
        raise MXNetError(f"ring_attention_sharded: (B, T) = ({B}, {T}) does "
                         f"not split into {n_data} x {n_seq} shards")
    ts, bs = T // n_seq, B // n_data
    rows = []
    for r in range(n_data):
        line = mesh.line(seq_axis, {data_axis: r} if data_axis else None)

        def shards(x):
            return [x[r * bs:(r + 1) * bs, :, j * ts:(j + 1) * ts]
                    .to(line[j].torch_device()).contiguous()
                    for j in range(n_seq)]
        outs = ring_attention(shards(q), shards(k), shards(v), line, causal)
        rows.append(torch.cat([o.to(q.device) for o in outs], dim=2))
    return torch.cat(rows, dim=0)
