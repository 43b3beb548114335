"""The LM-training kernels' plain versions against the JAX package.

The four CUDA kernels the transformer LM's training step adds — the
LayerNorm input gradient and parameter gradients, the bias + GeLU input
gradient and the flash-attention forward — each have a plain PyTorch
version in ``mxnet_tpu_torch.ops.cuda_kernels``, which is what a CPU
tensor runs. Each is held here against the JAX package's Pallas kernel
(interpret mode, as the JAX package's own tests run it off-TPU) and
against the JAX composition it replaces, on the same numpy-seeded inputs;
so is the embedding gradient, which is no kernel in either package. Then
each ``autograd.Function`` of the card's variants runs on the CPU, where
its kernels are their plain halves, and its gradients are held against
``jax.vjp`` of the Pallas path.

Tolerance: float32 2e-5, absolute and relative (the frameworks sum and
round in other orders).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu import rtc as jrtc
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu.parallel.ring_attention import attention as ring_attention

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import rtc as trtc
from mxnet_tpu_torch.ops import cuda_kernels as ck

TOL = 2e-5
EPS = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def _ln_inputs(n, c, seed=0):
    rs = np.random.RandomState(seed)
    return ((3 * rs.randn(n, c) + 1).astype(np.float32),
            (1 + 0.3 * rs.randn(c)).astype(np.float32),
            (0.3 * rs.randn(c)).astype(np.float32),
            rs.randn(n, c).astype(np.float32))


# -------------------------------------------------- LayerNorm backward
@pytest.mark.parametrize("n,c", [(16, 64), (5, 13), (1, 1), (3, 1000),
                                 (9, 512)])
def test_ln_bwd_plain_matches_pallas(n, c):
    x, g, b, ct = _ln_inputs(n, c)
    out, vjp = jax.vjp(lambda x_, g_, b_: pk._ln_pl_fn(x_, g_, b_, EPS),
                       jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    zeros = jnp.zeros((n, 1), jnp.float32)
    dx, dg, db = vjp((jnp.asarray(ct), zeros, zeros))
    _, mean, rstd = ck.layernorm_plain(_t(x), _t(g), _t(b), EPS)
    _close(out[1][:, 0], mean)
    _close(out[2][:, 0], rstd)
    _close(dx, ck.layernorm_bwd_dx_plain(_t(x), _t(g), _t(ct), mean, rstd))
    tdg, tdb = ck.layernorm_bwd_dparams_plain(_t(x), _t(ct), mean, rstd)
    _close(dg, tdg)
    _close(db, tdb)


@pytest.mark.parametrize("shape", [(2, 6, 32), (4, 7)])
def test_ln_bwd_plain_matches_composition(shape):
    """Against ``jax.vjp`` of the LayerNorm op's XLA composition, over a
    leading shape folded into rows as the op folds it."""
    c = shape[-1]
    n = int(np.prod(shape[:-1]))
    x, g, b, ct = _ln_inputs(n, c, seed=1)
    op = jax_op("LayerNorm")
    attrs = op.normalize_attrs({})

    def f(x_, g_, b_):
        outs, _ = op.forward(attrs, [x_, g_, b_], [], True, None)
        return outs[0]
    _, vjp = jax.vjp(f, jnp.asarray(x.reshape(shape)), jnp.asarray(g),
                     jnp.asarray(b))
    dx, dg, db = vjp(jnp.asarray(ct.reshape(shape)))
    _, mean, rstd = ck.layernorm_plain(_t(x), _t(g), _t(b), EPS)
    _close(np.asarray(dx).reshape(n, c),
           ck.layernorm_bwd_dx_plain(_t(x), _t(g), _t(ct), mean, rstd))
    tdg, tdb = ck.layernorm_bwd_dparams_plain(_t(x), _t(ct), mean, rstd)
    _close(dg, tdg)
    _close(db, tdb)


# ----------------------------------------------------- bias + GeLU backward
@pytest.mark.parametrize("n,c", [(8, 256), (3, 13), (1, 4)])
def test_bias_gelu_dx_plain_matches_pallas_and_composition(n, c):
    rs = np.random.RandomState(2)
    x = (3 * rs.randn(n, c)).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    ct = rs.randn(n, c).astype(np.float32)
    _, vjp = jax.vjp(pk._bias_gelu_fn, jnp.asarray(x), jnp.asarray(b))
    dx, db = vjp(jnp.asarray(ct))
    op = jax_op("FusedBiasGeLU")
    _, cvjp = jax.vjp(lambda x_, b_: op.forward({}, [x_, b_], [], True,
                                                None)[0][0],
                      jnp.asarray(x), jnp.asarray(b))
    cdx, cdb = cvjp(jnp.asarray(ct))
    got = ck.bias_gelu_dx_plain(_t(x), _t(b), _t(ct))
    for ref_dx, ref_db in ((dx, db), (cdx, cdb)):
        _close(ref_dx, got)
        _close(ref_db, got.sum(0), 1e-4)     # a sum over n rows


# ------------------------------------------------------ flash attention
_FLASH_SHAPES = [((2, 3, 32, 16), 128), ((1, 2, 40, 64), 8),
                 ((1, 1, 1, 8), 128), ((2, 2, 64, 128), 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", _FLASH_SHAPES)
def test_flash_attention_plain_matches_pallas(shape, block, causal):
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    ref = jrtc.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=block,
                               block_k=block)
    got = ck.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    _close(ref, got)
    B, H, T, D = shape
    bq = min(block, T)
    flat = jrtc._flash_call(*(jnp.asarray(a.reshape(B * H, T, D))
                              for a in (q, k, v)), 0, 0, causal,
                            1.0 / float(np.sqrt(D)), bq, bq)
    _close(np.asarray(flat).reshape(shape), got)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_compositions(causal):
    """The kernel's function (q scaled first) against the compositions
    that scale the scores: the JAX package's ``ring_attention.attention``
    and the port's ``attention`` op."""
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 4, 48, 32).astype(np.float32) for _ in range(3))
    got = ck.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    _close(ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal), got)
    _close(trtc._attention_plain({"causal": causal}, _t(q), _t(k), _t(v)),
           got)


# --------------------------------------------------- embedding gradient
@pytest.mark.parametrize("scale", [1.0, float(np.sqrt(64))])
def test_embedding_bwd_plain_matches_pallas_rule(scale):
    """In-range ids through ``jax.vjp`` of the Pallas embedding; ids in
    [-V, 0) (counted from the end), below -V and at or past V (dropped)
    through the Pallas backward rule itself and the composition's vjp."""
    V, D = 11, 64
    rs = np.random.RandomState(5)
    w = rs.randn(V, D).astype(np.float32)
    ids = np.asarray([0, 3, 3, 10, 7, 3], np.int32)
    ct = rs.randn(len(ids), D).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: pk._emb_fn(jnp.asarray(ids), w_, scale),
                     jnp.asarray(w))
    dw, = vjp(jnp.asarray(ct))
    _close(dw, ck.embedding_bwd_plain(_t(ids), _t(ct), V, scale))

    bad = np.asarray([-1, V, -V, -V - 1, 2, V + 5, -3, 2], np.int32)
    ct = rs.randn(len(bad), D).astype(np.float32)
    _, rule = pk._emb_bwd_rule(scale, (jnp.asarray(bad), jnp.asarray(w)),
                               jnp.asarray(ct))
    got = ck.embedding_bwd_plain(_t(bad), _t(ct), V, scale)
    _close(rule, got)
    op = jax_op("Embedding")
    attrs = op.normalize_attrs({"input_dim": V, "output_dim": D,
                                "scale": scale})
    _, cvjp = jax.vjp(lambda w_: op.forward(attrs, [jnp.asarray(bad), w_],
                                            [], True, None)[0][0],
                      jnp.asarray(w))
    _close(cvjp(jnp.asarray(ct))[0], got)


# ------------------------------------- autograd.Functions on the CPU
def _grads(fn, *arrays, ct):
    ts = [_t(a).requires_grad_(a.dtype == np.float32) for a in arrays]
    out = fn(*ts)
    out.backward(_t(ct))
    return out.detach().numpy(), [t.grad for t in ts]


def test_layernorm_fn_on_cpu_matches_jax_vjp():
    x, g, b, ct = _ln_inputs(12, 48, seed=6)
    out, grads = _grads(lambda *a: ck.layernorm_fn(*a, EPS)[0], x, g, b,
                        ct=ct)
    (y, _m, _r), vjp = jax.vjp(lambda *a: pk._ln_pl_fn(*a, EPS),
                               *(jnp.asarray(a) for a in (x, g, b)))
    zeros = jnp.zeros((12, 1), jnp.float32)
    _close(y, out)
    for ref, got in zip(vjp((jnp.asarray(ct), zeros, zeros)), grads):
        _close(ref, got)


def test_bias_gelu_fn_on_cpu_matches_jax_vjp():
    rs = np.random.RandomState(7)
    x, ct = (rs.randn(10, 40).astype(np.float32) for _ in range(2))
    b = rs.randn(40).astype(np.float32)
    out, grads = _grads(ck.bias_gelu_fn, x, b, ct=ct)
    y, vjp = jax.vjp(pk._bias_gelu_fn, jnp.asarray(x), jnp.asarray(b))
    _close(y, out)
    for ref, got in zip(vjp(jnp.asarray(ct)), grads):
        _close(ref, got, 1e-4)


def test_embedding_fn_on_cpu_matches_jax_vjp():
    rs = np.random.RandomState(8)
    w = rs.randn(17, 32).astype(np.float32)
    ids = rs.randint(0, 17, 24).astype(np.int32)
    ct = rs.randn(24, 32).astype(np.float32)
    out, (dids, dw) = _grads(lambda i, w_: ck.embedding_fn(i, w_, 4.0), ids,
                             w, ct=ct)
    y, vjp = jax.vjp(lambda w_: pk._emb_fn(jnp.asarray(ids), w_, 4.0),
                     jnp.asarray(w))
    _close(y, out)
    _close(vjp(jnp.asarray(ct))[0], dw)
    assert dids is None                      # the ids get no gradient


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_on_cpu_matches_jax_vjp(causal):
    rs = np.random.RandomState(9)
    q, k, v, ct = (rs.randn(2, 2, 32, 16).astype(np.float32)
                   for _ in range(4))
    out, grads = _grads(lambda *a: trtc.flash_attention_fn(*a, causal),
                        q, k, v, ct=ct)
    y, vjp = jax.vjp(lambda *a: jrtc.flash_attention(*a, causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    _close(y, out)
    for ref, got in zip(vjp(jnp.asarray(ct)), grads):
        _close(ref, got)


# ---------------------------------- the ops' CUDA variants, on the CPU
_VARIANT_CASES = {
    "LayerNorm": (lambda rs: [(2 * rs.randn(3, 5, 24)).astype(np.float32),
                              (1 + rs.randn(24)).astype(np.float32),
                              rs.randn(24).astype(np.float32)], {}),
    "FusedBiasGeLU": (lambda rs: [rs.randn(6, 32).astype(np.float32),
                                  rs.randn(32).astype(np.float32)], {}),
    "Embedding": (lambda rs: [rs.randint(-3, 12, (2, 5)).astype(np.int32),
                              rs.randn(9, 16).astype(np.float32)],
                  {"input_dim": 9, "output_dim": 16, "scale": 4.0}),
    "attention": (lambda rs: [rs.randn(2, 3, 20, 8).astype(np.float32)
                              for _ in range(3)], {"causal": True}),
    "pallas_flash_attention": (
        lambda rs: [rs.randn(1, 2, 12, 8).astype(np.float32)
                    for _ in range(3)], {"causal": False}),
}


@pytest.mark.parametrize("name", sorted(_VARIANT_CASES))
def test_cuda_variant_on_cpu_tensors_matches_plain_op(name):
    """Each differentiable CUDA variant, handed CPU tensors (its kernels
    are then their plain halves), gives the plain op's output and
    gradients — the autograd plumbing the card runs, checked here."""
    rs = np.random.RandomState(10)
    make, kwargs = _VARIANT_CASES[name]
    arrays = make(rs)
    op = mxt.ops.get_op(name)
    attrs = op.normalize_attrs(kwargs)
    results = []
    for fn in (op.variants["cuda"]["fn"], op.forward):
        ins = [_t(a).requires_grad_(a.dtype == np.float32) for a in arrays]
        out = fn(attrs, ins, [], True, None)[0][0]
        ct = torch.tensor(np.random.RandomState(11).randn(*out.shape)
                          .astype(np.float32))
        finite = torch.isfinite(out)
        torch.where(finite, out, 0.0).backward(ct)
        results.append((out.detach(), [t.grad for t in ins]))
    (vout, vgrads), (pout, pgrads) = results
    np.testing.assert_allclose(vout.numpy(), pout.numpy(), atol=TOL,
                               rtol=TOL)
    for a, b in zip(vgrads, pgrads):
        if b is None:
            assert a is None
        else:
            _close(b, a, 1e-4)


def test_lm_wrappers_on_cpu_count_nothing():
    ck.reset_launch_counts()
    x, g, b, ct = (_t(a) for a in _ln_inputs(4, 8))
    _, mean, rstd = ck.layernorm(x, g, b, EPS)
    ck.layernorm_bwd_dx(x, g, ct, mean, rstd)
    ck.layernorm_bwd_dparams(x, ct, mean, rstd)
    ck.bias_gelu_dx(x, b, ct)
    q = torch.randn(1, 1, 4, 64)
    ck.flash_attention(q, q, q, True)
    assert ck.launch_counts() == {n: 0 for n in ck.KERNELS}
    assert len(ck.KERNELS) == 16

