"""Transformer-LM training in bfloat16 and float16 mixed precision
(``Module(compute_dtype="bfloat16").fit``, ``"float16"`` alike):
``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU at small sizes.
Every test runs in both 16-bit types; "bfloat16" below stands for
either, and a limit in ulps is in ulps of the type (2^-7 relative for
bfloat16, 2^-10 for float16).

Under the JAX package's mixed precision the LM's Pallas kernels run on
bfloat16 operands: each reads bfloat16, computes in float32 and stores
bfloat16 (the LayerNorm statistics float32, the parameter gradients
summed in float32 and cast to gamma's dtype). Held here:

* the bfloat16 plain versions of the four LM-training kernels against the
  JAX package's Pallas kernels in interpret mode on the same bfloat16
  inputs: the LayerNorm input and parameter gradients
  (``pk._ln_pl_fn``'s vjp), the bias + GeLU input gradient and the bias
  gradient (``pk._bias_gelu_fn``'s vjp), flash attention's forward and
  vjp (``jrtc.flash_attention``) at head dims 64 and 128, causal and not;
  the card's ``autograd.Function``s on CPU tensors (where their kernels
  are these plain versions) give the same gradients, all bfloat16;
* a three-batch SGD fit of the LM at V = 512 (token ids and labels above
  256, which bfloat16 would round) against the JAX package's bfloat16
  fit with its XLA and its Pallas tier, from the same numpy start;
* the cells: master weights, gradients and the optimizer states float32;
  int32 ids and float32 labels reach the graph exact; one cast per
  parameter per step (the tied embedding table once).

Tolerances, each with its reason. LayerNorm and GeLU gradients: one
bfloat16 ulp of each value beyond 2e-5 (float32 arithmetic in another
order, or another libm's erf / exp, can move a value across a rounding
boundary; the floor covers GeLU' where it is ~1e-8). Attention and the
parameter sums: one bfloat16 ulp of the array's largest magnitude
(outputs and gradients are sums of terms of both signs, so a value far
below the largest can carry a rounding of the terms). At head dim 128 the
gradients are held to two: the JAX recompute takes ``1/sqrt(Dh)`` in
bfloat16 (0.08837890625 against the port's and the forward kernel's
float32 0.0883883; at 64 both are 0.125 exactly), which moves its
gradients by up to one such ulp (measured: up to 1.0 at Dh 128, under
0.07 at Dh 16 and 64). The fits: every parameter within 3 times the JAX
package's own bfloat16-vs-float32 distance plus 1e-6, as
``test_torch_bf16.py`` holds the ResNet (measured: the port within 1.5
times it, the JAX package's two tiers within 1.8 times of each other).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu import rtc as jrtc
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import rtc as trtc
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.ops import cuda_kernels as ck

BF16 = torch.bfloat16
CPU = mxt.cpu()
#: compute dtype -> (torch dtype, jax dtype, mantissa bits, smallest
#: normal exponent)
HALF = {"bfloat16": (BF16, jnp.bfloat16, 7, -126),
        "float16": (torch.float16, jnp.float16, 10, -14)}
HALVES = list(HALF)
EPS = 1e-5
ATOL = 2e-5                 # the elementwise floor (see above)
V, D, L, H, T, B, N = 512, 64, 2, 4, 32, 8, 3
SGD = (("learning_rate", 0.05),)
SPREAD = 3.0


def _bf16(a, dtype="bfloat16"):
    """numpy -> (torch, jax) arrays of the 16-bit ``dtype``, both rounded
    to nearest even from the same float32 values."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(HALF[dtype][0]), \
        jnp.asarray(a).astype(HALF[dtype][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _is_bf16(*xs, dtype="bfloat16"):
    return all((x.dtype == HALF[dtype][0]) if isinstance(x, torch.Tensor)
               else (x.dtype == HALF[dtype][1]) for x in xs)


def _ulp(mag, dtype="bfloat16"):
    """The ulp of ``dtype`` at magnitude ``mag`` (at least the smallest
    normal's)."""
    bits, emin = HALF[dtype][2:]
    return 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** emin))) - bits)


def _ulps(got, want, atol=ATOL, dtype="bfloat16"):
    """Largest |got - want| less ``atol``, in ulps of ``dtype`` at each
    value's magnitude."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    over = np.maximum(np.abs(g - w) - atol, 0.0)
    return float((over / _ulp(np.maximum(np.abs(g), np.abs(w)),
                              dtype)).max())


def _ulps_of_max(got, want, dtype="bfloat16"):
    """Largest |got - want| in ulps of ``dtype`` at want's largest
    magnitude."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(g - w).max() / _ulp(np.abs(w).max(), dtype))


# --------------------------------------------------- LayerNorm backward
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("n,c", [(16, 64), (5, 13), (1, 1), (3, 1000),
                                 (64, 512)])
def test_ln_bwd_plain_bf16_matches_pallas(n, c, dtype):
    rs = np.random.RandomState(0)
    (tx, jx), (tg, jg), (tb, jb), (tct, jct) = (
        _bf16(3 * rs.randn(n, c) + 1, dtype),
        _bf16(1 + 0.3 * rs.randn(c), dtype),
        _bf16(0.3 * rs.randn(c), dtype), _bf16(rs.randn(n, c), dtype))
    _, vjp = jax.vjp(lambda x_, g_, b_: pk._ln_pl_fn(x_, g_, b_, EPS),
                     jx, jg, jb)
    zeros = jnp.zeros((n, 1), jnp.float32)
    dx, dg, db = vjp((jct, zeros, zeros))
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    tdx = ck.layernorm_bwd_dx_plain(tx, tg, tct, mean, rstd)
    tdg, tdb = ck.layernorm_bwd_dparams_plain(tx, tct, mean, rstd)
    assert _is_bf16(dx, dg, db, tdx, tdg, tdb, dtype=dtype)
    assert mean.dtype == rstd.dtype == torch.float32
    assert _ulps(tdx, dx, dtype=dtype) <= 1
    assert _ulps_of_max(tdg, dg, dtype) <= 1
    assert _ulps_of_max(tdb, db, dtype) <= 1
    # the card's autograd.Function on CPU tensors: the same gradients
    leaves = [t.clone().requires_grad_(True) for t in (tx, tg, tb)]
    ck.layernorm_fn(*leaves, EPS)[0].backward(tct)
    for leaf, want in zip(leaves, (tdx, tdg, tdb)):
        assert leaf.grad.dtype == HALF[dtype][0]
        assert torch.equal(leaf.grad, want)


# ---------------------------------------------------- bias + GeLU backward
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("n,c", [(8, 256), (3, 13), (1, 4), (64, 2048)])
def test_bias_gelu_bwd_plain_bf16_matches_pallas(n, c, dtype):
    rs = np.random.RandomState(2)
    (tx, jx), (tb, jb), (tct, jct) = (_bf16(3 * rs.randn(n, c), dtype),
                                      _bf16(rs.randn(c), dtype),
                                      _bf16(rs.randn(n, c), dtype))
    _, vjp = jax.vjp(pk._bias_gelu_fn, jx, jb)
    dx, db = vjp(jct)
    tdx = ck.bias_gelu_dx_plain(tx, tb, tct)
    assert _is_bf16(dx, db, tdx, dtype=dtype)
    assert _ulps(tdx, dx, dtype=dtype) <= 1
    x, b = (t.clone().requires_grad_(True) for t in (tx, tb))
    ck.bias_gelu_fn(x, b).backward(tct)
    assert _is_bf16(x.grad, b.grad, dtype=dtype)
    assert torch.equal(x.grad, tdx)
    # the bias gradient: the float32 column sum of dx, rounded once
    assert torch.equal(b.grad, tdx.float().sum(0).to(HALF[dtype][0]))
    assert _ulps_of_max(b.grad, db, dtype) <= 1


# ------------------------------------------------------- flash attention
_FLASH = [((2, 3, 32, 16), 128), ((1, 2, 40, 64), 8), ((2, 2, 64, 128), 16)]


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", _FLASH)
def test_flash_attention_plain_bf16_matches_pallas(shape, block, causal,
                                                   dtype):
    """Forward: the plain version, and the card's Function on CPU
    tensors, against the Pallas kernel. Backward: the Function's
    recompute against ``jax.vjp`` of the Pallas path (its XLA
    recompute)."""
    rs = np.random.RandomState(3)
    (tq, jq), (tk, jk), (tv, jv), (tct, jct) = (
        _bf16(rs.randn(*shape), dtype) for _ in range(4))
    y, vjp = jax.vjp(lambda q_, k_, v_: jrtc.flash_attention(
        q_, k_, v_, causal=causal, block_q=block, block_k=block),
        jq, jk, jv)
    got = ck.flash_attention_plain(tq, tk, tv, causal)
    assert _is_bf16(y, got, dtype=dtype)
    assert _ulps_of_max(got, y, dtype) <= 1
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = trtc.flash_attention_fn(*leaves, causal)
    assert torch.equal(out, got)
    out.backward(tct)
    tol = 2 if shape[-1] == 128 else 1        # the 16-bit JAX scale
    for leaf, want in zip(leaves, vjp(jct)):
        assert _is_bf16(leaf.grad, want, dtype=dtype)
        assert _ulps_of_max(leaf.grad, want, dtype) <= tol


def test_bf16_wrappers_on_cpu_run_plain_and_count_nothing():
    ck.reset_launch_counts()
    rs = np.random.RandomState(4)
    x, g, ct = (_bf16(a)[0] for a in (rs.randn(4, 8), rs.randn(8),
                                      rs.randn(4, 8)))
    _, mean, rstd = ck.layernorm(x, g, g, EPS)
    outs = [ck.layernorm_bwd_dx(x, g, ct, mean, rstd),
            ck.layernorm_bwd_dx_bf16(x, g, ct, mean, rstd),
            *ck.layernorm_bwd_dparams(x, ct, mean, rstd),
            *ck.layernorm_bwd_dparams_bf16(x, ct, mean, rstd),
            ck.bias_gelu_dx(x, g, ct), ck.bias_gelu_dx_bf16(x, g, ct)]
    q = _bf16(rs.randn(1, 2, 4, 64))[0]
    outs += [ck.flash_attention(q, q, q, True),
             ck.flash_attention_bf16(q, q, q, True)]
    assert _is_bf16(*outs)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[-2], outs[-1])
    assert ck.launch_counts() == {n: 0 for n in ck.COUNTERS}
    for name in ("layernorm_bwd_dx_bf16", "layernorm_bwd_dparams_bf16",
                 "bias_gelu_dx_bf16", "flash_attention_bf16"):
        assert name in ck.COUNTERS
        assert ck.source(name).endswith(".cu")


# ----------------------------------------------------- the slice as a whole
@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def _jax_fit(cd, start=None):
    """The JAX package's fit of N batches; Xavier-initialized when
    ``start`` is None. Returns (start, {name: float32 weight})."""
    it = jtfm.SyntheticLMIter(V, B, T, N, seed=0)
    mod = mx.mod.Module(jtfm.get_symbol(V, D, L, H, T), context=mx.cpu(),
                        compute_dtype=cd)
    mod.bind(it.provide_data, it.provide_label)
    if start is None:
        mod.init_params(mx.initializer.Xavier())
        start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in start.items()})
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD)
    got = mod.get_params()[0]
    assert {str(v.dtype) for v in got.values()} == {"float32"}
    return start, {k: np.asarray(v.asnumpy(), np.float32)
                   for k, v in got.items()}


@functools.lru_cache(maxsize=None)
def _jax_fit32():
    """The start and the JAX package's float32 fit, once (its XLA and
    Pallas tiers agree within 1e-8 in float32)."""
    return _jax_fit(None)


@pytest.mark.parametrize("dtype", HALVES)
def test_lm_bf16_fit_matches_jax(jax_tier, dtype):
    start, j32 = _jax_fit32()
    _, jbf = _jax_fit(HALF[dtype][1], start)
    mod = mxt.mod.Module(ttfm.get_symbol(V, D, L, H, T), context=CPU,
                         compute_dtype=dtype)
    mod.fit(ttfm.SyntheticLMIter(V, B, T, N, seed=0), num_epoch=1,
            optimizer="sgd", optimizer_params=SGD,
            arg_params=mxt.convert.params_from_numpy(start, CPU))
    got = mod.get_params()[0]
    assert sorted(got) == sorted(jbf)
    for k, want in jbf.items():
        assert got[k].astorch().dtype == torch.float32, k
        spread = float(np.abs(want - j32[k]).max())
        moved = got[k].asnumpy() - start[k]
        assert np.abs(moved).max() > 1e-5, k           # every one trained
        np.testing.assert_allclose(got[k].asnumpy(), want,
                                   atol=SPREAD * spread + 1e-6, rtol=0,
                                   err_msg=k)


def _spy(monkeypatch, name, seen):
    """Record the inputs the plain forward of op ``name`` receives."""
    op = mxt.ops.get_op(name)
    forward = op.forward

    def spy(attrs, inputs, aux, is_train, rng):
        seen.append([t.detach().clone() for t in inputs])
        return forward(attrs, inputs, aux, is_train, rng)
    monkeypatch.setattr(op, "forward", spy)


@pytest.mark.parametrize("dtype", HALVES)
def test_lm_bf16_cells_ids_labels_and_casts(monkeypatch, dtype):
    """One bfloat16 step with momentum: master weights, gradients and the
    momentum float32; the int32 ids and float32 labels (above 256, odd
    ones included, which bfloat16 would round to even) reach the
    Embedding and the loss head exact; one cast per parameter, the tied
    embedding table's included once; the outputs bfloat16."""
    it = ttfm.SyntheticLMIter(V, B, T, 1, seed=1)
    batch = next(iter(it))
    data, label = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    assert data.dtype == np.int32 and label.dtype == np.float32
    assert (data > 256).any() and (label > 256).any()
    assert ((data > 256) & (data % 2 == 1)).any()
    mod = mxt.mod.Module(ttfm.get_symbol(V, D, L, H, T), context=CPU,
                         compute_dtype=dtype)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    ids, heads = [], []
    _spy(monkeypatch, "Embedding", ids)
    _spy(monkeypatch, "SoftmaxOutput", heads)
    mxt.executor.reset_cast_counts()
    mod.forward_backward(batch)
    casts = mxt.executor.cast_counts()["casts"]
    mod.update()
    exe = mod._exec_group.executor
    params = [n for n in exe.arg_dict if n not in ("data", "softmax_label")]
    assert "lm_tok_embed_weight" in params
    assert casts == len(params)
    assert len(ids) == 1 and len(heads) == 1
    (tok, table), (logits, lab) = ids[0], heads[0]
    half = HALF[dtype][0]
    assert tok.dtype == torch.int32 and table.dtype == half
    np.testing.assert_array_equal(tok.numpy(), data)
    assert logits.dtype == half and lab.dtype == torch.float32
    np.testing.assert_array_equal(lab.numpy(), label)
    assert exe.outputs[0].astorch().dtype == half
    for cells in (mod.get_params()[0], exe.grad_dict):
        assert {v.astorch().dtype for v in cells.values()} == \
            {torch.float32}
    states = [s for s in mod._updater.states.values() if s is not None]
    assert len(states) == len(params)
    assert {s.astorch().dtype for s in states} == {torch.float32}
