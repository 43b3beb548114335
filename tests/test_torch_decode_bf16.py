"""LM decode serving in bfloat16 and float16 mixed precision:
``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU at a small size
(V=300 — above 256, so that a token id that passed through bfloat16
would show —, d_model 32, 2 layers, 4 heads, cache 32; a 1-layer draft
of the same width).

* the bfloat16 plain versions of the decode path's four kernels against
  the JAX package's Pallas kernels (interpret mode) on the same bfloat16
  inputs: the embedding gather exact, LayerNorm and bias+GeLU within one
  bfloat16 ulp (beyond the 2e-5 of their float32 parity tests), the
  flash-decode read within 2e-2;
* ``attention_decode`` in bfloat16 in both packages: cache writes bit
  for bit, the cursor exact, the output within 2e-2 (the JAX package's
  own bfloat16 tolerance);
* ``serve_decoder(compute_dtype="bfloat16")`` in both packages: logits
  teacher-forced on a fixed token chain within 2e-2, and greedy chains
  equal at every step where the JAX package's top-2 logit gap exceeds
  4e-2 (XLA keeps float32 between the bfloat16 ops it fuses, where the
  port rounds each op, so a nearer tie may flip);
* chunked prefill, speculative decoding and the prefix store under
  bfloat16 in the port; the fp8 cache under bfloat16 compute against the
  JAX package; a type with no mixed precision raises.

Every test runs in both 16-bit types; "bfloat16" above stands for
either. float16's ulp is eight times finer than bfloat16's (2^-10
against 2^-7 relative), and so are its limits: 2.5e-3 where bfloat16
takes 2e-2, a top-2 gap of 5e-3 where bfloat16 takes 4e-2.

The JAX side runs as its Pallas kernels in interpret mode
(``MXNET_KERNEL_TIER=pallas``) and, where noted, as its XLA composition.
Parameters come from a numpy seed and go to both packages unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import transformer as tfm
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu.serve import FakeClock as JaxFakeClock

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serve import FakeClock, SamplingParams

V, D, L, H, CAP = 300, 32, 2, 4, 32
BF16 = torch.bfloat16
TOL = 2e-2          # the JAX package's own bfloat16 decode tolerance
GAP = 4e-2          # a JAX top-2 logit gap below this may flip
CPU = mxt.cpu()
_names = iter(range(10 ** 6))
#: compute dtype -> (torch dtype, jax dtype, mantissa bits, tolerance,
#: top-2 gap): float16's kernel limits are bfloat16's over 8, its finer
#: ulp; its served logits are held to two float16 ulps of their largest
#: magnitude (``_logits_close``), and its gap is twice that at the
#: logits' magnitude here (4 to 8: ulp 2^-8)
HALF = {"bfloat16": (BF16, jnp.bfloat16, 7, TOL, GAP),
        "float16": (torch.float16, jnp.float16, 10, TOL / 8, 4 * 2 ** -8)}
HALVES = list(HALF)


def _logits_close(ref, got, dtype):
    """Served logits: bfloat16 within 2e-2 (atol and rtol); float16
    within two float16 ulps of the largest |logit| (XLA's float16 on the
    CPU rounds inside the step at other places than the port, which
    rounds each op: measured 1.6 ulps; bfloat16 logits agree exactly)."""
    if dtype == "bfloat16":
        np.testing.assert_allclose(ref, got, atol=TOL, rtol=TOL)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - HALF[dtype][2])
    assert np.abs(ref - got).max() <= 2 * ulp


def _t(a):
    return torch.tensor(np.asarray(a))


def _bf(a, dtype="bfloat16"):
    """A float32 numpy array as the same 16-bit ``dtype`` values in both
    packages (both round to nearest even)."""
    return jnp.asarray(a, HALF[dtype][1]), _t(a).to(HALF[dtype][0])


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _ulps(a, b, atol=2e-5, dtype="bfloat16"):
    """Largest |a - b|, less ``atol``, in ulps of ``dtype`` at the larger
    magnitude. ``atol`` is the float32 parity tolerance of these kernels
    (the two frameworks' erf and summation orders differ by float32
    ulps, which at a value near zero can move its bfloat16 rounding)."""
    a, b = _np(a), _np(b)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - HALF[dtype][2])
    return float(np.max(np.maximum(np.abs(a - b) - atol, 0.0) / ulp))


@pytest.fixture(autouse=True)
def pallas_tier(monkeypatch):
    """The JAX side runs its Pallas kernels (interpret mode)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", "pallas")
    kernel_tier.clear()
    yield
    kernel_tier.clear()


# =========================================== rows 1-4: the plain versions
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("scale", [1.0, float(np.sqrt(D))])
def test_embedding_bf16_plain_matches_pallas_exactly(scale, dtype):
    rs = np.random.RandomState(0)
    jw, tw = _bf(rs.randn(V, 64).astype(np.float32), dtype)
    ids = rs.randint(0, V, 19).astype(np.int32)
    ids[:3] = [V - 1, 256, 257]        # ids bfloat16 could not hold
    ref = pk.fused_embedding(jnp.asarray(ids), jw, scale)
    got = ck.embedding_plain(_t(ids), tw, scale)
    assert got.dtype == tw.dtype and ref.dtype == jw.dtype
    np.testing.assert_array_equal(_np(ref), _np(got))


@pytest.mark.parametrize("dtype", HALVES)
def test_embedding_bf16_plain_out_of_range_matches_composition(dtype):
    """jnp.take's fill in bfloat16: [-V, 0) counts from the end, the rest
    is NaN."""
    rs = np.random.RandomState(1)
    jw, tw = _bf(rs.randn(16, 8).astype(np.float32), dtype)
    ids = np.asarray([0, 15, 16, -1, -16, -17, 1000, 3], np.int32)
    op = jax_op("Embedding")
    (ref,), _ = op.forward(op.normalize_attrs({"input_dim": 16,
                                               "output_dim": 8}),
                           [jnp.asarray(ids), jw], [], False, None)
    got = ck.embedding_plain(_t(ids), tw, 1.0)
    np.testing.assert_array_equal(_np(ref), _np(got))   # NaN == NaN


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(8, 64), (5, 48), (16, 512)])
def test_layernorm_bf16_plain_within_one_ulp_of_pallas(shape, dtype):
    rs = np.random.RandomState(2)
    jx, tx = _bf((3 * rs.randn(*shape) + 1).astype(np.float32), dtype)
    jg, tg = _bf(rs.randn(shape[1]).astype(np.float32), dtype)
    jb, tb = _bf(rs.randn(shape[1]).astype(np.float32), dtype)
    y, mean, rstd = pk._pl_layernorm_fwd(jx, jg, jb, 1e-5)
    py, pmean, prstd = ck.layernorm_plain(tx, tg, tb, 1e-5)
    assert py.dtype == tx.dtype and y.dtype == jx.dtype
    assert pmean.dtype == prstd.dtype == torch.float32
    assert _ulps(y, py, dtype=dtype) <= 1.0
    np.testing.assert_allclose(np.asarray(mean)[:, 0], pmean.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(rstd)[:, 0], prstd.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(8, 128), (3, 40), (16, 2048)])
def test_bias_gelu_bf16_plain_within_one_ulp_of_pallas(shape, dtype):
    rs = np.random.RandomState(4)
    jx, tx = _bf((2 * rs.randn(*shape)).astype(np.float32), dtype)
    jb, tb = _bf(rs.randn(shape[1]).astype(np.float32), dtype)
    ref = pk.fused_bias_gelu(jx, jb)
    got = ck.bias_gelu_plain(tx, tb)
    assert got.dtype == tx.dtype and ref.dtype == jx.dtype
    assert _ulps(ref, got, dtype=dtype) <= 1.0


B4, H2, DH, C = 4, 2, 64, 256   # C=256 spans two 128-key Pallas blocks
_CURSORS = {1: {"per_slot": [0, C - 1, 127, 128], "scalar": [C - 1] * 4},
            4: {"per_slot": [0, C - 1, 126, 128], "scalar": [0] * 4}}


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("layout", ["per_slot", "scalar"])
@pytest.mark.parametrize("S", [1, 4])
def test_decode_read_bf16_plain_matches_pallas(S, layout, dtype):
    """bfloat16 q and caches; cursors at 0 and at the capacity's last
    position (a window there reads only the keys that exist), on both
    sides of the 128-key block boundary, or one cursor for every row."""
    rs = np.random.RandomState(5)
    jq, tq = _bf(rs.randn(B4, H2, S, DH).astype(np.float32), dtype)
    jk, tk = _bf(rs.randn(B4, H2, C, DH).astype(np.float32), dtype)
    jv, tv = _bf(rs.randn(B4, H2, C, DH).astype(np.float32), dtype)
    pos = np.asarray(_CURSORS[S][layout], np.int32)
    ref = pk.decode_attention(jq, jk, jv, jnp.asarray(pos))
    got = ck.decode_attention_plain(tq, tk, tv, _t(pos))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    tol = HALF[dtype][3]
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=tol,
                               rtol=tol)


# ============================================== attention_decode in bf16
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("per_slot,S", [(True, 1), (True, 4), (False, 1),
                                        (False, 4)])
def test_attention_decode_bf16_writes_bitwise_like_jax(per_slot, S, dtype):
    """The op in bfloat16, RoPE on: both packages write the same cache
    rows bit for bit and advance the cursor alike; the outputs (the
    port's plain forward and its card variant's CPU path) within 2e-2 of
    both JAX lowerings."""
    b, h, cap = 2, 2, 16
    rs = np.random.RandomState(6 + S)
    q, k, v = (rs.randn(b, h, S, DH).astype(np.float32) for _ in range(3))
    kc, vc = (rs.randn(b, h, cap, DH).astype(np.float32) for _ in range(2))
    cur = np.asarray([[1], [9]] if per_slot else [5], np.int32)
    attrs = {"capacity": cap, "per_slot": per_slot, "rope": True}
    jop, top = jax_op("attention_decode"), mxt.ops.get_op("attention_decode")
    jattrs, tattrs = jop.normalize_attrs(attrs), top.normalize_attrs(attrs)
    tol = HALF[dtype][3]
    jin = [_bf(a, dtype)[0] for a in (q, k, v)]
    jaux = [_bf(kc, dtype)[0], _bf(vc, dtype)[0], jnp.asarray(cur)]
    refs = [jop.forward(jattrs, jin, jaux, False, None),
            jop.variants["pallas"]["fn"](jattrs, jin, jaux, False, None)]
    for fn in (top.forward, top.variants["cuda"]["fn"]):
        tin = [_bf(a, dtype)[1] for a in (q, k, v)]
        taux = [_bf(kc, dtype)[1], _bf(vc, dtype)[1], _t(cur)]
        (out,), new_aux = fn(tattrs, tin, taux, False, None)
        assert out.dtype == HALF[dtype][0]
        for (ref_out,), ref_aux in refs:
            np.testing.assert_allclose(_np(ref_out), _np(out), atol=tol,
                                       rtol=tol)
            for r, p in zip(ref_aux[:2], new_aux[:2]):
                assert p.dtype == HALF[dtype][0]
                np.testing.assert_array_equal(_np(r), _np(p))
            np.testing.assert_array_equal(np.asarray(ref_aux[2]),
                                          new_aux[2].numpy())


# ===================================================== the whole slice
def _params(n_layer, seed, pos_embed="rotary"):
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=n_layer,
                                 n_head=H, capacity=CAP, per_slot=True,
                                 pos_embed=pos_embed)
    shapes, _, _ = sym.infer_shape(
        data=(1, 1), **({"pos_ids": (1, 1)} if pos_embed == "learned"
                        else {}))
    rs = np.random.RandomState(seed)
    return {n: ((1.0 if n.endswith("gamma") else 0.0)
                + (0.3 if n.endswith("weight") else 0.1) * rs.randn(*s))
            .astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "pos_ids")}


@pytest.fixture(scope="module")
def target():
    return _params(L, 0)


@pytest.fixture(scope="module")
def draft():
    """A different, smaller model: 1 layer of the same width."""
    return _params(1, 1)


class _Side:
    """One package's serving surface, so that a scenario runs unchanged
    on both."""

    def __init__(self, jax):
        self.jax = jax
        self.pkg = mx if jax else mxt
        self.tfm = tfm if jax else ttfm
        self.ctx = mx.cpu() if jax else CPU

    def args(self, params):
        if self.jax:
            return {k: mx.nd.array(v) for k, v in params.items()}
        return mxt.convert.params_from_numpy(params, CPU)

    def gen(self, n_layer=L, **kw):
        return lambda s: self.tfm.get_decode_symbol(
            vocab_size=V, d_model=D, n_layer=n_layer, n_head=H,
            capacity=CAP, per_slot=True, step_len=s, **kw)

    def serve(self, target, chunk=1, draft=None, spec_k=None, prefix_mb=0,
              ladder=(1, 2, 4), compute_dtype="bfloat16", **kw):
        gen = self.gen(**kw)
        return self.pkg.serve.serve_decoder(
            gen(1), self.args(target), name=f"bf16_{next(_names)}",
            capacity=CAP, ladder=list(ladder),
            clock=JaxFakeClock() if self.jax else FakeClock(), start=False,
            context=self.ctx, compute_dtype=compute_dtype,
            symbol_gen=gen if (chunk > 1 or draft is not None) else None,
            prefill_chunk=chunk,
            draft_symbol_gen=self.gen(1, **kw) if draft is not None
            else None,
            draft_params=self.args(draft) if draft is not None else None,
            spec_k=spec_k, prefix_cache_mb=prefix_mb)


JAX, PORT = _Side(True), _Side(False)


def _chain(seed, n):
    rs = np.random.RandomState(seed)
    return rs.randint(0, V, (n, 2)).astype(np.int32)


def _teacher_forced(sched, chain, window=1):
    """The logits of the served rung-2 driver on ``chain`` (steps, 2),
    both slots joined at step 0, ``window`` tokens a dispatch."""
    drv = sched.engine.driver(2)
    drv.join(0)
    drv.join(1)
    out = []
    for i in range(0, len(chain), window):
        out.append(drv.step(chain[i:i + window].T).asnumpy())
    return np.concatenate(out, axis=1)          # (2, steps, V)


@pytest.mark.parametrize("dtype", HALVES)
def test_served_logits_teacher_forced_match_jax(target, dtype):
    """16 steps of a fixed token chain (ids up to V-1 > 256) through the
    served rung: the port's bfloat16 logits within 2e-2 of the JAX
    package's; the logits come back bfloat16, every parameter and cache
    cell stays float32 and holds bfloat16 values (the JAX package's
    cache cells hold the same values as bfloat16 cells)."""
    chain = _chain(11, 16)
    chain[0] = [V - 1, 257]
    j = JAX.serve(target, ladder=(2,), compute_dtype=dtype)
    t = PORT.serve(target, ladder=(2,), compute_dtype=dtype)
    ref, got = _teacher_forced(j, chain), _teacher_forced(t, chain)
    _logits_close(ref, got, dtype)
    drv = t.engine.driver(2)
    out = drv.step(np.zeros((2, 1), np.int32))
    assert out.astorch().dtype == HALF[dtype][0]
    exe = drv._mod._exec_group.executor
    for nm, cell in list(exe.arg_dict.items()) + list(exe.aux_dict.items()):
        x = cell.astorch()
        if nm.endswith("cache_pos"):
            assert x.dtype == torch.int32, nm
        elif nm == "data":
            assert x.dtype == torch.int32, nm
        else:
            assert x.dtype == torch.float32, nm
            if nm.endswith("_cache"):
                assert torch.equal(x, x.to(HALF[dtype][0]).float()), nm
    assert t.stats()["compiles_since_warmup"] == 0
    j_exe = j.engine.driver(2)._mod._exec_group.executor
    assert str(j_exe.aux_dict["lm_l0_attn_k_cache"].dtype) == dtype


@pytest.mark.parametrize("dtype", HALVES)
def test_cast_layer_per_dispatch(target, dtype):
    """After warmup the parameters' bfloat16 casts are kept: a bfloat16
    dispatch casts the 2L caches and writes them back, and drops the kept
    casts of the cache tensors it replaced (the op wrote those casts in
    place); float32 serving casts nothing."""
    from mxnet_tpu_torch import executor
    for cd, per in ((dtype, 2 * L), (None, 0)):
        sched = PORT.serve(target, ladder=(2,), compute_dtype=cd)
        drv = sched.engine.driver(2)
        drv.join(0)
        drv.join(1)
        cells = [c for n, c in
                 drv._mod._exec_group.executor.aux_dict.items()
                 if n.endswith("_cache")]
        executor.reset_cast_counts()
        for tok in _chain(14, 3):
            old = [c.astorch() for c in cells]
            drv.step(tok[:, None])
            assert not any(executor._CASTS.get(id(t), (None,))[0] is not
                           None and executor._CASTS[id(t)][0]() is t
                           for t in old)
        assert executor.cast_counts() == {"casts": 3 * per,
                                          "write_backs": 3 * per}


@pytest.mark.parametrize("dtype", HALVES)
def test_served_logits_learned_positions_match_jax(dtype):
    """Learned positions: ``pos_ids`` (float32 data) is cast to bfloat16
    where the graph reads it, in both packages — exact for positions
    below 256."""
    params = _params(L, 3, pos_embed="learned")
    j = JAX.serve(params, ladder=(2,), pos_embed="learned",
                  compute_dtype=dtype)
    t = PORT.serve(params, ladder=(2,), pos_embed="learned",
                   compute_dtype=dtype)
    chain = _chain(12, 12)
    _logits_close(_teacher_forced(j, chain), _teacher_forced(t, chain),
                  dtype)


def _greedy_run(sched, prompts, max_new=10):
    handles = []
    for i, p in enumerate(prompts):
        handles.append(sched.submit(p, max_new_tokens=max_new))
        sched.pump(max_iterations=1 + i % 2)
        sched._clock.advance(0.01)
    sched.pump()
    return [h.result(timeout=0).tolist() for h in handles]


def _prompts(seed, n, lo=2, hi=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, rs.randint(lo, hi)).tolist() for _ in range(n)]


def _jax_gaps(drv, prompt, chain):
    """The JAX package's top-2 logit gap at each step that produced a
    token of ``chain`` (teacher-forced on prompt + chain in slot 0 of the
    rung-1 driver ``drv``), and its argmax there."""
    drv.leave(0)
    drv.join(0)
    rows = []
    for tok in list(prompt) + list(chain[:-1]):
        rows.append(drv.step(np.asarray([[tok]], np.int32)).asnumpy()[0, 0])
    rows = np.asarray(rows[len(prompt) - 1:])
    top2 = np.sort(rows, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0], rows.argmax(1)


@pytest.mark.parametrize("dtype", HALVES)
def test_greedy_chains_match_jax_where_no_near_tie(target, dtype):
    """Five staggered requests through each package's bfloat16 server
    (the same FakeClock arrivals, ladder [1, 2, 4]): the port's greedy
    chain equals the JAX package's up to the first step whose JAX top-2
    gap is 4e-2 or less, and equal counts."""
    prompts = _prompts(21, 5)
    j = JAX.serve(target, compute_dtype=dtype)
    j_chains = _greedy_run(j, prompts)
    t_chains = _greedy_run(PORT.serve(target, compute_dtype=dtype), prompts)
    compared = 0
    for prompt, jc, tc in zip(prompts, j_chains, t_chains):
        gaps, argmax = _jax_gaps(j.engine.driver(1), prompt, jc)
        assert argmax.tolist() == jc     # the chain is the JAX greedy one
        near = np.nonzero(gaps <= HALF[dtype][4])[0]
        stop = int(near[0]) if near.size else len(jc)
        assert tc[:stop] == jc[:stop]
        compared += stop
    assert compared >= 25


# ============================================= fast paths under bfloat16
_PLAIN_CHAINS = {}


def _plain_chains(target, dtype):
    """Token-at-a-time greedy chains of five prompts, once per dtype."""
    if dtype not in _PLAIN_CHAINS:
        prompts = _prompts(31, 5, lo=4, hi=14)
        _PLAIN_CHAINS[dtype] = prompts, _greedy_run(
            PORT.serve(target, compute_dtype=dtype), prompts)
    return _PLAIN_CHAINS[dtype]


@pytest.mark.parametrize("dtype", HALVES)
def test_chunked_prefill_bf16_emits_token_at_a_time_chains(target, dtype):
    prompts, want = _plain_chains(target, dtype)
    sched = PORT.serve(target, chunk=4, compute_dtype=dtype)
    assert sched.prefill_chunk == 4
    assert _greedy_run(sched, prompts) == want
    assert sched.stats()["prefill_chunks"] > 0


@pytest.mark.parametrize("dtype", HALVES)
def test_speculative_bf16_emits_token_at_a_time_chains(target, draft,
                                                       dtype):
    prompts, want = _plain_chains(target, dtype)
    sched = PORT.serve(target, chunk=4, draft=draft, spec_k=3,
                       compute_dtype=dtype)
    assert _greedy_run(sched, prompts) == want
    assert sched.stats()["spec"]["proposed"] > 0


@pytest.mark.parametrize("dtype", HALVES)
def test_prefix_hit_restores_bf16_rows_exactly(target, dtype):
    """A cold prefill's rows (float32 cells holding bfloat16 values) go
    into the store; a second submit joins with them written back bit for
    bit and decodes the cold output, which a server without the store
    gives too."""
    sched = PORT.serve(target, chunk=4, ladder=(1,), prefix_mb=4,
                       compute_dtype=dtype)
    prompt = np.random.RandomState(8).randint(1, V, 11).tolist()
    cold = sched.submit(prompt, max_new_tokens=5, prefix_id="sys")
    sched.pump()
    store = sched.prefix_store
    warm = sched.submit(prompt, max_new_tokens=5, prefix_id="sys")
    sched.pump()
    assert store.hits == 1 and store.misses == 1
    assert warm.result(timeout=0).tolist() == cold.result(timeout=0).tolist()
    entry = store.lookup("sys", np.asarray(prompt + [0]))[1]
    restored = sched.engine.driver(1).capture_rows(0, len(prompt) - 1)
    fresh = PORT.serve(target, chunk=4, ladder=(1,), compute_dtype=dtype)
    h = fresh.submit(prompt, max_new_tokens=5)
    fresh.pump()
    assert h.result(timeout=0).tolist() == cold.result(timeout=0).tolist()
    ref = fresh.engine.driver(1).capture_rows(0, len(prompt))
    for nm, rows in entry.payloads["target"].items():
        assert rows.dtype == torch.float32
        assert torch.equal(rows, rows.to(HALF[dtype][0]).float()), nm
        assert torch.equal(rows, ref[nm]), nm
        assert torch.equal(restored[nm], rows[:, :len(prompt) - 1]), nm


@pytest.mark.parametrize("dtype", HALVES)
def test_sampled_bf16_serving_is_reproducible(target, dtype):
    """Sampling runs in numpy on float32 copies of the bfloat16 logits:
    a seeded temperature-sampled request gives the same tokens twice."""
    runs = []
    for _ in range(2):
        sched = PORT.serve(target, compute_dtype=dtype)
        h = sched.submit([5, 260, 7], max_new_tokens=8,
                         sampling=SamplingParams(temperature=0.9, top_k=50,
                                                 seed=4))
        sched.pump()
        runs.append(h.result(timeout=0).tolist())
    assert runs[0] == runs[1] and len(runs[0]) == 8


# ======================================================= fp8 under bf16
@pytest.mark.parametrize("dtype", HALVES)
def test_fp8_cache_under_bf16_matches_jax(target, dtype):
    """An fp8 cache cell under bfloat16 compute: read through a bfloat16
    cast and, as in the JAX package, written back as the bfloat16 cache
    (an fp8 cell cannot hold the bfloat16 rows); teacher-forced logits
    within 2e-2 of the JAX package's, which equal its bfloat16-cache
    logits."""
    chain = _chain(13, 12)
    j = JAX.serve(target, ladder=(2,), cache_dtype="fp8", compute_dtype=dtype)
    t = PORT.serve(target, ladder=(2,), cache_dtype="fp8", compute_dtype=dtype)
    ref, got = _teacher_forced(j, chain), _teacher_forced(t, chain)
    _logits_close(ref, got, dtype)
    np.testing.assert_array_equal(
        ref, _teacher_forced(JAX.serve(target, ladder=(2,),
                                       compute_dtype=dtype), chain))
    for side, sched in ((JAX, j), (PORT, t)):
        exe = sched.engine.driver(2)._mod._exec_group.executor
        cache = exe.aux_dict["lm_l0_attn_k_cache"]
        assert dtype in str(cache.dtype), side.jax


# ========================================================= what raises
def test_float16_raises_naming_the_later_slice(target):
    """float16 is no longer a later slice: every spelling parses to it and
    a float16 server answers float16 logits; a type with no mixed
    precision still raises, naming the two ported ones."""
    sched = PORT.serve(target, ladder=(1,), compute_dtype="float16")
    drv = sched.engine.driver(1)
    drv.join(0)
    out = drv.step(np.asarray([[5]], np.int32))
    assert out.astorch().dtype == torch.float16
    assert np.isfinite(out.asnumpy()).all()
    x = torch.zeros(2, 64, dtype=torch.float16)
    assert mxt.executor.parse_compute_dtype(x.dtype) is torch.float16
    with pytest.raises(MXNetError, match="bfloat16 or float16"):
        PORT.serve(target, compute_dtype="float64")
