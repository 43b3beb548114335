"""The fp8 KV cache: ``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU.

* ``rtc.fp8_cast`` gives XLA's bytes for float32 -> float8_e4m3fn and
  float8_e5m2, bit for bit: random values of every scale, random bit
  patterns, +-448, 463.9, 464, 465, 1000, -500, NaN, +-inf, subnormals
  (PyTorch's own cast saturates e4m3fn overflow at +-448 where XLA writes
  NaN, and writes another NaN code for e5m2);
* ``attention_decode`` over fp8 cells (handed across as bytes through
  ``ml_dtypes``) agrees with the JAX package's XLA composition and with
  its Pallas kernel in interpret mode within 2e-4, through the op's plain
  forward and through its CUDA variant (whose kernel is its plain version
  on CPU tensors); after the step the cells equal the JAX package's bit
  for bit (K/V rows with values past 448 included: NaN cells). A NaN cell
  in a row's live prefix makes that row NaN, as in the JAX package's XLA
  composition (its Pallas kernel drops the NaN score in some blocks);
* a 2-layer decoder with an fp8 cache (``cache_dtype="fp8"`` / ``"e5m2"``)
  gives the JAX package's logits within 1e-4 over 12 staggered steps: its
  K/V projections round alike here, so no cell differs (measured: 0 of
  12,288 cells, logits within 4e-6); a projection that rounded across an
  fp8 rounding boundary would move a cell by one code, a ~6 % (e4m3) or
  ~12 % (e5m2) step in that cell, and show first in the cell comparison;
* ``serve_decoder`` with chunked prefill over an fp8 cache gives the JAX
  package's greedy chains.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import transformer as tfm
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.serve import FakeClock as JaxFakeClock

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.rtc import fp8_cast
from mxnet_tpu_torch.serve import FakeClock

STORAGE = {"fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
           "e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2)}
JOP, TOP = jax_get_op("attention_decode"), get_op("attention_decode")
B, H, DH, C = 2, 2, 8, 32
V, D, L, NH, CAP = 64, 32, 2, 4, 32
TOL = 2e-4


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def _to_torch(arr):
    """A JAX/numpy array as a torch tensor of the same dtype and bytes."""
    a = np.asarray(arr)
    for np_dt, t_dt in STORAGE.values():
        if a.dtype == np_dt:
            return torch.from_numpy(a.view(np.uint8).copy()).view(t_dt)
    return torch.from_numpy(a.copy())


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# ====================================================================== cast
@pytest.mark.parametrize("cache_dtype", ["fp8", "e5m2"])
def test_fp8_cast_matches_xla_bitwise(cache_dtype):
    np_dt, t_dt = STORAGE[cache_dtype]
    rs = np.random.RandomState(0)
    scaled = [rs.randn(4000) * s for s in
              (1e-6, 1e-4, 1e-2, 1, 30, 200, 448, 1e3, 6e4, 1e6)]
    edge = [0.0, -0.0, 448.0, -448.0, 463.9, 464.0, -464.0, 465.0, 1000.0,
            -500.0, np.nan, -np.nan, np.inf, -np.inf, 2.0 ** -9,
            2.0 ** -10, -2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -16, 2.0 ** -17,
            1e-40, -1e-40, 57344.0, 61439.0, 61440.0, -61441.0, 65504.0]
    x = np.concatenate(scaled + [np.asarray(edge)]).astype(np.float32)
    bits = rs.randint(-2 ** 31, 2 ** 31 - 1, 20000).astype(np.int32)
    x = np.concatenate([x, bits.view(np.float32)])
    want = _bytes(jnp.asarray(x).astype(jnp.dtype(np_dt)))
    got = fp8_cast(torch.from_numpy(x), t_dt)
    assert got.dtype == t_dt
    np.testing.assert_array_equal(_bytes(got), want)
    # PyTorch's own cast is not XLA's past the finite range
    if cache_dtype == "fp8":
        assert not np.array_equal(_bytes(torch.from_numpy(x).to(t_dt)), want)


# =============================================================== the op read
def _state(S, per_slot, cache_dtype, seed, k_scale=1.0):
    """Random q/k/v and fp8 caches whose live prefix holds real rows; a
    ``k_scale`` past 448 / 3 gives overflowing K rows."""
    rs = np.random.RandomState(seed)
    np_dt = STORAGE[cache_dtype][0]
    q, k, v = (rs.randn(B, H, S, DH).astype(np.float32) for _ in range(3))
    k = k * np.float32(k_scale)
    kc, vc = (rs.randn(B, H, C, DH).astype(np_dt) for _ in range(2))
    cursors = [1, 9] if per_slot else 5
    cur = np.reshape(cursors, (B, 1)).astype(np.int32) if per_slot \
        else np.asarray([cursors], np.int32)
    return [q, k, v], [kc, vc, cur]


@pytest.mark.parametrize("cache_dtype", ["fp8", "e5m2"])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("k_scale", [1.0, 300.0])
def test_attention_decode_fp8_matches_jax(jax_tier, cache_dtype, per_slot,
                                          S, k_scale):
    inputs, aux = _state(S, per_slot, cache_dtype, seed=S, k_scale=k_scale)
    attrs = {"capacity": C, "per_slot": per_slot, "cache_dtype": cache_dtype,
             "rope": True}
    jattrs = JOP.normalize_attrs(attrs)
    fn = JOP.variants["pallas"]["fn"] if jax_tier == "pallas" \
        else JOP.forward
    jo, jaux = fn(jattrs, [jnp.asarray(a) for a in inputs],
                  [jnp.asarray(a) for a in aux], False, None)
    want = np.asarray(jo[0], np.float32)
    tattrs = TOP.normalize_attrs(attrs)
    for run in (TOP.forward, TOP.variants["cuda"]["fn"]):
        t_in = [_to_torch(a) for a in inputs]
        t_aux = [_to_torch(a) for a in aux]
        to, taux = run(tattrs, t_in, t_aux, False, None)
        got = to[0].numpy()
        assert got.dtype == np.float32
        if jax_tier == "pallas" and np.isnan(got).any():
            # the JAX package's Pallas kernel drops a NaN score from its
            # online softmax in some blocks; its XLA composition, and the
            # port, give the row NaN: the port is NaN wherever the kernel
            # is, and the rows both give agree
            assert (np.isnan(want) <= np.isnan(got)).all()
            live = ~np.isnan(got)
            np.testing.assert_allclose(got[live], want[live], atol=TOL,
                                       rtol=TOL)
        else:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        for t, j in zip(taux[:2], jaux[:2]):
            assert t.dtype == STORAGE[cache_dtype][1]
            np.testing.assert_array_equal(_bytes(t), _bytes(j))
        np.testing.assert_array_equal(taux[2].numpy(), np.asarray(jaux[2]))
    if k_scale > 1 and cache_dtype == "fp8":
        assert np.isnan(np.asarray(jaux[0], np.float32)).any()


def test_cuda_variant_reads_fp8_cells_as_the_plain_forward():
    """The CUDA variant's read of fp8 cells (its kernel's plain version on
    CPU tensors) against the op's plain forward, over a NaN cell in a live
    prefix too: the same values and the same NaN rows."""
    inputs, aux = _state(1, True, "fp8", seed=7)
    aux[0][1, 0, 3, 2] = np.float32(np.nan)        # live for slot 1
    attrs = TOP.normalize_attrs({"capacity": C, "per_slot": True,
                                 "cache_dtype": "fp8"})
    outs = []
    for run in (TOP.forward, TOP.variants["cuda"]["fn"]):
        o, _ = run(attrs, [_to_torch(a) for a in inputs],
                   [_to_torch(a) for a in aux], False, None)
        outs.append(o[0].numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=1e-6)
    assert np.isnan(outs[1][1, 0]).all() and not np.isnan(outs[1][0]).any()


# ============================================================ the whole model
def _params():
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                 n_head=NH, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(0)
    return {n: ((1.0 if n.endswith("gamma") else 0.0)
                + (0.3 if n.endswith("weight") else 0.1) * rs.randn(*s))
            .astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}


@pytest.mark.parametrize("cache_dtype", ["fp8", "e5m2"])
def test_batched_decoder_fp8_logits_and_cells_match_jax(jax_tier,
                                                        cache_dtype):
    params = _params()
    sides = []
    for pkg, lib, ctx, args in (
            (mx, tfm, mx.cpu(), {k: mx.nd.array(v)
                                 for k, v in params.items()}),
            (mxt, ttfm, mxt.cpu(),
             mxt.convert.params_from_numpy(params, mxt.cpu()))):
        m = pkg.mod.Module(lib.get_decode_symbol(
            vocab_size=V, d_model=D, n_layer=L, n_head=NH, capacity=CAP,
            per_slot=True, cache_dtype=cache_dtype), label_names=[],
            context=ctx)
        m.bind([("data", (3, 1))], None, for_training=False)
        m.init_params(initializer=None, arg_params=args, aux_params={},
                      allow_missing=True)
        sides.append((lib.BatchedKVCacheDecoder(m, CAP), m))
    rs = np.random.RandomState(1)
    for d, _ in sides:
        d.join(0)
        d.join(1)
    for step in range(12):
        if step == 4:
            for d, _ in sides:
                d.join(2)
        tok = rs.randint(0, V, (3, 1))
        a, b = (d.step(tok).asnumpy() for d, _ in sides)
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    jaux = sides[0][1]._exec_group.executor.aux_dict
    taux = sides[1][1]._exec_group.executor.aux_dict
    for nm, cell in taux.items():
        if nm.endswith(("k_cache", "v_cache")):
            assert cell.astorch().dtype == STORAGE[cache_dtype][1]
            np.testing.assert_array_equal(_bytes(cell.astorch()),
                                          _bytes(jaux[nm].asnumpy()))


def test_serve_decoder_fp8_chains_match_jax():
    params = _params()
    chains = []
    for pkg, lib, ctx, args, clock in (
            (mx, tfm, mx.cpu(), {k: mx.nd.array(v)
                                 for k, v in params.items()},
             JaxFakeClock()),
            (mxt, ttfm, mxt.cpu(),
             mxt.convert.params_from_numpy(params, mxt.cpu()), FakeClock())):
        def gen(s, lib=lib):
            return lib.get_decode_symbol(
                vocab_size=V, d_model=D, n_layer=L, n_head=NH, capacity=CAP,
                per_slot=True, step_len=s, cache_dtype="fp8")
        sched = pkg.serve.serve_decoder(
            gen(1), args, name="fp8-parity", ladder=[1, 2], clock=clock,
            start=False, context=ctx, symbol_gen=gen, prefill_chunk=4,
            prefix_cache_mb=0)
        rs = np.random.RandomState(2)
        hs = [sched.submit(rs.randint(1, V, 3 + i).tolist(),
                           max_new_tokens=6) for i in range(3)]
        sched.pump()
        chains.append([h.result(timeout=0).tolist() for h in hs])
    assert chains[0] == chains[1]
