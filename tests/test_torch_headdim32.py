"""Attention at the head dims between the kernels' tiles (16, 32, 48, 80,
96 and 112; every test is one case a Dh): ``mxnet_tpu_torch`` against
``mxnet_tpu`` on the CPU.

The card's three attention kernels take every head dim that is a multiple
of 16 up to 128, each on the smallest of the Dh 32, 64 and 128 tiles that
holds it (``cuda_kernels.head_tile``): the decode read
(``csrc/decode_attention.cu``, the copies past Dh zero-filled), the
float32 flash forward and its partial mode (``cc::Tile<32 | 64 | 128>``)
and their 16-bit instances (the Dh 64 tiles at Dh <= 64, Dh 128's above,
on TMA maps whose inner dimension is the real Dh: the columns past Dh
arrive as zeros, which leave the scores unchanged and give P . V zero
columns that are not stored). 1/sqrt(Dh) is the real Dh's. The kernels
run only on a card; here, on the same numpy-seeded values, within the
limits their own tests use:

* the decode read's order of work (``tests/decode_split_emul.py``, the
  wrapper's split plan) and its plain version against the JAX package's
  Pallas kernel in interpret mode, for every cache type (float32,
  bfloat16, float16, float8_e4m3fn, float8_e5m2), S = 1 and windows:
  2e-5 (every cell widened exactly; float32 sums in other orders);
* the float32 flash forward's order (``tests/flash_f32_emul.py``, on the
  tile the kernel takes) in both modes against ``rtc.flash_attention`` /
  ``flash_attention_partial`` (Pallas, interpret) and the plain versions:
  2e-5;
* the 16-bit flash forward's arithmetic (``tc_flash`` of
  ``tests/test_torch_flash_tc.py``) on the zero-padded tiles, cut back to
  Dh columns, against the plain versions and the Pallas kernel: one
  16-bit ulp beyond 2e-5 (normalized), 2e-5 of each array's largest
  magnitude (partial);
* a small transformer (2 heads of Dh, 2 layers) through
  ``serve_decoder``: the JAX package's greedy token chains, the JAX side
  lowered as its XLA composition and as its Pallas kernels; and one
  ``Module`` training step's gradients within 2e-5 of the JAX package's.
"""
import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu import rtc as jrtc
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.serve import FakeClock as JaxFakeClock

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serve import FakeClock

from decode_split_emul import decode_attention_split
from flash_f32_emul import TILES, flash_f32
from test_torch_flash_tc import HALVES, _partial_close, _ulps, tc_flash

#: the head dims under test: Dh 32 (PR 19's) and the five between the tiles
DHS = [16, 32, 48, 80, 96, 112]
TOL = 2e-5
SMS = 132                      # an H100's SM count
CPU = mxt.cpu()
#: cache type -> (torch dtype, numpy dtype of the values handed to JAX,
#: query dtype in torch, query dtype in JAX)
CACHES = {
    "float32": (torch.float32, np.float32, torch.float32, jnp.float32),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16, torch.bfloat16,
                 jnp.bfloat16),
    "float16": (torch.float16, np.float16, torch.float16, jnp.float16),
    "e4m3": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, torch.float32,
             jnp.float32),
    "e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2, torch.float32,
             jnp.float32),
}


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


@pytest.fixture(params=DHS)
def dh(request):
    return request.param


def test_the_kernels_take_head_dim_32(dh):
    """Every multiple of 16 up to 128 is a head dim of every attention
    kernel whose rows are whole 16-byte copies on the smallest tile that
    holds it (``HEAD_DIMS``); the float32 flash forward's emulation walks
    the tiles ``cc::Tile`` gives there. Dh 24 and 144 are not among them:
    they run on narrower copies and on the wide routes
    (``tests/test_torch_any_shape.py``)."""
    assert ck.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    assert dh in ck.HEAD_DIMS and 24 not in ck.HEAD_DIMS and \
        144 not in ck.HEAD_DIMS
    tile = ck.head_tile(dh)
    assert tile == min(t for t in (32, 64, 128) if t >= dh)
    assert TILES[tile] == {32: (128, 64), 64: (64, 64), 128: (64, 32)}[tile]


# ------------------------------------------------------------ decode read
def _decode_inputs(cache, S, dh, B=4, H=2, c=160, seed=0):
    """(torch q, k, v, pos), (jax q, k, v, pos) of the same values, each
    rounded once from the same float32 draws; cursors at 0, a split's last
    key, the next split's first key and C - S."""
    t_dt, np_dt, q_t, q_j = CACHES[cache]
    rs = np.random.RandomState(seed + S + dh)
    q = rs.randn(B, H, S, dh).astype(np.float32)
    k, v = (2 * rs.randn(B, H, c, dh).astype(np.float32) for _ in range(2))
    _, keys = ck._decode_splits(B * H, S, c, SMS)
    pos = np.asarray([0, keys - 1, min(keys, c - S), c - S], np.int32)
    tq = torch.from_numpy(q).to(q_t)
    tk, tv = (torch.from_numpy(a).to(t_dt) for a in (k, v))
    jk, jv = (jnp.asarray(t.float().numpy().astype(np_dt)) for t in (tk, tv))
    jq = jnp.asarray(tq.float().numpy()).astype(q_j)
    return (tq, tk, tv, torch.from_numpy(pos)), (jq, jk, jv, jnp.asarray(pos))


@pytest.mark.parametrize("S", [1, 3, 16, 64])
@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_matches_pallas_and_plain(cache, S, dh):
    (tq, tk, tv, tpos), (jq, jk, jv, jpos) = _decode_inputs(cache, S, dh)
    got = decode_attention_split(tq, tk, tv, tpos, SMS)
    plain = ck.decode_attention_plain(tq, tk, tv, tpos)
    assert got.dtype == plain.dtype == torch.float32
    assert got.shape == (4, 2, S, dh)
    _close(got, plain)
    _close(got, pk.decode_attention(jq, jk, jv, jpos))


def test_decode_split_plan_at_the_bench_width(dh):
    """The split rule reads B*H, S and C, never Dh. The bench LM's served
    step (rung 8, C 256) over 512 / Dh heads where Dh divides 512 takes 2
    splits of 128 keys at Dh 16 and 32, where 8 heads of 64 take 4 of 64
    (a Dh 32 block reads a Dh 64 block's bytes); at d_model 8 Dh over 8
    heads (chip_smoke's head-dim phase) every Dh takes 4 of 64, as Dh 64
    over d_model / 64 heads does at 48 and 80 (d_model 384, 640). The
    split workspace is laid out at the tile's head dim."""
    assert ck._decode_splits(8 * 8, 1, 256, SMS) == (4, 64)
    if 512 % dh == 0:
        assert ck._decode_splits(8 * (512 // dh), 1, 256, SMS) == (2, 128)
    if dh in (48, 80):
        assert ck._decode_splits(8 * (8 * dh // 64), 1, 256, SMS) == (4, 64)
    tile = ck.head_tile(dh)
    assert ck._decode_ws_sizes(64, 1, tile, 4) == (64 * 4 * (tile + 2), 64)


# ------------------------------------------------------ float32 flash
def _qkv(tq, tk, seed, dh, B=1, H=2):
    rs = np.random.RandomState(seed + dh)
    return (rs.randn(B, H, tq, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [32, 96, 128, 160])
def test_flash_f32_matches_pallas_and_plain(T, causal, dh):
    """T below one query tile, one tile, across the query and key tiles,
    ragged."""
    q, k, v = _qkv(T, T, seed=T, dh=dh)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_f32(tq, tk, tv, causal=causal)
    ref = jrtc.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=32,
                               block_k=32)
    _close(got, ref)
    _close(got, ck.flash_attention_plain(tq, tk, tv, causal))


#: (Tq, Tk, q_off, k_off): past, diagonal, future, shifted and Tq != Tk
_SHARDS = [(128, 128, 128, 0), (96, 96, 96, 96), (64, 64, 0, 64),
           (64, 64, 16, 0), (32, 160, 160, 0), (160, 32, 0, 32)]


@pytest.mark.parametrize("shard", _SHARDS)
def test_flash_f32_partial_matches_pallas_and_plain(shard, dh):
    tq, tk, q_off, k_off = shard
    q, k, v = _qkv(tq, tk, seed=tq + tk + q_off, dh=dh)
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    got = flash_f32(tq_, tk_, tv_, q_off, k_off, True, partial=True)
    ref = jrtc.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off,
        causal=True, block_q=32, block_k=32)
    plain = ck.flash_attention_partial_plain(tq_, tk_, tv_, q_off, k_off,
                                             True)
    for name, g, r, p in zip(("acc", "m", "l"), got, ref, plain):
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isneginf(g.numpy()), np.isneginf(r))
        _close(g, r, msg=name)
        _close(g, p, msg=name)
    if q_off + tq <= k_off:           # a future shard: no row sees a key
        assert np.isneginf(got[1].numpy()).all()
        assert not got[2].numpy().any() and not got[0].numpy().any()


# ------------------------------------------------------- 16-bit flash
def _tc_tile(dh):
    """The 16-bit kernels' tile: Dh 64's up to 64, Dh 128's above."""
    return max(64, ck.head_tile(dh))


def _padded(t):
    """The tile TMA fills from an operand of a narrower Dh: the columns
    past Dh zeros."""
    pad = _tc_tile(t.shape[-1]) - t.shape[-1]
    return torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], dim=-1)


def _tc(q, k, v, causal, q_off=0, k_off=0, partial=False):
    """The 16-bit kernels at q's Dh: the tile's arithmetic on the
    zero-padded operands with the caller's scale, Dh^-1/2; the Dh stored
    columns."""
    dh = q.shape[-1]
    out = tc_flash(*map(_padded, (q, k, v)), causal, q_off, k_off,
                   scale=dh ** -0.5, partial=partial)
    if partial:
        acc, m, l = out
        assert not acc[..., dh:].any()
        return acc[..., :dh], m, l
    assert not out[..., dh:].float().any()
    return out[..., :dh]


def _half_qkv(half, tq, tk, seed, dh):
    return [torch.from_numpy(a).to(HALVES[half][0])
            for a in _qkv(tq, tk, seed, dh)]


def _jnp(t, half):
    return jnp.asarray(t.float().numpy()).astype(HALVES[half][1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 65, 200])
@pytest.mark.parametrize("half", list(HALVES))
def test_flash_tc_matches_plain(half, T, causal, dh):
    q, k, v = _half_qkv(half, T, T, seed=T, dh=dh)
    got = _tc(q, k, v, causal)
    want = ck.flash_attention_plain(q, k, v, causal)
    assert got.dtype == want.dtype == HALVES[half][0]
    assert _ulps(half, got, want, atol=2e-5) <= 1.0


@pytest.fixture
def pallas_tier(monkeypatch):
    """The JAX side as its Pallas kernels (interpret mode off-TPU)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", "pallas")
    kernel_tier.clear()
    yield
    kernel_tier.clear()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("half", list(HALVES))
def test_flash_tc_matches_pallas(pallas_tier, half, causal, dh):
    q, k, v = _half_qkv(half, 128, 128, seed=7, dh=dh)
    ref = jrtc.flash_attention(*(_jnp(t, half) for t in (q, k, v)),
                               causal=causal, block_q=64, block_k=64)
    want = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _ulps(half, _tc(q, k, v, causal).float(), want,
                 atol=2e-5) <= 1.0


@pytest.mark.parametrize("shard", [(128, 128, 0, 0), (128, 128, 128, 128),
                                   (128, 128, 256, 128), (128, 128, 0, 128),
                                   (160, 64, 96, 0)])
@pytest.mark.parametrize("half", list(HALVES))
def test_flash_tc_partial_matches_plain_and_pallas(pallas_tier, half,
                                                   shard, dh):
    tq, tk, q_off, k_off = shard
    causal = shard != (128, 128, 0, 0)
    q, k, v = _half_qkv(half, tq, tk, seed=tq + q_off, dh=dh)
    got = _tc(q, k, v, causal, q_off, k_off, partial=True)
    _partial_close(got, ck.flash_attention_partial_plain(
        q, k, v, q_off, k_off, causal))
    ref = jrtc.flash_attention_partial(*(_jnp(t, half) for t in (q, k, v)),
                                       q_off, k_off, causal=causal,
                                       block_q=32, block_k=32)
    _partial_close(got, ref)


# ------------------------------------------------------- the small LM
V, L, H, CAP, T, B = 64, 2, 2, 16, 32, 4


def _decode_params(D):
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                 n_head=H, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(0)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        scale = 0.3 if name.endswith("weight") else 0.1
        base = 1.0 if name.endswith("gamma") else 0.0
        out[name] = (base + scale * rs.randn(*shape)).astype(np.float32)
    return out


def _drive(sched, clock, prompts):
    handles = []
    for i, (n, iters) in enumerate([(2, 3), (2, 2)]):
        for j in range(n):
            handles.append(sched.submit(prompts[2 * i + j],
                                        max_new_tokens=4 + 2 * i + j))
        sched.pump(max_iterations=iters)
        clock.advance(0.01)
    sched.pump()
    return [h.result(timeout=0).tolist() for h in handles]


def test_serve_decoder_chains_match_jax(jax_tier, dh):
    """Greedy chains of four staggered requests at ladder [1, 2, 4], d_model
    2 Dh."""
    D = H * dh
    decode_params = _decode_params(D)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, rs.randint(1, 5)).tolist() for _ in range(4)]
    kw = dict(vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
              per_slot=True)
    jclock, tclock = JaxFakeClock(), FakeClock()
    jsched = mx.serve.serve_decoder(
        jtfm.get_decode_symbol(**kw),
        {k: mx.nd.array(v) for k, v in decode_params.items()},
        name=f"dh{dh}", ladder=[1, 2, 4], clock=jclock, start=False,
        context=mx.cpu())
    tsched = mxt.serve.serve_decoder(
        ttfm.get_decode_symbol(**kw),
        mxt.convert.params_from_numpy(decode_params, CPU), name=f"dh{dh}",
        ladder=[1, 2, 4], clock=tclock, start=False, context=CPU)
    chains = _drive(tsched, tclock, prompts)
    assert chains == _drive(jsched, jclock, prompts)
    assert [len(c) for c in chains] == [4, 5, 6, 7]


def test_fit_step_gradients_match_jax(jax_tier, dh):
    """One training step's gradients from the same Xavier start (carried
    across as numpy) at d_model 2 Dh, every parameter's within 2e-5."""
    D = H * dh
    it = jtfm.SyntheticLMIter(V, B, T, 1, seed=2)
    jmod = mx.mod.Module(jtfm.get_symbol(V, D, L, H, T), context=mx.cpu())
    jmod.bind(it.provide_data, it.provide_label)
    jmod.init_params(mx.initializer.Xavier())
    start = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    jbatch = next(iter(it))
    jmod.forward(jbatch, is_train=True)
    jmod.backward()
    jgrads = {k: v.asnumpy()
              for k, v in jmod._exec_group.executor.grad_dict.items()
              if k in start}

    tit = ttfm.SyntheticLMIter(V, B, T, 1, seed=2)
    tmod = mxt.mod.Module(ttfm.get_symbol(V, D, L, H, T), context=CPU)
    tmod.bind(tit.provide_data, tit.provide_label)
    tmod.init_params(arg_params=mxt.convert.params_from_numpy(start, CPU))
    tmod.forward(next(iter(tit)), is_train=True)
    tmod.backward()
    tgrads = tmod._exec_group.executor.grad_dict
    assert sorted(jgrads) == sorted(k for k in tgrads if k in start)
    for k, g in jgrads.items():
        assert np.abs(g).max() > 0, k
        _close(tgrads[k].asnumpy(), g, msg=k)
