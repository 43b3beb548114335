"""Attention at the head dims between the kernels' tiles (16, 32, 48, 80,
96 and 112): the float32 flash forward and its partial mode, and their
16-bit instances, against ``mxnet_tpu`` on the CPU. The kernels and the
tiles they take are described in ``tests/test_torch_headdim32.py``; here,
on the same numpy-seeded values, within the limits their own tests use:

* the float32 flash forward's order (``tests/flash_f32_emul.py``, on the
  tile the kernel takes) in both modes against ``rtc.flash_attention`` /
  ``flash_attention_partial`` (Pallas, interpret) and the plain versions:
  2e-5;
* the 16-bit flash forward's arithmetic (``tc_flash`` of
  ``tests/test_torch_flash_tc.py``) on the zero-padded tiles, cut back to
  Dh columns, against the plain versions and the Pallas kernel: one
  16-bit ulp beyond 2e-5 (normalized), 2e-5 of each array's largest
  magnitude (partial).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu import kernel_tier
from mxnet_tpu import rtc as jrtc

from mxnet_tpu_torch.ops import cuda_kernels as ck

from flash_f32_emul import flash_f32
from test_torch_flash_tc import HALVES, _partial_close, _ulps, tc_flash
from test_torch_headdim32 import _close, dh  # noqa: F401 (a fixture)


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

