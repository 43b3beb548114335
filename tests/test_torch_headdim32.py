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
limits their own tests use. The tests of this group lie in four files,
one a kernel or path, so that pytest-xdist's ``--dist loadfile`` spreads
them over its workers: this file (the decode read),
``test_torch_headdim32_flash.py`` (the flash forward and its partial
mode), ``test_torch_headdim32_serve.py`` (serving) and
``test_torch_headdim32_fit.py`` (a training step). This one holds

* the decode read's order of work (``tests/decode_split_emul.py``, the
  wrapper's split plan) and its plain version against the JAX package's
  Pallas kernel in interpret mode, for every cache type (float32,
  bfloat16, float16, float8_e4m3fn, float8_e5m2), S = 1 and windows:
  2e-5 (every cell widened exactly; float32 sums in other orders).
"""
import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu import kernel_tier
from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import cuda_kernels as ck

from decode_split_emul import decode_attention_split
from flash_f32_emul import TILES

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

