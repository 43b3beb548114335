"""The float32 flash-attention forward's order of work (``csrc/flash_attention.cu``,
namespace ``cc``, rows 14 and 15 in float32) on the CPU.

The kernel walks key tiles of 64 keys at Dh 64 and 32 at Dh 128
(``cc::Tile<Dh>``; the emulation's ``TILES`` is held to the source) for
query tiles of 64 rows, skips the tiles
wholly above the diagonal and runs the TPU kernel's online softmax over
each. The kernel runs only on a card; here ``tests/flash_f32_emul.py``
emulates that order in float32 and is held, on the same numpy-seeded
values, within 2e-5 to

* the JAX package's Pallas kernel in interpret mode,
  ``rtc.flash_attention`` and ``rtc.flash_attention_partial`` (as
  ``tests/test_torch_lm_kernels.py`` and ``tests/test_torch_ring.py`` run
  them), at block sizes other than the kernel's, and
* the port's plain versions, ``flash_attention_plain`` and
  ``flash_attention_partial_plain`` (what a CPU tensor runs),

at T on both sides of the tiles, Dh 64 and 128, causal and not; in the
partial mode past, diagonal, future and Tq != Tk shards, the rows that see
no key exactly -inf / 0 / 0.
"""
import pathlib
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu import rtc as jrtc

from mxnet_tpu_torch.ops import cuda_kernels as ck

from flash_f32_emul import TILES, flash_f32

TOL = 2e-5


def _qkv(B, H, tq, tk, dh, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, tq, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=msg)


def test_f32_emulation_tiles_are_the_kernels():
    """The emulation walks the tiles that ``cc::Tile<Dh>`` in
    ``csrc/flash_attention.cu`` gives the kernel (kBq query rows, kBk keys
    a K / V tile), for every head dim the kernel takes."""
    src = (pathlib.Path(ck.__file__).parent.parent / "csrc" /
           "flash_attention.cu").read_text()
    tiles = {int(dh): (int(bq), int(bk)) for dh, bq, bk in re.findall(
        r"struct Tile<(\d+)> \{[^}]*?kBq = (\d+)[^}]*?kBk = (\d+)", src)}
    assert tiles == TILES


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("T,block", [(32, 32), (96, 32), (128, 64),
                                     (160, 32)])
def test_f32_order_matches_pallas_and_plain(T, block, dh, causal):
    """T below one tile, across query and key tiles, and ragged against
    the kernel's (96 and 160 are no multiple of 64)."""
    q, k, v = _qkv(1, 2, T, T, dh, seed=T + dh)
    got = flash_f32(*map(torch.from_numpy, (q, k, v)), causal=causal)
    ref = jrtc.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=block,
                               block_k=block)
    _close(got, ref)
    _close(got, ck.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                         causal))


#: (Tq, Tk, q_off, k_off): past, diagonal, future, shifted and Tq != Tk
_SHARDS = [(64, 64, 64, 0), (96, 96, 96, 96), (64, 64, 0, 64),
           (64, 64, 16, 0), (32, 96, 96, 0), (96, 32, 0, 32),
           (128, 64, 32, 0)]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("shard", _SHARDS)
def test_f32_partial_order_matches_pallas_and_plain(shard, dh):
    tq, tk, q_off, k_off = shard
    q, k, v = _qkv(1, 2, tq, tk, dh, seed=tq + tk + q_off)
    got = flash_f32(*map(torch.from_numpy, (q, k, v)), q_off, k_off, True,
                    partial=True)
    ref = jrtc.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off,
        causal=True, block_q=32, block_k=32)
    plain = ck.flash_attention_partial_plain(
        *map(torch.from_numpy, (q, k, v)), q_off, k_off, True)
    for name, g, r, p in zip(("acc", "m", "l"), got, ref, plain):
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isneginf(g.numpy()), np.isneginf(r))
        _close(g, r, name)
        _close(g, p, name)
    if q_off + tq <= k_off:           # a future shard: no row sees a key
        assert np.isneginf(got[1].numpy()).all()
        assert not got[2].numpy().any() and not got[0].numpy().any()

