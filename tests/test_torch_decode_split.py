"""The decode read's split key range (``csrc/decode_attention.cu``) on the
CPU.

The kernel cuts each (b, h) row's key range into splits of whole 32-key
chunks (``cuda_kernels._decode_splits``, from B*H, S, C and the SM count
alone), runs a flash-decode a warp over the chunks of each split and
merges the warps, then the splits, in a fixed order. The kernel runs only
on a card; here ``tests/decode_split_emul.py`` emulates its order of
work in float32 with the wrapper's own plan (132 SMs, an H100's), and is
held to

* the JAX package's Pallas kernel, ``pk.decode_attention``, in interpret
  mode (as ``tests/test_torch_kernels.py`` runs it), and
* the port's plain version, ``decode_attention_plain``, what a CPU tensor
  runs,

on the same numpy-seeded values, for float32, bfloat16, float16,
float8_e4m3fn and float8_e5m2 caches (16-bit queries with 16-bit caches,
as the mixed-precision paths call it), S in {1, 3, 16, 64}, Dh 64 and 128,
B*H = 4, cursors at 0, at a split's last key, at the next split's first
key and at C - S. Every cache value is widened exactly, so every instance
is held to float32's 2e-5 (absolute and relative: float32 sums in other
orders). Then wholly empty splits (short rows in a long cache), a NaN cell
and an e5m2 infinity that poison their rows (the plain softmax's NaN
rows; the Pallas kernel drops a NaN score in some blocks, so there only
the rows it gives NaN must be NaN here and the others agree), and the
same bits on a repeat.
"""
import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_kernels as ck

from decode_split_emul import decode_attention_split

TOL = 2e-5
SMS = 132                      # an H100's SM count
B, H = 4, 1                    # B*H = 4: one cursor a row
C = 256
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


def _inputs(cache, S, dh, c=C, cursors=None, seed=0):
    """(torch q, k, v, pos), (jax q, k, v, pos) of the same values: q in
    the query type, caches in ``cache``'s type, each rounded once from
    the same float32 draws."""
    t_dt, np_dt, q_t, q_j = CACHES[cache]
    rs = np.random.RandomState(seed + S + dh)
    q = rs.randn(B, H, S, dh).astype(np.float32)
    k, v = (2 * rs.randn(B, H, c, dh).astype(np.float32) for _ in range(2))
    if cursors is None:
        _, keys = ck._decode_splits(B * H, S, c, SMS)
        cursors = [0, keys - 1, keys, c - S]
    pos = np.asarray(cursors, np.int32)
    tq = torch.from_numpy(q).to(q_t)
    tk, tv = (torch.from_numpy(a).to(t_dt) for a in (k, v))
    # the JAX side gets the torch side's rounded values, as the same type
    jk, jv = (jnp.asarray(t.float().numpy().astype(np_dt)) for t in (tk, tv))
    jq = jnp.asarray(tq.float().numpy()).astype(q_j)
    return (tq, tk, tv, torch.from_numpy(pos)), (jq, jk, jv, jnp.asarray(pos))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_split_plan():
    """The served step (B*H 64, S 1, C 256) takes 4 splits of 64 keys (256
    blocks on 132 SMs), a 4096-key cache 4 of 1024, the S = 64 window one
    split over its 4 query tiles (256 blocks), an S = 16 window 2 of 128;
    every plan covers C with a power of two of 32-key chunks a split, 32
    at most, and at least half the blocks it aims for where C allows."""
    assert ck._decode_splits(64, 1, 256, SMS) == (4, 64)
    assert ck._decode_splits(64, 1, 4096, SMS) == (4, 1024)
    assert ck._decode_splits(64, 64, 256, SMS) == (1, 256)
    assert ck._decode_splits(64, 16, 256, SMS) == (2, 128)
    assert ck._decode_splits(4, 1, 256, SMS) == (8, 32)
    assert ck._decode_splits(1, 1, 1, SMS) == (1, 32)
    for bh in (1, 4, 64, 512):
        for s in (1, 3, 16, 64):
            for c in (1, 31, 100, 256, 4096, 65536):
                splits, keys = ck._decode_splits(bh, s, c, SMS)
                per = keys // ck.DECODE_CHUNK
                assert per & (per - 1) == 0 and per <= 32
                assert (splits - 1) * keys < c <= splits * keys
                tiles = 1 if s == 1 else -(-s // 16)
                if splits < -(-c // 32):    # room for more splits
                    aim = 2 * SMS if s == 1 else SMS // 2
                    assert bh * tiles * splits >= min(aim, bh * tiles * c
                                                      // 1024) / 2


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S", [1, 3, 16, 64])
@pytest.mark.parametrize("cache", list(CACHES))
def test_emulation_matches_pallas_and_plain(cache, S, dh):
    """Cursors 0, a split's last key, the next split's first key, C - S."""
    (tq, tk, tv, tpos), (jq, jk, jv, jpos) = _inputs(cache, S, dh)
    got = decode_attention_split(tq, tk, tv, tpos, SMS)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, dh)
    _close(got, ck.decode_attention_plain(tq, tk, tv, tpos))
    _close(got, pk.decode_attention(jq, jk, jv, jpos))


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "e4m3"])
def test_wholly_empty_splits(cache, S):
    """A 4096-key cache over short rows: all but the first split (or
    first few) of every row hold no live key and leave an empty partial;
    C = 4096 is held to the plain version only (the Pallas kernel walks
    32 blocks a row in interpret mode)."""
    (tq, tk, tv, tpos), _ = _inputs(cache, S, 64, c=4096,
                                    cursors=[0, 5, 31, 300])
    splits, keys = ck._decode_splits(B * H, S, 4096, SMS)
    assert splits >= 16 and 300 + S <= splits * keys // 4  # 3/4 empty
    _close(decode_attention_split(tq, tk, tv, tpos, SMS),
           ck.decode_attention_plain(tq, tk, tv, tpos))


@pytest.mark.parametrize("cache", ["float32", "e4m3", "e5m2"])
@pytest.mark.parametrize("S", [1, 16])
def test_nan_and_infinity_poison_their_rows(cache, S):
    """A NaN K cell in row 1's live prefix (in its second split) makes
    that row NaN, a NaN V cell row 2's column 9; an e5m2 +inf K cell
    under a positive query value gives a +inf score, and row 3 NaN. Rows
    0 (and 2's other columns) stay finite and agree with the plain
    version; the Pallas kernel's NaN rows are NaN here too."""
    (tq, tk, tv, tpos), (jq, _, _, jpos) = _inputs(cache, S, 64)
    _, keys = ck._decode_splits(B * H, S, C, SMS)
    nan = torch.tensor(float("nan")).to(tk.dtype)
    tk, tv = tk.clone(), tv.clone()
    tk[1, 0, keys - 1, 3] = nan
    tv[2, 0, keys // 2, 9] = nan
    if cache == "e5m2":
        tq[3, 0, :, 5] = tq[3, 0, :, 5].abs() + 0.5
        tk[3, 0, keys + 1, 5] = torch.tensor(float("inf")).to(tk.dtype)
    got = decode_attention_split(tq, tk, tv, tpos, SMS)
    want = ck.decode_attention_plain(tq, tk, tv, tpos)
    assert torch.equal(got.isnan(), want.isnan())
    live = ~want.isnan()
    _close(got[live], want[live])
    assert got[1, 0].isnan().all() and got[2, 0, :, 9].isnan().all()
    assert not got[0].isnan().any() and not got[2, 0, :, :9].isnan().any()
    if cache == "e5m2":
        assert got[3, 0].isnan().all()
    jk, jv = (jnp.asarray(t.float().numpy().astype(CACHES[cache][1]))
              for t in (tk, tv))
    ref = np.asarray(pk.decode_attention(
        jnp.asarray(tq.float().numpy()), jk, jv, jpos), np.float32)
    assert (np.isnan(ref) <= got.isnan().numpy()).all()
    both = ~np.isnan(ref) & live.numpy()
    _close(got.numpy()[both], ref[both])


@pytest.mark.parametrize("cache", ["float32", "float16"])
def test_repeat_gives_the_same_bits(cache):
    (tq, tk, tv, tpos), _ = _inputs(cache, 3, 128)
    a = decode_attention_split(tq, tk, tv, tpos, SMS)
    b = decode_attention_split(tq, tk, tv, tpos, SMS)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_one_split_is_the_same_function():
    """The plan of a card with one SM (one split a row up to 256 keys)
    gives what 132 SMs' plan gives, within float32 rounding."""
    (tq, tk, tv, tpos), _ = _inputs("float32", 16, 64)
    assert ck._decode_splits(B * H, 16, C, 1)[0] == 1
    _close(decode_attention_split(tq, tk, tv, tpos, 1),
           decode_attention_split(tq, tk, tv, tpos, SMS))
