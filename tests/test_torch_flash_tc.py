"""The arithmetic of the 16-bit flash-attention kernels, emulated on the CPU.

The bfloat16 and float16 instances of the flash-attention forward (both
modes: ``flash_attention`` and ring attention's ``flash_attention_
partial``) run on the card's tensor cores. Their arithmetic differs from
the plain versions' in three places, and ``tc_flash`` below repeats it in
plain PyTorch:

- S = q . k^T from the 16-bit q and k as stored (every product of two
  16-bit values is exact in float32, the sum float32), and only then
  times ``scale`` (the plain version scales q before the product);
- the float32 online softmax over key tiles of the kernel's width (128
  keys at Dh 64, 64 at Dh 128), with the TPU kernel's guards;
- P . V as p_hi . V + p_lo . V, p_hi = round16(p), p_lo = round16(p -
  p_hi), while l sums the unsplit float32 p.

The emulation is held to the plain versions (``cuda_kernels.flash_
attention_plain`` / ``flash_attention_partial_plain``) and to the JAX
package's Pallas kernel (interpret mode) on numpy-seeded inputs, at the
limits ``chip_smoke.py`` holds the card's kernels to. The emulation lives
here only: nothing on the port's path calls it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import kernel_tier
from mxnet_tpu import rtc as jrtc

from mxnet_tpu_torch.ops import cuda_kernels as ck

HALVES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 7, -126),
          "float16": (torch.float16, jnp.float16, 10, -14)}
#: the normalized output: within one ulp of the 16-bit type beyond 2e-5
#: of the reference. Both compute the same float32 function up to the
#: order of the sums, P carried to 2^-16 of itself (bfloat16; 2^-22 in
#: float16) and, at Dh 128, the scale applied after the product (O(1)
#: float32 ulp in S): the float32 results agree to ~1e-6 of their scale,
#: and rounding them to 16 bits can still land one ulp apart
ULPS, ATOL = 1.0, 2e-5
#: the partial state (acc, m, l): within 2e-5 of each array's largest
#: magnitude (at least 1), float32 sums in another order; rows that see
#: no key exactly -inf / 0 / 0
PARTIAL_TOL = 2e-5


def _key_tile(dh):
    """The kernel's key tile: 128 keys at Dh 64, 64 at Dh 128."""
    return 128 if dh == 64 else 64


def tc_flash(q, k, v, causal, q_off=0, k_off=0, scale=None, partial=False):
    """The tensor-core kernels' arithmetic on 16-bit q (B, H, Tq, Dh) and
    k, v (B, H, Tk, Dh): the normalized output in q's dtype, or (partial)
    the float32 (acc, m, l) the key loop leaves."""
    half = q.dtype
    B, H, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    bq, bk = 128, _key_tile(dh)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    vf = v.float()
    shift = q_off - k_off
    acc = torch.zeros(B, H, tq, dh)
    m = torch.full((B, H, tq), float("-inf"))
    l = torch.zeros(B, H, tq)
    for q0 in range(0, tq, bq):
        rows = slice(q0, min(q0 + bq, tq))
        qp = torch.arange(q0, rows.stop)[:, None]
        # key tiles wholly above the query tile's diagonal are not visited
        k_end = min(tk, q0 + bq + shift) if causal else tk
        mt, lt, at = m[..., rows], l[..., rows], acc[..., rows, :]
        for k0 in range(0, max(k_end, 0), bk):
            keys = slice(k0, min(k0 + bk, tk))
            kp = torch.arange(k0, keys.stop)[None, :]
            live = kp <= qp + shift if causal else torch.ones_like(kp > qp)
            s = s_all[..., rows, keys].masked_fill(~live, float("-inf"))
            m_new = torch.maximum(mt, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.where(torch.isfinite(mt), torch.exp(mt - m_safe),
                               0.0)
            p = torch.where(torch.isfinite(s),
                            torch.exp(s - m_safe[..., None]), 0.0)
            lt = lt * corr + p.sum(dim=-1)
            p_hi = p.to(half).float()
            p_lo = (p - p_hi).to(half).float()
            at = at * corr[..., None] + p_hi @ vf[..., keys, :] \
                + p_lo @ vf[..., keys, :]
            mt = m_new
        m[..., rows], l[..., rows], acc[..., rows, :] = mt, lt, at
    if partial:
        return acc, m, l
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(half)


def _ulps(half, a, b, atol=0.0):
    """Largest |a - b|, less ``atol``, in ulps of the 16-bit type at the
    larger magnitude (below the normal range, ulps of the smallest
    normal)."""
    bits, emin = HALVES[half][2:]
    a, b = a.double(), b.double()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.tensor(2.0 ** emin, dtype=torch.float64))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    over = ((a - b).abs() - atol).clamp(min=0.0)
    return float((over / ulp).max()) if a.numel() else 0.0


def _partial_close(got, want, tol=PARTIAL_TOL):
    acc, m, l = (torch.as_tensor(np.array(t)) for t in got)
    racc, rm, rl = (torch.as_tensor(np.array(t)) for t in want)
    dead = torch.isneginf(rm)
    assert torch.equal(torch.isneginf(m), dead)
    assert not l[dead].any() and not acc[dead].any()
    for a, b in ((acc, racc), (m[~dead], rm[~dead]), (l, rl)):
        if b.numel():
            top = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) <= tol * top


def _qkv(half, shape, tk=None, seed=0):
    """numpy-seeded q, k, v rounded once to the 16-bit type."""
    rs = np.random.RandomState(seed)
    kshape = shape[:2] + (tk or shape[2],) + shape[3:]
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        HALVES[half][0]) for s in (shape, kshape, kshape)]


@pytest.mark.parametrize("half", list(HALVES))
def test_split_carries_p(half):
    """p_hi + p_lo is p to 2^-16 of itself in bfloat16, and to 2^-22 of
    itself plus half the 2^-24 subnormal step in float16: two roundings,
    each within half an ulp, the second of a remainder at most half an
    ulp of p."""
    hd = HALVES[half][0]
    rs = np.random.RandomState(1)
    p = torch.from_numpy(np.concatenate([
        rs.rand(4096), np.exp(-30 * rs.rand(4096)), [0.0, 1.0]]).astype(
            np.float32))
    hi = p.to(hd).float()
    lo = (p - hi).to(hd).float()
    assert torch.equal(p - hi, (p.double() - hi.double()).float())  # exact
    err = (p.double() - hi.double() - lo.double()).abs()
    bound = p.double().abs() * 2.0 ** -16 if half == "bfloat16" else \
        p.double().abs() * 2.0 ** -22 + 2.0 ** -25
    assert bool((err <= bound).all())
    # one 16-bit term alone would carry p only to 2^-9 (2^-12)
    assert float((p - hi).abs().max()) > float(err.max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 65, 200, 1000])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("half", list(HALVES))
def test_emulation_matches_plain(half, dh, T, causal):
    q, k, v = _qkv(half, (1, 2, T, dh), seed=T + dh)
    got = tc_flash(q, k, v, causal)
    want = ck.flash_attention_plain(q, k, v, causal)
    assert got.dtype == want.dtype == HALVES[half][0]
    assert _ulps(half, got, want, atol=ATOL) <= ULPS


#: chip_smoke.py's partial cases at the ring's shards (Ts = 1024): (Tq, Tk,
#: q_off, k_off, causal)
_TS = 1024
_RING_CASES = [(_TS, _TS, 0, 0, False), (_TS, _TS, _TS, _TS, True),
               (_TS, _TS, 2 * _TS, _TS, True), (_TS, _TS, 0, _TS, True),
               (_TS, _TS // 2, 3 * _TS // 2, _TS, True),
               (200, 1000, 900, 0, True)]


@pytest.mark.parametrize("case", _RING_CASES)
@pytest.mark.parametrize("half", list(HALVES))
def test_partial_emulation_matches_plain(half, case):
    tq, tk, q_off, k_off, causal = case
    q, k, v = _qkv(half, (1, 2, tq, 64), tk=tk, seed=tq + tk + q_off)
    got = tc_flash(q, k, v, causal, q_off, k_off, partial=True)
    _partial_close(got, ck.flash_attention_partial_plain(q, k, v, q_off,
                                                         k_off, causal))


@pytest.fixture
def pallas_tier(monkeypatch):
    """The JAX side as its Pallas kernels (interpret mode off-TPU)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", "pallas")
    kernel_tier.clear()
    yield
    kernel_tier.clear()


def _jnp(t, half):
    return jnp.asarray(t.float().numpy()).astype(HALVES[half][1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", [((1, 2, 128, 64), 64),
                                         ((1, 2, 128, 128), 128),
                                         ((2, 1, 256, 64), 128)])
@pytest.mark.parametrize("half", list(HALVES))
def test_emulation_matches_pallas(pallas_tier, half, shape, block, causal):
    q, k, v = _qkv(half, shape, seed=shape[2] + block)
    ref = jrtc.flash_attention(*(_jnp(t, half) for t in (q, k, v)),
                               causal=causal, block_q=block, block_k=block)
    assert ref.dtype == HALVES[half][1]
    want = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got = tc_flash(q, k, v, causal).float()
    assert _ulps(half, got, want, atol=ATOL) <= ULPS


@pytest.mark.parametrize("case", [(128, 128, 0, 0, False),
                                  (128, 128, 128, 128, True),
                                  (128, 128, 256, 128, True),
                                  (128, 128, 0, 128, True),
                                  (128, 64, 192, 128, True)])
@pytest.mark.parametrize("half", list(HALVES))
def test_partial_emulation_matches_pallas(pallas_tier, half, case):
    tq, tk, q_off, k_off, causal = case
    q, k, v = _qkv(half, (1, 2, tq, 64), tk=tk, seed=tq + q_off)
    ref = jrtc.flash_attention_partial(*(_jnp(t, half) for t in (q, k, v)),
                                       q_off, k_off, causal=causal,
                                       block_q=64, block_k=64)
    _partial_close(tc_flash(q, k, v, causal, q_off, k_off, partial=True),
                   ref)
