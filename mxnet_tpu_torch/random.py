"""The global random chain: the JAX package's threefry2x32 keys.

``mx.random.seed(s)`` makes the key ``(0, s & 0xffffffff)``, and
every consumer draws from one host-side chain: ``next_key()`` splits the
key and hands out the second half. An executor forward draws one key,
and each node whose op needs randomness (Dropout, the samplers) takes
``fold_in(key, i)``, i the node's index in the executor's node list; a
module's training step draws a key once and splits it every step; an
imperative sampler draws one key a call; the initializers draw one key a
parameter. Seeding is deterministic and device-independent: a key is two
uint32 words kept on the host, split and folded here in a few
microseconds of Python, and the random bits of a key are the same on the
CPU and on the card, and the same as the JAX package's.

The bits are threefry2x32 as ``jax.random`` computes them (JAX 0.9 with
``jax_threefry_partitionable``): element ``n`` of a draw (row-major) hashes
the counter ``(n >> 32, n & 0xffffffff)`` under the key, and its 32 bits
are the xor of the two output words. ``split(key, num)`` hashes the
counters ``(0, i)``, and ``fold_in(key, d)`` is the key ``split`` would
give at index ``d``. ``uniform`` sets the bits below the exponent of 1.0
and subtracts 1 (23 bits in float32, 10 in float16, 7 in bfloat16), then
scales to ``[lo, hi)`` with JAX's ``max(lo, .)`` clamp; ``bernoulli`` is
``uniform < p`` in float32; ``normal`` is ``sqrt(2) * erfinv(u)`` over
``u`` uniform in ``(nextafter(-1, 0), 1)``; ``exponential`` is
``-log1p(-u)``. The functions here are the plain versions, integer
PyTorch on any device; on the card ``ops/cuda_kernels.py`` computes the
same bits in one launch (``csrc/threefry.cu``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "next_key", "generation", "get_state", "set_state",
           "prng_key", "split", "fold_in", "threefry2x32", "bits",
           "uniform", "bernoulli", "normal", "exponential", "draw",
           "key_words", "UNIFORM", "NORMAL", "EXPONENTIAL"]

_M32 = 0xFFFFFFFF
#: the transforms of a uniform draw (``draw``; the card's uniform kernel
#: takes the same codes)
UNIFORM, NORMAL, EXPONENTIAL = 0, 1, 2
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# ``generation`` bumps on every seed() and set_state(), so a consumer that
# keeps its own chain (a module's training step) can see a reseed and draw
# again from the new chain
_STATE = {"key": None, "generation": 0}


def threefry2x32(k0, k1, x0, x1):
    """Threefry2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``. The words are Python ints or int64 tensors
    holding values in [0, 2^32); returns the two output words alike."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key_words(key):
    """The two uint32 words of ``key`` as Python ints."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def prng_key(seed_value):
    """The key of an integer seed: ``(0, seed mod 2^32)``, the key
    ``jax.random.PRNGKey`` makes of a seed in 32-bit mode (the JAX
    package runs without 64-bit types)."""
    return np.array([0, int(seed_value) & _M32], dtype=np.uint32)


def split(key, num=2):
    """``num`` new keys, (num, 2) uint32: the hash of the counters
    ``(0, i)`` under ``key``."""
    k0, k1 = key_words(key)
    out = np.empty((num, 2), dtype=np.uint32)
    for i in range(num):
        out[i] = threefry2x32(k0, k1, 0, i)
    return out


def fold_in(key, data):
    """The key of ``data`` (an int taken modulo 2^32) under ``key``."""
    k0, k1 = key_words(key)
    return np.array(threefry2x32(k0, k1, 0, int(data) & _M32),
                    dtype=np.uint32)


def seed(seed_state):
    """Seed the global chain."""
    _STATE["key"] = prng_key(seed_state)
    _STATE["generation"] += 1


def generation():
    """How many times the chain was seeded or restored."""
    return _STATE["generation"]


def next_key():
    """Split the global key and return a fresh one; the chain starts
    from seed 0 when nothing seeded it."""
    if _STATE["key"] is None:
        _STATE["key"] = prng_key(0)
    _STATE["key"], sub = split(_STATE["key"])
    return sub


def get_state():
    """A picklable snapshot of the chain: the key words (None when
    nothing seeded or drew) and the generation, as the JAX package's."""
    key = _STATE["key"]
    return {"key": None if key is None else np.array(key, dtype=np.uint32),
            "generation": int(_STATE["generation"])}


def set_state(state):
    """Restore a ``get_state`` snapshot; the generation moves on, so a
    consumer with a chain of its own draws again from the restored one."""
    key = state.get("key")
    _STATE["key"] = None if key is None else \
        np.array(key, dtype=np.uint32).reshape(2)
    _STATE["generation"] += 1


# ----------------------------------------------------------- plain draws
def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(d) for d in shape)


def bits(key, shape, device=None):
    """The 32 random bits of each element of a draw of ``shape``, as an
    int64 tensor of values in [0, 2^32)."""
    shape = _shape(shape)
    k0, k1 = key_words(key)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


#: float dtype -> (random bits used, mantissa bits, bits of 1.0, the signed
#: integer type of its width)
_FLOAT_BITS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.float16: (16, 10, 0x3C00, torch.int16),
               torch.bfloat16: (8, 7, 0x3F80, torch.int16)}


def unit(raw, dtype=torch.float32):
    """Floats in [0, 1) of ``dtype`` from 32-bit ``raw`` bits (int64):
    the low bits the type uses, shifted below the exponent of 1.0, minus
    1."""
    nbits, nmant, one, itype = _FLOAT_BITS[dtype]
    b = raw & ((1 << nbits) - 1)
    f = ((b >> (nbits - nmant)) | one).to(itype).view(dtype)
    return f - torch.ones((), dtype=dtype, device=f.device)


def fma32(a, b, c):
    """``a * b + c`` over float32 tensors, rounded once (a fused
    multiply-add, as XLA computes ``uniform``'s scaling): the product is
    exact in float64 and the sum's error is found exactly (TwoSum), which
    settles the one case where rounding the float64 sum to float32 would
    round twice, a sum halfway between two float32 values."""
    p = a.double() * b.double()
    c64 = c.double().expand_as(p)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    up, dn = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    r = torch.where((s == (r.double() + up.double()) / 2) & (err > 0), up, r)
    return torch.where((s == (r.double() + dn.double()) / 2) & (err < 0),
                       dn, r)


def scale_unit(f, lo, hi):
    """``max(lo, f * (hi - lo) + lo)`` in ``f``'s dtype, ``lo`` and ``hi``
    rounded to it first, as XLA computes it on the CPU: in float32 one
    fused multiply-add, in float16 the float32 product and sum rounded
    once, in bfloat16 each rounded to the type."""
    lo_t = torch.tensor(lo, dtype=f.dtype, device=f.device)
    hi_t = torch.tensor(hi, dtype=f.dtype, device=f.device)
    span = hi_t - lo_t
    if f.dtype == torch.float32:
        z = fma32(f, span, lo_t)
    elif f.dtype == torch.float16:
        z = (f.float() * span.float() + lo_t.float()).to(f.dtype)
    else:       # bfloat16: XLA rounds the product and the sum each
        z = f * span + lo_t
    return torch.maximum(lo_t, z)


def uniform(key, shape, lo=0.0, hi=1.0, dtype=torch.float32, device=None):
    """Uniform draws in [lo, hi) of ``dtype`` (torch.float32, float16 or
    bfloat16)."""
    return scale_unit(unit(bits(key, shape, device), dtype), lo, hi)


def bernoulli(key, p, shape, device=None):
    """True with probability ``p``: ``uniform < p``, compared in
    float32."""
    return uniform(key, shape, device=device) < \
        torch.tensor(float(p), dtype=torch.float32)


def normal_lo(dtype):
    """``nextafter(-1, 0)`` in ``dtype``: the low end of ``normal``'s
    uniform draw (-1 + 2^-24, 2^-11 or 2^-8)."""
    return -1.0 + 2.0 ** -(_FLOAT_BITS[dtype][1] + 1)


def normal(key, shape, dtype=torch.float32, device=None):
    """Standard normal draws: ``sqrt(2) * erfinv(u)``."""
    u = uniform(key, shape, normal_lo(dtype), 1.0, dtype, device)
    return torch.tensor(np.sqrt(2.0), dtype=dtype) * torch.erfinv(u)


def exponential(key, shape, dtype=torch.float32, device=None):
    """Exponential draws of rate 1: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape, dtype=dtype, device=device))


def draw(key, shape, transform=UNIFORM, lo=0.0, hi=1.0,
         dtype=torch.float32, device=None):
    """``uniform(key, shape, lo, hi)``, ``normal`` or ``exponential``, by
    ``transform`` (``lo`` and ``hi`` are read by ``UNIFORM`` alone)."""
    if transform == NORMAL:
        return normal(key, shape, dtype, device)
    if transform == EXPONENTIAL:
        return exponential(key, shape, dtype, device)
    return uniform(key, shape, lo, hi, dtype, device)
