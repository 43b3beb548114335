"""The dequant-fused matmul's GEMV route (``csrc/qfc_matmul.cu``) on the CPU.

For small M the kernel reads each weight row once in 16-byte units, a warp
for 4 output channels and one of ks splits of K, its lanes' partial sums
added by a shuffle butterfly and the splits' sums in split order
(``cuda_kernels._qfc_route`` picks mt and ks from the shapes alone). The
kernel runs only on a card; here ``tests/qfc_gemv_emul.py`` emulates its
order of work with the wrapper's own route (132 SMs, an H100's), and is
held to

* the JAX package's Pallas kernel, ``quant._pl_qfc_matmul``, in interpret
  mode (as ``tests/test_torch_quant.py`` runs it), and
* the port's plain version, ``qfc_matmul_plain``, what a CPU tensor runs,

on the same numpy-seeded values, for int8 and float8_e4m3fn weights;
float32, bfloat16 and float16 x; M in {1, 2, 3, 8}; K in {13, 300, 2048};
N in {1, 7, 33, 1000}, within 1e-5 of the output's largest magnitude (the
card tests' bound: float32 sums in other orders). x is widened exactly,
so the JAX kernel is called once a weight on float32 rows that hold every
x type's values. Then the route itself (the splits fill the card, the
tiled route where ``_qfc_gemv_wins`` says it is the faster, the
shared-memory limit) and the same bits on a repeat.
"""
import functools

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import quant as jq

from mxnet_tpu_torch.ops import cuda_kernels as ck

from qfc_gemv_emul import qfc_gemv

RTOL = 1e-5
SMS = 132
ROWS = 8                       # x rows a weight's JAX call takes per type
XTYPES = {"float32": (torch.float32, np.float32),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
          "float16": (torch.float16, np.float16)}
STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _weight(storage, k, n):
    w = np.random.RandomState(k + n).randn(n, k).astype(np.float32)
    return jq.quantize_per_channel(w, dtype=storage)


def _x(k, dtype):
    """ROWS rows of x in ``dtype``, as float32 numpy values."""
    x = np.random.RandomState(7 * k + 1).randn(ROWS, k).astype(np.float32)
    return x.astype(XTYPES[dtype][1]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(storage, k, n):
    """The Pallas kernel over every x type's rows: {dtype: (ROWS, N)}."""
    q, s = _weight(storage, k, n)
    xs = np.concatenate([_x(k, d) for d in XTYPES])
    out = np.asarray(jq._pl_qfc_matmul(jnp.asarray(xs), jnp.asarray(q),
                                       jnp.asarray(s)))
    return {d: out[i * ROWS:(i + 1) * ROWS] for i, d in enumerate(XTYPES)}


def _torch_inputs(storage, dtype, m, k, n):
    q, s = _weight(storage, k, n)
    x = torch.from_numpy(_x(k, dtype)[:m]).to(XTYPES[dtype][0])
    if storage == "int8":
        w = torch.from_numpy(q)
    else:       # the port never asks numpy for float8 (its raw bytes)
        w = torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn)
    return x, w, torch.from_numpy(s)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= RTOL * top


def gemv_order_matches(storage, dtype, m, k, n):
    """The emulated order against the Pallas kernel and the plain version
    (and the wrapper on a CPU tensor against the plain version).
    ``test_gemv_order_matches_pallas_and_plain`` runs it for the int8
    weights here and for the float8_e4m3fn weights in
    ``tests/test_torch_qfc_gemv_fp8.py``: two files, so that
    pytest-xdist's ``--dist loadfile`` runs them on two workers."""
    x, w, s = _torch_inputs(storage, dtype, m, k, n)
    assert ck._qfc_route(m, n, k, SMS)[0] > 0
    got = qfc_gemv(x, w, s, SMS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close(got, _reference(storage, k, n)[dtype][:m])
    plain = ck.qfc_matmul_plain(x, w, s)
    _close(got, plain)
    _close(ck.qfc_matmul(x, w, s), plain)            # CPU: the plain


#: the grid of ``test_gemv_order_matches_pallas_and_plain``, less storage
GRID = [pytest.mark.parametrize("dtype", list(XTYPES)),
        pytest.mark.parametrize("m", [1, 2, 3, 8]),
        pytest.mark.parametrize("k", [13, 300, 2048]),
        pytest.mark.parametrize("n", [1, 7, 33, 1000])]


def on_grid(fn):
    for mark in GRID:
        fn = mark(fn)
    return fn


@on_grid
@pytest.mark.parametrize("storage", ["int8"])
def test_gemv_order_matches_pallas_and_plain(storage, dtype, m, k, n):
    gemv_order_matches(storage, dtype, m, k, n)


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (3, 300, 7),
                                   (1, 13, 1)])
def test_gemv_order_repeats_bit_for_bit(storage, m, k, n):
    x, w, s = _torch_inputs(storage, "float32", m, k, n)
    a, b = qfc_gemv(x, w, s, SMS), qfc_gemv(x, w, s, SMS)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_route_splits_k_to_fill_the_card():
    """ResNet-50's head at the serving rungs: mt rows of x a block (the
    rung, 4 at most), K split in 4 (its most at K = 2048: 32 units a
    split) where half the splits would leave most SMs idle; a single
    output channel still splits K; K of 13 is one unit."""
    for m in (1, 2, 4, 8):
        mt, ks = ck._qfc_route(m, 1000, 2048, SMS)
        assert (mt, ks) == (min(m, 4), 4)
        half = -(-1000 // (ck.QFC_NR * ck.QFC_WARPS // (ks // 2))) * \
            -(-m // mt)
        assert half < SMS
    assert ck._qfc_route(3, 1000, 2048, SMS) == (4, 4)
    assert ck._qfc_route(16, 1000, 2048, SMS) == (4, 2)
    assert ck._qfc_route(64, 1000, 2048, SMS) == (4, 1)
    assert ck._qfc_route(8, 1, 2048, SMS) == (4, 4)
    assert ck._qfc_route(5, 7, 13, SMS) == (4, 1)
    assert ck._qfc_route(2, 4, 4, SMS) == (2, 1)


def test_route_takes_the_tiles_past_the_break_and_the_smem_limit():
    """The break of the route-break table: at N 1000 (16 tiles a 64-row
    band) the GEMV route up to M = 976, where M N reaches 7400 outputs an
    SM; at N 4096 between M = 128 and 256; at N 32000 (500 tiles a band,
    the card filled) between 32 and 64, and again for 65 rows, where the
    tiled route's second band is nearly empty; a single output channel
    (1 / 64 of each tile) never takes the tiles."""
    top = ck.QFC_GEMV_PER_SM * SMS // 1000
    assert top == 976
    for k in (13, 2048):
        assert ck._qfc_route(top, 1000, k, SMS)[0] == 4
        assert ck._qfc_route(top + 1, 1000, k, SMS) == (0, 1)
    assert ck._qfc_route(top, 1001, 2048, SMS) == (0, 1)
    assert ck._qfc_route(128, 4096, 2048, SMS)[0] == 4
    assert ck._qfc_route(256, 4096, 2048, SMS) == (0, 1)
    assert ck._qfc_route(32, 32000, 2048, SMS)[0] == 4
    assert ck._qfc_route(64, 32000, 2048, SMS) == (0, 1)
    assert ck._qfc_route(65, 32000, 2048, SMS)[0] == 4
    assert ck._qfc_route(1 << 20, 1, 64, SMS)[0] == 4
    # mt halves while 4 staged rows exceed a block's shared memory
    mt, _ = ck._qfc_route(8, 1000, 16384, SMS)
    assert mt < 4 and ck._qfc_gemv_smem(mt, 16384) <= ck._SMEM_OPT_IN
    assert ck._qfc_gemv_smem(2 * mt, 16384) > ck._SMEM_OPT_IN
    assert ck._qfc_route(1, 1000, 1 << 16, SMS) == (0, 1)
