"""The PyTorch port's kernel plain versions against the JAX package.

Each of the four CUDA kernels of ``mxnet_tpu_torch.ops.cuda_kernels`` has
a plain PyTorch version, which is what a CPU tensor runs. Here each plain
version is held against the JAX package's Pallas kernel (run in interpret
mode, as the JAX package's own tests run it off-TPU) and against the JAX
composition the kernel replaces, on the same numpy-seeded inputs.
Tolerances: float32 2e-5 (different summation orders across the two
frameworks); the embedding gather is exact.

The kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck

TOL = 2e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- embedding
@pytest.mark.parametrize("scale", [1.0, float(np.sqrt(64))])
def test_embedding_plain_matches_pallas(scale):
    rs = np.random.RandomState(0)
    w = rs.randn(96, 64).astype(np.float32)
    ids = rs.randint(0, 96, (3, 5)).astype(np.int32)
    ref = np.asarray(pk.fused_embedding(jnp.asarray(ids), jnp.asarray(w),
                                        scale))
    got = ck.embedding_plain(_t(ids.ravel()), _t(w), scale).numpy()
    assert np.array_equal(ref.reshape(-1, 64), got)


def test_embedding_plain_out_of_range_matches_composition():
    """jnp.take's fill: [-V, 0) counts from the end, the rest is NaN."""
    rs = np.random.RandomState(1)
    w = rs.randn(16, 8).astype(np.float32)
    ids = np.asarray([0, 15, 16, -1, -16, -17, 1000, 3], np.int32)
    op = jax_op("Embedding")
    attrs = op.normalize_attrs({"input_dim": 16, "output_dim": 8,
                                "scale": 2.0})
    (ref,), _ = op.forward(attrs, [jnp.asarray(ids), jnp.asarray(w)], [],
                           False, None)
    got = ck.embedding_plain(_t(ids), _t(w), 2.0).numpy()
    np.testing.assert_array_equal(np.asarray(ref), got)   # NaN == NaN


# ------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("shape", [(8, 64), (5, 48)])
def test_layernorm_plain_matches_pallas(shape):
    rs = np.random.RandomState(2)
    x = (3 * rs.randn(*shape) + 1).astype(np.float32)
    g = rs.randn(shape[1]).astype(np.float32)
    b = rs.randn(shape[1]).astype(np.float32)
    y, mean, rstd = pk._pl_layernorm_fwd(jnp.asarray(x), jnp.asarray(g),
                                         jnp.asarray(b), 1e-5)
    py, pmean, prstd = ck.layernorm_plain(_t(x), _t(g), _t(b), 1e-5)
    _close(y, py)
    _close(np.asarray(mean)[:, 0], pmean)
    _close(np.asarray(rstd)[:, 0], prstd)


def test_layernorm_std_kernel_side_vs_composition():
    """The kernel path reports std = 1/rstd, the composition
    sqrt(var + eps): the two agree to float32 rounding (2e-5 relative)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 32).astype(np.float32)
    g = rs.randn(32).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    op = jax_op("LayerNorm")
    (y, mean, std), _ = op.forward(op.normalize_attrs({}),
                                   [jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b)], [], False, None)
    py, pmean, pstd = ck.fused_layernorm(_t(x), _t(g), _t(b), 1e-5)
    _close(y, py)
    _close(mean, pmean)
    _close(std, pstd)


# ------------------------------------------------------- bias + GeLU
@pytest.mark.parametrize("shape", [(8, 128), (3, 40)])
def test_bias_gelu_plain_matches_pallas_and_composition(shape):
    rs = np.random.RandomState(4)
    x = (2 * rs.randn(*shape)).astype(np.float32)
    b = rs.randn(shape[1]).astype(np.float32)
    ref = pk.fused_bias_gelu(jnp.asarray(x), jnp.asarray(b))
    comp = pk._bias_gelu_xla({}, jnp.asarray(x), jnp.asarray(b))
    got = ck.bias_gelu_plain(_t(x), _t(b))
    _close(ref, got)
    _close(comp, got)


# ----------------------------------------------- flash-decode attention
B, H, DH, C = 4, 2, 64, 256     # C=256 spans two 128-key Pallas blocks


def _decode_inputs(S, cursors, seed=5):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, S, DH).astype(np.float32)
    kc = rs.randn(B, H, C, DH).astype(np.float32)
    vc = rs.randn(B, H, C, DH).astype(np.float32)
    return q, kc, vc, np.asarray(cursors, np.int32)


_CURSORS = {1: [0, C - 1, 127, 128], 4: [0, C - 4, 126, 128]}


@pytest.mark.parametrize("S", [1, 4])
def test_decode_attention_plain_matches_pallas(S):
    """Cursors 0, at capacity's end, and on both sides of the 128-key
    block boundary, staggered across slots."""
    q, kc, vc, pos = _decode_inputs(S, _CURSORS[S])
    ref = pk.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(pos))
    got = ck.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(pos))
    assert got.dtype == torch.float32
    _close(ref, got)


@pytest.mark.parametrize("S", [1, 4])
def test_decode_attention_plain_matches_composition(S):
    """The JAX composition writes this step's rows then reads; the plain
    read over the caches it wrote gives the same output."""
    q, kc, vc, pos = _decode_inputs(S, _CURSORS[S], seed=6)
    rs = np.random.RandomState(7)
    k_new = rs.randn(B, H, S, DH).astype(np.float32)
    v_new = rs.randn(B, H, S, DH).astype(np.float32)
    op = jax_op("attention_decode")
    attrs = op.normalize_attrs({"capacity": C, "per_slot": True})
    (out,), (k2, v2, _cur) = op.forward(
        attrs, [jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new)],
        [jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos[:, None])],
        False, None)
    got = ck.decode_attention_plain(_t(q), _t(np.asarray(k2)),
                                    _t(np.asarray(v2)), _t(pos))
    _close(out, got)


# ------------------------------------------------------ dispatch rules
def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    ck.reset_launch_counts()
    x = torch.randn(4, 64)
    g, b = torch.ones(64), torch.zeros(64)
    y, _m, _r = ck.layernorm(x, g, b, 1e-5)
    torch.testing.assert_close(y, ck.layernorm_plain(x, g, b, 1e-5)[0],
                               rtol=0, atol=0)
    ck.bias_gelu(x, b)
    ck.embedding(torch.tensor([1, 2], dtype=torch.int32), x, 1.0)
    ck.decode_attention(torch.randn(1, 1, 1, 64), torch.randn(1, 1, 8, 64),
                        torch.randn(1, 1, 8, 64),
                        torch.tensor([3], dtype=torch.int32))
    assert ck.launch_counts() == {n: 0 for n in ck.KERNELS}


def test_wrappers_raise_off_cpu_and_cuda():
    """Neither a kernel nor a plain version for another device: raise."""
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(MXNetError):
        ck.bias_gelu(x, torch.empty(64, device="meta"))
    with pytest.raises(MXNetError):
        ck.layernorm(x, torch.empty(64, device="meta"),
                     torch.empty(64, device="meta"), 1e-5)


def test_kernel_ops_carry_cuda_variants():
    """The four kernel-backed ops dispatch to a 'cuda' variant on the
    card; ops without a kernel have none."""
    for name in ("Embedding", "LayerNorm", "FusedBiasGeLU",
                 "attention_decode"):
        assert "cuda" in mxt.ops.get_op(name).variants, name
    for name in ("FullyConnected", "Reshape", "dot", "RoPE"):
        assert not mxt.ops.get_op(name).variants, name
