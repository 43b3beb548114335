"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
CUDA).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain version on the card, at the decode
path's shapes and at edge shapes its code branches on (rows that do not
fill a vector or a tile, head dim 128, windows up to 64, caches that are
not a multiple of the key tile, cursors at both ends). Tolerance: float32
2e-5 (the kernels sum in another order); the gather is exact. A small
model is then decoded on the card and on the CPU through the same
scheduler, and the launch counters must show every kernel ran.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tfm
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serve import FakeClock

TOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _rnd(dev, *shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dev)


def _same(got, ref, tol=TOL):
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d", [(32000, 512), (50, 13), (7, 4)])
def test_embedding_kernel(dev, v, d):
    ids = torch.tensor([0, v - 1, -1, -v, v, -v - 1, 3],
                       dtype=torch.int32, device=dev)
    w = _rnd(dev, v, d)
    for scale in (1.0, float(np.sqrt(d))):
        _same(ck.embedding(ids, w, scale), ck.embedding_plain(ids, w, scale),
              tol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8, 512), (3, 100), (5, 13), (1, 4096)])
def test_layernorm_kernel(dev, n, c):
    x = 3 * _rnd(dev, n, c) + 1
    g, b = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    _same(ck.layernorm(x, g, b, 1e-5), ck.layernorm_plain(x, g, b, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8, 2048), (3, 13), (1, 4)])
def test_bias_gelu_kernel(dev, n, c):
    x, b = 3 * _rnd(dev, n, c), _rnd(dev, c, seed=1)
    _same(ck.bias_gelu(x, b), ck.bias_gelu_plain(x, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S,C", [(1, 256), (16, 256), (17, 100), (64, 64)])
def test_decode_attention_kernel(dev, dh, S, C):
    B, H = 3, 2
    cursors = torch.tensor([0, (C - S) // 2, C - S], dtype=torch.int32,
                           device=dev)
    q = _rnd(dev, B, H, S, dh)
    kc, vc = _rnd(dev, B, H, C, dh, seed=1), _rnd(dev, B, H, C, dh, seed=2)
    _same(ck.decode_attention(q, kc, vc, cursors),
          ck.decode_attention_plain(q, kc, vc, cursors))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(dev):
    q = _rnd(dev, 1, 1, 1, 32)
    kc = _rnd(dev, 1, 1, 8, 32)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(MXNetError, match="head dim"):
        ck.decode_attention(q, kc, kc, pos)
    with pytest.raises(MXNetError, match="float32"):
        ck.bias_gelu(_rnd(dev, 2, 8).half(), _rnd(dev, 8).half())
    with pytest.raises(MXNetError, match="contiguous"):
        ck.layernorm(_rnd(dev, 8, 4).t(), _rnd(dev, 8), _rnd(dev, 8), 1e-5)


@pytest.mark.cuda
def test_small_model_decodes_alike_on_card_and_cpu(dev):
    """Greedy chains through serve_decoder: card (kernels) == CPU (plain
    versions), and every kernel launched on the card."""
    V, D, L, H, CAP = 96, 64, 2, 1, 32
    sym = tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                n_head=H, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(0)
    params = {n: ((1.0 if n.endswith("gamma") else 0.0)
                  + 0.3 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    prompts = [rs.randint(0, V, 5).tolist() for _ in range(3)]
    chains = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        sched = mx.serve.serve_decoder(
            sym, mx.convert.params_from_numpy(params, ctx), ladder=[1, 2, 4],
            clock=FakeClock(), start=False, context=ctx)
        hs = [sched.submit(p, max_new_tokens=8) for p in prompts]
        sched.pump()
        chains[ctx.device_type] = [h.result(timeout=0).tolist() for h in hs]
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            assert all(c > 0 for c in counts.values()), counts
        else:
            assert not any(counts.values()), counts
    assert chains["gpu"] == chains["cpu"]
