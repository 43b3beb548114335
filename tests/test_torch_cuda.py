"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
CUDA).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain version on the card, at the decode
and training paths' shapes and at edge shapes its code branches on (rows
that do not fill a vector or a tile, head dim 128, windows up to 64,
caches that are not a multiple of the key tile, cursors at both ends;
softmax rows of 1 and 65536 classes, labels outside the classes and
ignored rows; update lengths that are not a multiple of the block).
Tolerance: float32 2e-5 (the kernels sum in another order); the gather
and the elementwise updates, which round as their plain versions do, are
held to 1e-6. A small model is then decoded on the card and on the CPU
through the same scheduler, an MLP and a LeNet are fitted on both, and
the launch counters must show every kernel ran.
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
    versions), and every decode kernel launched on the card (and no
    training kernel)."""
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
        decode = ("embedding", "layernorm", "bias_gelu", "decode_attention")
        if ctx.device_type == "gpu":
            assert all(counts[k] > 0 for k in decode), counts
            assert not any(v for k, v in counts.items() if k not in decode)
        else:
            assert not any(counts.values()), counts
    assert chains["gpu"] == chains["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(32, 1000), (1, 7), (5, 1), (3, 1025),
                                 (2, 65536), (70, 33)])
def test_softmax_kernel(dev, n, c):
    x = 4 * _rnd(dev, n, c)
    _same(ck.softmax(x), ck.softmax_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_ce_bwd_kernel(dev, use_ignore):
    n, c = 6, 1000
    p = torch.softmax(_rnd(dev, n, c), dim=1)
    label = torch.tensor([0, 999, -1, 1000, 5, 3.7], device=dev)
    for scale in (1.0, 1 / n):
        _same(ck.softmax_ce_bwd(p, label, scale, use_ignore, -1.0),
              ck.softmax_ce_bwd_plain(p, label, scale, use_ignore, -1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_softmax_output_op_on_card(dev, norm):
    """The op's CUDA variant (kernel forward, kernel backward) against
    its plain path on the same inputs, gradient included."""
    from mxnet_tpu_torch.ops.loss import softmax_output
    op = mx.ops.get_op("SoftmaxOutput")
    attrs = op.normalize_attrs({"normalization": norm, "use_ignore": True,
                                "ignore_label": 2.0})
    x = _rnd(dev, 8, 10)
    label = torch.tensor([0, 2, 9, 2, 1, 11, 3, 4], dtype=torch.float32,
                         device=dev)
    before = ck.launch_counts()
    grads = []
    for run in ("kernel", "plain"):
        xx = x.clone().requires_grad_(True)
        if run == "kernel":
            (prob,), _ = op.variants["cuda"]["fn"](attrs, [xx, label], [],
                                                   True, None)
        else:
            prob = softmax_output(xx, label, attrs)
        prob.backward(torch.ones_like(prob))
        grads.append((prob.detach(), xx.grad))
    _same(grads[0], grads[1])
    after = ck.launch_counts()
    assert after["softmax"] == before["softmax"] + 1
    assert after["softmax_ce_bwd"] == before["softmax_ce_bwd"] + 1
    with pytest.raises(MXNetError, match="multi_output"):
        op.variants["cuda"]["fn"](op.normalize_attrs({"multi_output": True}),
                                  [x.reshape(8, 10, 1), label[:, None]], [],
                                  False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 2048 * 1000, 1000003])
@pytest.mark.parametrize("clip", [-1.0, 0.01])
def test_sgd_mom_kernel(dev, n, clip):
    w, g, m = _rnd(dev, n), _rnd(dev, n, seed=1), _rnd(dev, n, seed=2)
    want = ck.sgd_mom_update_plain(w, g, m, 0.1, 0.9, 1e-4, 1 / 32, clip)
    got = ck.sgd_mom_update(w.clone(), g, m.clone(), 0.1, 0.9, 1e-4, 1 / 32,
                            clip)
    _same(got, want, tol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 1000003])
def test_adam_kernel(dev, n):
    w, g, mean = _rnd(dev, n), _rnd(dev, n, seed=1), _rnd(dev, n, seed=2)
    var = _rnd(dev, n, seed=3).abs()
    args = (1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.5, 0.3)
    want = ck.adam_update_plain(w, g, mean, var, *args)
    got = ck.adam_update(w.clone(), g, mean.clone(), var.clone(), *args)
    _same(got, want, tol=1e-6)


@pytest.mark.cuda
def test_training_kernels_refuse_what_they_do_not_take(dev):
    x = _rnd(dev, 4, 8)
    with pytest.raises(MXNetError, match="float32"):
        ck.softmax(x.double())
    with pytest.raises(MXNetError, match="65536"):
        ck.softmax(_rnd(dev, 1, 65537))
    with pytest.raises(MXNetError, match="float32"):
        ck.softmax_ce_bwd(x, torch.zeros(4, dtype=torch.int64, device=dev),
                          1.0)
    with pytest.raises(MXNetError, match="shape"):
        ck.sgd_mom_update(x, x[:2], x, 0.1)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.adam_update(x.t(), x.t(), x.t(), x.t(), 0.1)


@pytest.mark.cuda
def test_layernorm_variant_raises_under_grad(dev):
    """A kernel without its backward yet refuses to run on inputs that
    require grad (its output would carry no gradient)."""
    op = mx.ops.get_op("LayerNorm")
    x = _rnd(dev, 4, 16).requires_grad_(True)
    g, b = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    from mxnet_tpu_torch.ops.registry import dispatch
    with pytest.raises(MXNetError, match="_ln_bwd_dx_kernel"):
        dispatch(op, op.normalize_attrs({}), [x, g, b], [], True, None)
    with torch.no_grad():
        dispatch(op, op.normalize_attrs({}), [x, g, b], [], False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("model,optimizer", [("mlp", "sgd"),
                                             ("lenet", "sgd"),
                                             ("mlp", "adam")])
def test_small_fit_alike_on_card_and_cpu(dev, model, optimizer):
    """Two epochs of 4 batches from the same parameters on the card and
    on the CPU: weights within 1e-4 (convolutions and matmuls round in
    other orders; TF32 is off for the comparison), and the card run
    launched its training kernels."""
    from mxnet_tpu_torch import models
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _fit_both(models, model, optimizer)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _fit_both(models, model, optimizer):
    rs = np.random.RandomState(0)
    X = rs.rand(32, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.float32)
    sym = getattr(models, model).get_symbol(10)
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4} \
        if optimizer == "sgd" else {"learning_rate": 1e-3}
    out = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        mod = mx.mod.Module(sym, context=ctx)
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
                initializer=mx.initializer.Xavier(), optimizer=optimizer,
                optimizer_params=opt)
        out[ctx.device_type] = {k: v.asnumpy()
                                for k, v in mod.get_params()[0].items()}
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            upd = "sgd_mom" if optimizer == "sgd" else "adam"
            n_params = len(out["gpu"])
            assert counts["softmax"] == counts["softmax_ce_bwd"] == 8
            assert counts[upd] == 8 * n_params, counts
        else:
            assert not any(counts.values()), counts
    for k, v in out["cpu"].items():
        np.testing.assert_allclose(out["gpu"][k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
