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

The LM-training kernels (LayerNorm dx and dgamma/dbeta, the GeLU input
gradient, flash attention) are held against their plain versions at the
LM path's shapes and edge shapes (one row, one column, C = 65536, T = 1
and a ragged T, Dh = 128, non-causal), the parameter-gradient reduction
must repeat bit for bit, each differentiable op's gradients on the card
must match its plain op's on the CPU, and a small LM fits alike on both.

The quantized-serving kernels (the dequant-fused matmul, the conv-weight
row dequant) are held against their plain versions for int8 and
float8_e4m3fn weights that hold +-448 (+-127), e4m3 subnormals, 0 and -0,
at the ResNet-50 serving path's shapes and at edges (M = 1, M = 257,
K = 13, N = 1, N = 1001, one column, 147 columns): the matmul within
1e-5 of the output's largest magnitude (it sums in another order), the
dequant bit for bit. The quantized ops' CUDA variants refuse float16
data and inputs that require grad, and a quantized server on the card
answers with no kernel build after warmup and the CPU server's outputs.
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
@pytest.mark.parametrize("n,c", [(8192, 512), (1, 512), (7, 1), (3, 65536),
                                 (5, 13), (300, 100)])
def test_ln_bwd_kernels(dev, n, c):
    """dx within 2e-5; dgamma / dbeta, sums over N rows, within 1e-4
    absolute and relative (at N = 8192 they reach a few hundred, where
    a float32 ulp is 3e-5)."""
    x = 3 * _rnd(dev, n, c) + 1
    g, b = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    ct = _rnd(dev, n, c, seed=3)
    _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
    _same(ck.layernorm_bwd_dx(x, g, ct, mean, rstd),
          ck.layernorm_bwd_dx_plain(x, g, ct, mean, rstd))
    _same(ck.layernorm_bwd_dparams(x, ct, mean, rstd),
          ck.layernorm_bwd_dparams_plain(x, ct, mean, rstd), tol=1e-4)


@pytest.mark.cuda
def test_ln_bwd_dparams_repeats_bit_for_bit(dev):
    """The two-stage reduction has a fixed order: repeated calls give
    identical bits (no float atomics)."""
    x, ct = _rnd(dev, 8192, 512), _rnd(dev, 8192, 512, seed=1)
    mean = x.mean(1)
    rstd = torch.rsqrt(x.var(1, unbiased=False) + 1e-5)
    first = ck.layernorm_bwd_dparams(x, ct, mean, rstd)
    for _ in range(3):
        again = ck.layernorm_bwd_dparams(x, ct, mean, rstd)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8192, 2048), (3, 13), (1, 4)])
def test_bias_gelu_dx_kernel(dev, n, c):
    x, b = 3 * _rnd(dev, n, c), _rnd(dev, c, seed=1)
    ct = _rnd(dev, n, c, seed=2)
    _same(ck.bias_gelu_dx(x, b, ct), ck.bias_gelu_dx_plain(x, b, ct))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(8, 8, 1024, 64), (2, 2, 1, 64),
                                   (1, 2, 1000, 64), (2, 1, 200, 128),
                                   (1, 1, 64, 128), (1, 3, 65, 64)])
def test_flash_attention_kernel(dev, shape, causal):
    q, k, v = (_rnd(dev, *shape, seed=i) for i in range(3))
    _same(ck.flash_attention(q, k, v, causal),
          ck.flash_attention_plain(q, k, v, causal))


@pytest.mark.cuda
def test_lm_kernels_refuse_what_they_do_not_take(dev):
    q = _rnd(dev, 1, 2, 16, 32)
    with pytest.raises(MXNetError, match="head dim"):
        ck.flash_attention(q, q, q, True)
    q = _rnd(dev, 1, 2, 16, 64)
    with pytest.raises(MXNetError, match="Tq == Tk"):
        ck.flash_attention(q, _rnd(dev, 1, 2, 8, 64), _rnd(dev, 1, 2, 8, 64))
    with pytest.raises(MXNetError, match="float32"):
        ck.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(MXNetError, match="contiguous"):
        t = q.transpose(2, 3)
        ck.flash_attention(t, t, t)
    x = _rnd(dev, 4, 8)
    m = torch.zeros(4, device=dev)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.layernorm_bwd_dx(x.t(), x[0], x.t(), m, m)
    with pytest.raises(MXNetError, match="65536"):
        big = _rnd(dev, 1, 65537)
        ck.layernorm_bwd_dparams(big, big, m[:1], m[:1])
    with pytest.raises(MXNetError, match="float32"):
        ck.bias_gelu_dx(x.half(), x[0].half(), x.half())


_GRAD_CASES = {
    "LayerNorm": (lambda d: [3 * _rnd(d, 4, 64, 512) + 1,
                             _rnd(d, 512, seed=1), _rnd(d, 512, seed=2)],
                  {}, ("layernorm", "ln_bwd_dx", "ln_bwd_dparams")),
    "FusedBiasGeLU": (lambda d: [_rnd(d, 256, 2048), _rnd(d, 2048, seed=1)],
                      {}, ("bias_gelu", "bias_gelu_dx")),
    "Embedding": (lambda d: [torch.tensor([[0, 5, 99, -1], [3, 3, 100, -101]],
                                          dtype=torch.int32, device=d),
                             _rnd(d, 100, 64)],
                  {"input_dim": 100, "output_dim": 64, "scale": 8.0},
                  ("embedding",)),
    "attention": (lambda d: [_rnd(d, 2, 4, 300, 64, seed=i)
                             for i in range(3)],
                  {"causal": True}, ("flash_attention",)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_GRAD_CASES))
def test_op_gradient_on_card(dev, name):
    """The op's CUDA variant with autograd on the card (kernel forward,
    kernel backward where the TPU path has one) against its plain op on
    the CPU: outputs and every input gradient within 1e-4 (the
    parameter gradients sum over up to 1024 rows; the embedding's sums
    with atomics), and the kernels of both directions launched."""
    make, kwargs, kernels = _GRAD_CASES[name]
    op = mx.ops.get_op(name)
    attrs = op.normalize_attrs(kwargs)
    res = {}
    before = ck.launch_counts()
    for where in ("cuda", "cpu"):
        ins = [t.to(where).detach().requires_grad_(t.is_floating_point())
               for t in make(dev)]
        fn = op.variants["cuda"]["fn"] if where == "cuda" else op.forward
        out = fn(attrs, ins, [], True, None)[0][0]
        ct = _rnd(dev, *out.shape, seed=9).to(where)
        torch.where(torch.isfinite(out), out, 0.0).backward(ct)
        res[where] = [out.detach().cpu()] + [
            None if t.grad is None else t.grad.cpu() for t in ins]
    after = ck.launch_counts()
    for k in kernels:
        assert after[k] > before[k], (k, after)
    for a, b in zip(res["cuda"], res["cpu"]):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                       equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_embed", ["rotary", "learned"])
def test_small_lm_fit_alike_on_card_and_cpu(dev, pos_embed):
    """Four SGD batches of a small LM (d_model 128, 2 heads: Dh = 64)
    from the same parameters on the card and on the CPU, TF32 off:
    parameters within 1e-4, and each LM kernel launched its count per
    step on the card (none on the CPU). Learned positions add a second
    embedding gather, over the position ids the graph makes."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _lm_fit_both(pos_embed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _lm_fit_both(pos_embed):
    V, D, L, H, T, B, N = 96, 128, 2, 2, 48, 4, 4
    sym = tfm.get_symbol(V, D, L, H, T, pos_embed=pos_embed)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B * T,))
    rs = np.random.RandomState(0)
    params = {n: ((1.0 if n.endswith("gamma") else 0.0)
                  + 0.1 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    out = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        mod = mx.mod.Module(sym, context=ctx)
        mod.fit(tfm.SyntheticLMIter(V, B, T, N, seed=1), num_epoch=1,
                arg_params=mx.convert.params_from_numpy(params, ctx),
                optimizer="sgd", optimizer_params={"learning_rate": 0.05})
        out[ctx.device_type] = {k: v.asnumpy()
                                for k, v in mod.get_params()[0].items()}
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            want = {"embedding": 1 + (pos_embed == "learned"),
                    "layernorm": 2 * L + 1,
                    "ln_bwd_dx": 2 * L + 1, "ln_bwd_dparams": 2 * L + 1,
                    "bias_gelu": L, "bias_gelu_dx": L,
                    "flash_attention": L, "softmax": 1, "softmax_ce_bwd": 1}
            assert counts == {k: N * want.get(k, 0) for k in counts}, counts
        else:
            assert not any(counts.values()), counts
    for k, v in out["cpu"].items():
        assert np.abs(v - params[k]).max() > 0, k
        np.testing.assert_allclose(out["gpu"][k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


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


# --------------------------------------------------- quantized serving
def _quant_weight(dev, n, k, storage, seed=0):
    """(n, k) weight in ``storage`` (torch.int8 or float8_e4m3fn) holding
    random codes plus the extremes, the e4m3 subnormals, 0 and -0."""
    rs = np.random.RandomState(seed)
    if storage == torch.int8:
        codes = rs.randint(-128, 128, n * k)
        edge = [127, -127, -128, 0]
        codes[:min(4, codes.size)] = edge[:codes.size]
        return torch.as_tensor(codes.astype(np.int8)).reshape(n, k).to(dev)
    vals = (rs.randn(n * k) * 40).clip(-448, 448).astype(np.float32)
    edge = np.asarray([448.0, -448.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -7,
                       7 * 2.0 ** -9, 0.0, -0.0], np.float32)
    vals[:min(len(edge), vals.size)] = edge[:vals.size]
    return torch.as_tensor(vals).reshape(n, k).to(torch.float8_e4m3fn) \
        .to(dev)


_QSTORAGE = [torch.int8, torch.float8_e4m3fn]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (1, 2048, 1000),
                                   (257, 64, 33), (5, 13, 7), (3, 300, 1),
                                   (4, 64, 1001), (2, 4, 4)])
def test_qfc_matmul_kernel(dev, storage, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rnd(dev, m, k)
    w = _quant_weight(dev, n, k, storage)
    s = _rnd(dev, n, seed=1).abs() / 100 + 1e-3
    got, ref = ck.qfc_matmul(x, w, s), ck.qfc_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
@pytest.mark.parametrize("rows,cols", [(512, 4608), (2048, 512), (64, 147),
                                       (3, 1), (5, 13), (1000, 4)])
def test_dequant_rows_kernel_bitwise(dev, storage, rows, cols):
    w = _quant_weight(dev, rows, cols, storage)
    s = _rnd(dev, rows, seed=1).abs() / 100 + 1e-3
    got, ref = ck.dequant_rows(w, s), ck.dequant_rows_plain(w, s)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    # a row view that starts off a 4-byte boundary takes the scalar path
    w2 = w.reshape(-1)[1:1 + (rows - 1) * cols].reshape(rows - 1, cols) \
        if rows > 1 else w
    s2 = s[:w2.shape[0]]
    assert torch.equal(ck.dequant_rows(w2, s2).view(torch.int32),
                       ck.dequant_rows_plain(w2, s2).view(torch.int32))
    if storage == torch.int8:
        # one PyTorch call computes the same function: int8 x float32
        # promotes to float32 and rounds each product once
        lib = torch.mul(w, s.unsqueeze(1))
        assert torch.equal(got.view(torch.int32), lib.view(torch.int32))


@pytest.mark.cuda
def test_quantized_variants_refuse_what_they_do_not_take(dev):
    qfc = mx.ops.get_op("QuantizedFullyConnected")
    qcv = mx.ops.get_op("QuantizedConvolution")
    fattrs = qfc.normalize_attrs({"num_hidden": 4, "no_bias": True})
    cattrs = qcv.normalize_attrs({"kernel": (3, 3), "num_filter": 4,
                                  "no_bias": True})
    w = _quant_weight(dev, 4, 8, torch.int8)
    s = torch.ones(4, device=dev)
    wc = _quant_weight(dev, 4, 18, torch.int8).reshape(4, 2, 3, 3)
    with pytest.raises(MXNetError, match="float32"):
        mx.ops.registry.dispatch(qfc, fattrs, [_rnd(dev, 2, 8).half(), w, s],
                                 [], False, None)
    with pytest.raises(MXNetError, match="float32"):
        mx.ops.registry.dispatch(qcv, cattrs,
                                 [_rnd(dev, 1, 2, 5, 5).half(), wc, s], [],
                                 False, None)
    x = _rnd(dev, 2, 8).requires_grad_(True)
    with pytest.raises(MXNetError, match="inference tier"):
        mx.ops.registry.dispatch(qfc, fattrs, [x, w, s], [], False, None)
    with pytest.raises(MXNetError, match="int8 or torch.float8_e4m3fn"):
        ck.qfc_matmul(_rnd(dev, 2, 8), w.float(), s)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.dequant_rows(_quant_weight(dev, 8, 4, torch.int8).t(), s)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_quantized_server_on_card(dev, tier):
    """A small convnet served through mx.serve.serve on gpu(0) and on the
    CPU from the same parameters: the same outputs (TF32 off), no kernel
    build after warmup, and exactly one dequant per conv and one fused
    matmul per dense layer on every card forward."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        data = mx.sym.var("data")
        c = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                               pad=(1, 1), name="c1")
        a = mx.sym.Activation(c, act_type="relu")
        f = mx.sym.FullyConnected(a, num_hidden=10, name="f1")
        sym = mx.sym.SoftmaxOutput(f, name="softmax")
        rs = np.random.RandomState(0)
        shapes, _, _ = sym.infer_shape(data=(4, 3, 8, 8))
        params = {n: (0.2 * rs.randn(*sh)).astype(np.float32)
                  for n, sh in zip(sym.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        x = rs.rand(3, 3, 8, 8).astype(np.float32)
        outs = {}
        for ctx in (mx.gpu(0), mx.cpu()):
            mod = mx.mod.Module(sym, context=ctx)
            mod.bind([("data", (4, 3, 8, 8))], [("softmax_label", (4,))],
                     for_training=False)
            mod.init_params(arg_params=mx.convert.params_from_numpy(params,
                                                                    ctx),
                            aux_params={})
            ck.reset_launch_counts()
            server = mx.serve.serve(mod, ladder=[1, 2, 4], compute_dtype=tier,
                                    clock=FakeClock(), start=False)
            warm = ck.launch_counts()
            h = server.submit({"data": x})
            server.pump()
            server._clock.advance(1.0)
            server.pump()
            outs[ctx.device_type] = h.result(timeout=0)[0].asnumpy()
            counts = ck.launch_counts()
            assert server.stats()["compiles_since_warmup"] == 0
            assert h.bucket == 4
            if ctx.device_type == "gpu":
                assert warm["dequant_rows"] == warm["qfc_matmul"] == 6
                assert counts["dequant_rows"] == counts["qfc_matmul"] == 7
            else:
                assert not any(counts.values()), counts
            server.stop()
        np.testing.assert_allclose(outs["gpu"], outs["cpu"], atol=1e-5,
                                   rtol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
