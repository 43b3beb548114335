"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
CUDA).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain version on the card, at the decode
and training paths' shapes and at edge shapes its code branches on (rows
that do not fill a vector or a tile, head dim 128, windows up to 64,
caches that are not a multiple of the key tile, cursors at both ends,
float32 and fp8 (float8_e4m3fn, float8_e5m2) caches, NaN cells;
softmax rows of 1 and 65536 classes, labels outside the classes and
ignored rows; update lengths that are not a multiple of the block).
The decode read splits each row's key range over blocks: every instance
(float32, bfloat16, float16, float8_e4m3fn, float8_e5m2) against its
plain version at the card's split edges (cursors 0, a split's last key,
the next split's first key, C - S) for C 64, 256 and 4096 and S 1, 16
and 64; two calls bit for bit with the workspace's counters back at 0;
the float32 kernel against ``tests/decode_split_emul.py``, the same
splits merged in the same order on the CPU.
Tolerance: float32 2e-5 (the kernels sum in another order); the gather
and the elementwise updates, which round as their plain versions do, are
held to 1e-6. The decode kernels' bfloat16 instances: the gather bit for
bit, LayerNorm and GeLU within one bfloat16 ulp beyond 2e-5, the
decode read (float32 out) within 2e-5; a small model served in bfloat16
on the card and the CPU within 2e-2, with exact launch counts. A small model is then decoded on the card and on the CPU
through the same scheduler (and again with chunked prefill, speculative
decoding, the prefix store and an fp8 cache), an MLP and a LeNet are
fitted on both, and the launch counters must show every kernel ran.

The LM-training kernels (LayerNorm dx and dgamma/dbeta, the GeLU input
gradient, flash attention) are held against their plain versions at the
LM path's shapes and edge shapes (one row, one column, C = 65536, the
LayerNorm backward's register-route limit C = 1024 +-1, T = 1 and a
ragged T, Dh = 128, non-causal); the LayerNorm backward's one call
(``layernorm_bwd``: dx, dgamma and dbeta) and its single-half wrappers,
the same kernel with one half off, must agree bit for bit, its
instances must not spill, and the parameter-gradient reduction
must repeat bit for bit; each differentiable op's gradients on the card
must match its plain op's on the CPU, and a small LM fits alike on both.
Their bfloat16 instances are held the same way in bfloat16 ulps (one
beyond 2e-5; the parameter sums one beyond 1e-4), aligned and on
misaligned views, with only the bfloat16 counters moving (flash
attention also at T on both sides of its 16-bit tiles, and its SASS
must hold HGMMA, wgmma on the tensor cores, in every 16-bit instance of
both modes and none in the float32 ones, with no spills); the ops'
gradients in bfloat16 on the card against the CPU's, and a small LM's
bfloat16 fit (ids and labels past 256) against the CPU's within three
times the CPU's own bfloat16-vs-float32 distance.

Every test of a bfloat16 instance or path runs for the float16 instance
or path too (parameter ``half``), its limits in ulps of its type or
eight times finer where they are absolute (probabilities 2.5e-3; float16
decode logits within two float16 ulps of the largest); the update
kernels refuse half gradients, naming their later slice, and every
kernel refuses a dtype no instance takes, naming it.

The quantized-serving kernels (the dequant-fused matmul, the conv-weight
row dequant) are held against their plain versions for int8 and
float8_e4m3fn weights that hold +-448 (+-127), e4m3 subnormals, 0 and -0,
at the ResNet-50 serving path's shapes and at edges (M = 1, M = 257,
K = 13, N = 1, N = 1001, one column, 147 columns): the matmul within
1e-5 of the output's largest magnitude (it sums in another order), the
dequant bit for bit; the matmul's bfloat16 and float16 instances the
same way, and a quantized Module under ``compute_dtype`` card vs CPU.
The quantized ops' CUDA variants refuse float64 data, an fp8 weight
widened to the compute dtype, and inputs that require grad, and a
quantized server on the card answers with no kernel build after warmup
and the CPU server's outputs.

User kernels (``mx.rtc``): an ``Rtc`` push with and without launch
dims, bit for bit against ``torch.add``; a ``register_cuda_op`` ReLU
whose forward and VJP kernels equal ``torch.relu`` and its
``threshold_backward`` bit for bit (zeros included), under
``mx.autograd`` and in an executor against the CPU's reference; the
refusal of an op without a VJP kernel in a training forward; bfloat16
and int32 signatures. CustomOps on CUDA
tensors (an NDArray body on the device, the numpy softmax head against
``SoftmaxOutput``) and ``mx.autograd`` over convolutions on the card
against the CPU, TF32 off (1e-4: cuDNN and oneDNN sum in other orders).

The remaining nn layers: ``ROIPooling`` at Fast R-CNN's shape
(equal to the CPU, its backward's peak allocation under 1 GiB beyond the
inputs), ``Deconvolution`` with ``adj`` at or past the stride and padding
past k - 1, ``Crop``'s clamped offsets, ``rrelu``'s slopes bit for bit
against the CPU, and one DCGAN iteration through two Modules card vs CPU
(``chip_smoke.dcgan_parity``) with one ``adam_multi`` launch an update.

The contrib ops (plain PyTorch on the card): ``MultiBoxDetection`` and
``MultiProposal`` twice bit for bit (their NMS loops, stable sorts) and
the CPU's ids; ``MultiBoxTarget``'s forced match with label rows that pick
the same anchor, the CPU's every run; ``count_sketch`` within 1e-6 of its
largest magnitude (``index_add_`` adds in no fixed order); CTC's loss
within 2e-5 and its gradient as near the CPU's float64 one as 3 times the
CPU's float32 gradient is.
"""
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tfm
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.rtc import fp8_cast
from mxnet_tpu_torch.serve import FakeClock

from bn_stats_emul import bn_stats_emul
from decode_split_emul import decode_attention_split
from qfc_gemv_emul import qfc_gemv

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


#: LayerNorm shapes: the decode and LM rows, the register route's limit
#: +-1 (C = 1024), C = 1, odd C, N = 1, and a walked row
LN_SHAPES = [(8, 512), (8192, 512), (3, 100), (5, 13), (1, 4096), (2, 1023),
             (2, 1024), (2, 1025), (4, 1), (1, 512)]
#: softmax shapes: each route's limits +-1 (one warp to C = 1024, one block
#: to 32768 with 16-byte units and 16384 without, a cluster to 65536), the
#: ResNet-50 head, the LM head's C = 32000 at N = 64, C = 1, odd C, N = 1
SOFTMAX_SHAPES = [(32, 1000), (1, 7), (5, 1), (70, 33), (3, 1023), (2, 1024),
                  (3, 1025), (2, 16383), (2, 16384), (2, 16385), (2, 32767),
                  (2, 32768), (2, 32769), (64, 32000), (2, 65536)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", LN_SHAPES)
def test_layernorm_kernel(dev, n, c):
    """y, mean and rstd within 2e-5 of the plain version; the op's std,
    written by the same launch, is 1 / rstd bit for bit."""
    x = 3 * _rnd(dev, n, c) + 1
    g, b = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    _same(ck.layernorm(x, g, b, 1e-5), ck.layernorm_plain(x, g, b, 1e-5))
    _, stats = ck.layernorm_stats(x, g, b, 1e-5)
    assert torch.equal(stats[2], 1.0 / stats[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fused_layernorm_launches_one_kernel_for_all_outputs(dev, dtype):
    """The LayerNorm op's (out, mean, std) from one kernel launch, with
    and without a gradient recorded: std equals 1 / rstd bit for bit and
    the op's outputs match the plain composition's."""
    x = (3 * _rnd(dev, 2, 3, 64) + 1).to(dtype)
    g = _rnd(dev, 64, seed=1).to(dtype)
    b = _rnd(dev, 64, seed=2).to(dtype)
    sfx = {torch.float32: "", torch.bfloat16: "_bf16",
           torch.float16: "_f16"}[dtype]
    for grad in (False, True):
        gg = g.clone().requires_grad_(grad)
        before = ck.launch_counts()["layernorm" + sfx]
        y, mean, std = ck.fused_layernorm(x, gg, b, 1e-5)
        assert ck.launch_counts()["layernorm" + sfx] == before + 1
        _, pmean, prstd = ck.layernorm_plain(x.reshape(-1, 64), g, b, 1e-5)
        _, stats = ck.layernorm_stats(x, g, b, 1e-5)
        assert torch.equal(std, 1.0 / stats[1])
        assert std.shape == mean.shape == (2, 3) and y.shape == x.shape
        _same((mean.reshape(-1), (1.0 / std).reshape(-1)), (pmean, prstd))
        assert y.requires_grad == grad


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8, 2048), (3, 13), (1, 4)])
def test_bias_gelu_kernel(dev, n, c):
    x, b = 3 * _rnd(dev, n, c), _rnd(dev, c, seed=1)
    _same(ck.bias_gelu(x, b), ck.bias_gelu_plain(x, b))


#: every head dim the attention kernels take: the Dh 32, 64 and 128 tiles'
#: own and the multiples of 16 between them, which run on the next tile
HEAD_DIMS = [16, 32, 48, 64, 80, 96, 112, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("S,C", [(1, 256), (16, 256), (17, 100), (64, 64)])
def test_decode_attention_kernel(dev, dh, S, C):
    B, H = 3, 2
    cursors = torch.tensor([0, (C - S) // 2, C - S], dtype=torch.int32,
                           device=dev)
    q = _rnd(dev, B, H, S, dh)
    kc, vc = _rnd(dev, B, H, C, dh, seed=1), _rnd(dev, B, H, C, dh, seed=2)
    _same(ck.decode_attention(q, kc, vc, cursors),
          ck.decode_attention_plain(q, kc, vc, cursors))


_FP8 = [torch.float8_e4m3fn, torch.float8_e5m2]


def _fp8_cache(dev, shape, dtype, seed):
    """Random fp8 cells, cast as the decode path casts them on write."""
    return fp8_cast(3 * _rnd(dev, *shape, seed=seed), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _FP8, ids=["e4m3", "e5m2"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("S,C", [(1, 256), (4, 256), (64, 256), (17, 100)])
def test_decode_attention_fp8_kernel(dev, dtype, dh, S, C):
    """The fp8 instances against the plain read of the same cells, at
    cursors 0, mid and C - S; a reused slot (cursor back at 0 over stale
    rows) is the cursor-0 row."""
    B, H = 3, 2
    cursors = torch.tensor([0, (C - S) // 2, C - S], dtype=torch.int32,
                           device=dev)
    q = _rnd(dev, B, H, S, dh)
    kc, vc = (_fp8_cache(dev, (B, H, C, dh), dtype, seed)
              for seed in (1, 2))
    before = dict(ck.launch_counts())
    _same(ck.decode_attention(q, kc, vc, cursors),
          ck.decode_attention_plain(q, kc, vc, cursors))
    counts = ck.launch_counts()
    assert counts["decode_attention_fp8"] == \
        before["decode_attention_fp8"] + 1
    assert counts["decode_attention"] == before["decode_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32] + _FP8,
                         ids=["f32", "e4m3", "e5m2"])
def test_decode_attention_nan_cells_pass_through(dev, dtype):
    """A NaN K cell in a row's live prefix makes that row NaN, a NaN V
    cell that column, as in the plain softmax; other rows are untouched."""
    B, H, S, C, dh = 3, 2, 4, 64, 64
    cursors = torch.tensor([10, 20, 30], dtype=torch.int32, device=dev)
    q = _rnd(dev, B, H, S, dh)
    kc = _rnd(dev, B, H, C, dh, seed=1)
    vc = _rnd(dev, B, H, C, dh, seed=2)
    kc[1, 0, 5, 3] = float("nan")
    vc[2, 1, 7, 9] = float("nan")
    if dtype != torch.float32:
        kc, vc = fp8_cast(kc, dtype), fp8_cast(vc, dtype)
    got = ck.decode_attention(q, kc, vc, cursors)
    _same(got, ck.decode_attention_plain(q, kc, vc, cursors))
    assert got[1, 0].isnan().all() and got[2, 1, :, 9].isnan().all()
    assert not got[0].isnan().any()


#: the decode read's instances: cache dtype, query dtype, counter
DECODE_INSTANCES = {
    "f32": (torch.float32, torch.float32, "decode_attention"),
    "bf16": (torch.bfloat16, torch.bfloat16, "decode_attention_bf16"),
    "f16": (torch.float16, torch.float16, "decode_attention_f16"),
    "e4m3": (torch.float8_e4m3fn, torch.float32, "decode_attention_fp8"),
    "e5m2": (torch.float8_e5m2, torch.float32, "decode_attention_fp8"),
}


def _split_inputs(dev, inst, B, H, S, C, dh, seed=0):
    """q, caches and cursors at the card's split edges: 0, a split's last
    key, the next split's first key, C - S (B a multiple of 4)."""
    cache_dt, q_dt, _ = DECODE_INSTANCES[inst]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, keys = ck._decode_splits(B * H, S, C, sms)
    cur = [0, min(keys - 1, C - 1), min(keys, C - 1), max(C - S, 0)] * \
        (B // 4)
    q = _rnd(dev, B, H, S, dh, seed=seed).to(q_dt)
    kc, vc = ((2 * _rnd(dev, B, H, C, dh, seed=seed + i)).to(cache_dt)
              if cache_dt in (torch.float32, torch.bfloat16, torch.float16)
              else fp8_cast(2 * _rnd(dev, B, H, C, dh, seed=seed + i),
                            cache_dt) for i in (1, 2))
    return q, kc, vc, torch.tensor(cur, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 16, 64])
@pytest.mark.parametrize("C", [64, 256, 4096])
@pytest.mark.parametrize("inst", list(DECODE_INSTANCES))
def test_decode_attention_split_kernel(dev, inst, C, S, dh):
    """Every instance against the plain read at the split edges of the
    card's plan (``_decode_splits``), one launch counted on its counter;
    float32 out within 2e-5 (the values are widened exactly)."""
    q, kc, vc, pos = _split_inputs(dev, inst, 4, 2, S, C, dh)
    counter = DECODE_INSTANCES[inst][2]
    before = ck.launch_counts()[counter]
    got = ck.decode_attention(q, kc, vc, pos)
    assert ck.launch_counts()[counter] == before + 1
    assert got.dtype == torch.float32
    _same(got, ck.decode_attention_plain(q, kc, vc, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(1, 256), (1, 4096), (16, 256), (64, 256),
                                 (3, 100)])
@pytest.mark.parametrize("inst", list(DECODE_INSTANCES))
def test_decode_attention_repeats_bit_for_bit(dev, inst, S, C):
    """Two calls give the same bits (the splits merge in a fixed order,
    no float atomics), and the workspace's counters are back at 0."""
    q, kc, vc, pos = _split_inputs(dev, inst, 8, 8, S, C, 64, seed=3)
    a = ck.decode_attention(q, kc, vc, pos)
    b = ck.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    splits, _ = ck._decode_splits(
        64, S, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    if splits > 1:
        tiles = 1 if S == 1 else -(-S // 16)
        counters = ck._DECODE_WS[(dev.index or 0, torch.cuda.current_stream(
            dev).cuda_stream)][1]
        assert not counters[:64 * tiles].any()


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,dh", [(1, 256, 64), (1, 4096, 128),
                                    (16, 256, 64), (64, 256, 128),
                                    (1, 256, 32), (64, 256, 32),
                                    (3, 100, 32), (1, 256, 16),
                                    (64, 256, 48), (1, 4096, 80),
                                    (16, 256, 96), (3, 100, 112)])
def test_decode_attention_matches_split_emulation(dev, S, C, dh):
    """The float32 kernel against ``tests/decode_split_emul.py``, the
    same splits in the same order on the CPU, within 2e-5."""
    q, kc, vc, pos = _split_inputs(dev, "f32", 4, 2, S, C, dh, seed=5)
    got = ck.decode_attention(q, kc, vc, pos)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = decode_attention_split(q.cpu(), kc.cpu(), vc.cpu(), pos.cpu(),
                                  sms)
    _same(got.cpu(), want)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(dev):
    """Refused: an empty head dim, mixed cache types, a query or cache
    dtype no instance takes, non-contiguous rows. Head dims 24, 144 and 8,
    a cache 1 byte off 16 and a 65-row window run (their routes: narrow
    copies, the wide route, more query tiles) and match the plain
    version."""
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    for dh in (24, 144, 8):
        q = _rnd(dev, 1, 1, 1, dh)
        for kc in (_rnd(dev, 1, 1, 8, dh),
                   fp8_cast(_rnd(dev, 1, 1, 8, dh), torch.float8_e4m3fn)):
            _same(ck.decode_attention(q, kc, kc, pos),
                  ck.decode_attention_plain(q, kc, kc, pos))
    with pytest.raises(MXNetError, match="head dim 0"):
        z = _rnd(dev, 1, 1, 1, 0)
        ck.decode_attention(z, z, z, pos)
    q64 = _rnd(dev, 1, 1, 1, 64)
    flat = fp8_cast(_rnd(dev, 1 + 9 * 64), torch.float8_e5m2)
    k8 = flat[:9 * 64].view(1, 1, 9, 64)
    shifted = flat[1:1 + 8 * 64].view(1, 1, 8, 64)    # 1 byte off
    _same(ck.decode_attention(q64, shifted, shifted, pos),
          ck.decode_attention_plain(q64, shifted, shifted, pos))
    with pytest.raises(MXNetError, match="float8_e5m2"):
        ck.decode_attention(q64, k8[:, :, :8], _rnd(dev, 1, 1, 8, 64), pos)
    q65 = _rnd(dev, 1, 1, 65, 64)
    _same(ck.decode_attention(q65, k8[:, :, :8], k8[:, :, :8], pos),
          ck.decode_attention_plain(q65, k8[:, :, :8], k8[:, :, :8], pos))
    with pytest.raises(MXNetError, match="want float8"):
        ck.decode_attention_fp8(q64, _rnd(dev, 1, 1, 8, 64),
                                _rnd(dev, 1, 1, 8, 64), pos)
    with pytest.raises(MXNetError, match="float32"):
        ck.bias_gelu(_rnd(dev, 2, 8).double(), _rnd(dev, 8).double())
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
@pytest.mark.parametrize("cache_dtype", [None, "fp8"])
def test_small_model_fast_paths_alike_on_card_and_cpu(dev, cache_dtype):
    """Chunked prefill (S=4 windows), speculative decoding (a 1-layer
    draft, spec_k 3) and the prefix store through serve_decoder, with a
    live slot migrated between rungs: greedy chains card == CPU, 3 of 4
    prefix hits on both, and on the card the decode read of the cache
    dtype launched (the fp8 instances count in
    ``decode_attention_fp8``)."""
    V, D, H, CAP = 96, 64, 1, 32

    def gen(n_layer):
        return lambda s: tfm.get_decode_symbol(
            vocab_size=V, d_model=D, n_layer=n_layer, n_head=H,
            capacity=CAP, per_slot=True, step_len=s, cache_dtype=cache_dtype)
    rs = np.random.RandomState(0)

    def params(n_layer):
        sym = gen(n_layer)(1)
        shapes, _, _ = sym.infer_shape(data=(1, 1))
        return {n: ((1.0 if n.endswith("gamma") else 0.0)
                    + 0.3 * rs.randn(*s)).astype(np.float32)
                for n, s in zip(sym.list_arguments(), shapes)
                if n != "data"}
    target, draft = params(2), params(1)
    shared = rs.randint(0, V, 7).tolist()
    prompts = [shared + [int(t)] for t in rs.randint(0, V, 4)]
    chains, hits = {}, {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        sched = mx.serve.serve_decoder(
            gen(2)(1), mx.convert.params_from_numpy(target, ctx),
            ladder=[1, 2, 4], clock=FakeClock(), start=False, context=ctx,
            symbol_gen=gen(2), prefill_chunk=4, draft_symbol_gen=gen(1),
            draft_params=mx.convert.params_from_numpy(draft, ctx),
            spec_k=3, prefix_cache_mb=1)
        first = sched.submit(prompts[0], max_new_tokens=6, prefix_id="p")
        sched.pump(max_iterations=2)     # prefilled and stored, still live
        hs = [first] + [sched.submit(p, max_new_tokens=6, prefix_id="p")
                        for p in prompts[1:]]
        sched.pump()
        chains[ctx.device_type] = [h.result(timeout=0).tolist() for h in hs]
        hits[ctx.device_type] = sched.stats()["prefix"]["hits"]
        assert sched.stats()["migrations"] >= 1    # a live slot moved
        counts = ck.launch_counts()
        read = "decode_attention_fp8" if cache_dtype else "decode_attention"
        if ctx.device_type == "gpu":
            assert counts[read] > 0, counts
            other = ({"decode_attention", "decode_attention_fp8"} - {read})
            assert not any(counts[k] for k in other), counts
    assert chains["gpu"] == chains["cpu"]
    assert hits["gpu"] == hits["cpu"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", SOFTMAX_SHAPES)
def test_softmax_kernel(dev, n, c):
    """Within 2e-5 of the plain version, aligned and on a view one value
    off its allocation (one value at a time)."""
    for x in (4 * _rnd(dev, n, c), (4 * _rnd(dev, n * c + 1))[1:].view(n, c)):
        _same(ck.softmax(x), ck.softmax_plain(x))


@pytest.mark.cuda
def test_wrappers_raise_as_they_did(dev):
    """The launch path's checks keep their errors and messages: a CPU
    input, a dtype no instance takes or that differs from the data's, a
    non-contiguous input."""
    x, g = _rnd(dev, 4, 8), _rnd(dev, 8)
    cases = [
        (lambda: ck.layernorm(x, g.cpu(), g, 1e-5),
         "layernorm: gamma is on cpu, the kernel needs a CUDA tensor"),
        (lambda: ck.layernorm(x, g, g.double(), 1e-5),
         "layernorm: beta is torch.float64, the kernel takes torch.float32"),
        (lambda: ck.layernorm(x.double(), g.double(), g.double(), 1e-5),
         "layernorm: no kernel instance takes torch.float64 data; it has "
         "torch.bfloat16, torch.float16, torch.float32"),
        (lambda: ck.layernorm(_rnd(dev, 8, 4).t(), g, g, 1e-5),
         "layernorm: x must be contiguous"),
        (lambda: ck.softmax(_rnd(dev, 8, 4).t()),
         "softmax: x must be contiguous"),
        (lambda: ck.softmax(x.double()),
         "softmax: no kernel instance takes torch.float64 data; it has "
         "torch.bfloat16, torch.float16, torch.float32"),
        (lambda: ck.softmax_ce_bwd(x, torch.zeros(4), 1.0),
         "softmax_ce_bwd: label is on cpu, the kernel needs a CUDA tensor"),
        (lambda: ck.bias_gelu(x, g.to(torch.bfloat16)),
         "bias_gelu: bias is torch.bfloat16, the kernel takes "
         "torch.float32"),
    ]
    for call, message in cases:
        with pytest.raises(MXNetError) as err:
            call()
        assert str(err.value) == message


@pytest.mark.cuda
def test_row_kernels_do_not_spill(dev):
    """ptxas' report shows 0 bytes of spill stores and loads for every
    softmax and LayerNorm instance: their rows live in registers."""
    for lib in ("softmax", "layernorm"):
        res = {fn: r for fn, r in ck.resources(lib).items()
               if "registers" in r}
        assert len(res) >= (30 if lib == "softmax" else 24), sorted(res)
        for fn, r in res.items():
            assert r["spill_stores"] == r["spill_loads"] == 0, fn
            assert r["registers"] <= (64 if "softmax_block" in fn else 255)


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
    # multi_output: the same two kernels over (N * d..., C)
    mattrs = op.normalize_attrs({"multi_output": True})
    xm = x.reshape(8, 10, 1)
    (pm,), _ = op.variants["cuda"]["fn"](mattrs, [xm, label[:, None]], [],
                                         False, None)
    _same(pm, softmax_output(xm, label[:, None], mattrs))
    assert ck.launch_counts()["softmax"] == after["softmax"] + 1


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


def _resnet50_shapes():
    """ResNet-50's 157 parameter shapes."""
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(1000, 50, "3,224,224")
    shapes, _, _ = sym.infer_shape(data=(1, 3, 224, 224))
    return [s for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")]


#: the multi-tensor update's length cases: one element, under, at and over
#: a vector, one past a block's pass, an odd length over several chunks
MULTI_LENGTHS = [(1,), (3,), (4,), (5,), (4097,), (1000003,)]


def _multi_lists(dev, shapes, ops, seed, offset=0, special=False):
    """``ops`` operand lists over ``shapes`` (the last operand, an Adam
    var, non-negative), each operand a view ``offset`` floats into its
    storage; per-array lrs and wds (lr 0 and wd 0 among them); with
    ``special`` NaN and +-inf in the first arrays' gradients."""
    gen = torch.Generator().manual_seed(seed)
    lists = [[] for _ in range(ops)]
    for s in shapes:
        n = int(np.prod(s))
        for j in range(ops):
            a = torch.randn(n + offset, generator=gen)
            if j == ops - 1 and ops == 4:
                a = a.abs()
            lists[j].append(a.to(dev)[offset:].view(s))
    if special:
        for k, v in enumerate((float("nan"), float("inf"), -float("inf"))):
            lists[1][k % len(shapes)].view(-1)[k] = v
    rs = np.random.RandomState(seed)
    lrs = list(rs.uniform(1e-3, 0.2, len(shapes)))
    wds = list(rs.uniform(0.0, 1e-2, len(shapes)))
    lrs[0] = 0.0
    wds[-1] = 0.0
    return lists, lrs, wds


def _bits(a, b):
    return torch.equal(a.reshape(-1).view(torch.int32),
                       b.reshape(-1).view(torch.int32))


def _multi_against_per_array(lists, lrs, wds, kind, clip):
    """The multi kernel's in-place result against the per-array kernel's
    on copies, bit for bit (NaN payloads too); returns the launches."""
    one = [[t.clone() for t in op] for op in lists]
    before = ck.launch_counts()
    if kind == "sgd":
        hp = dict(momentum=0.9, rescale=1 / 32, clip=clip)
        ck.sgd_mom_update_multi(*lists, lrs, wds, **hp)
        for w, g, m, lr, wd in zip(*one, lrs, wds):
            ck.sgd_mom_update(w, g, m, lr, wd=wd, **hp)
    else:
        hp = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale=1 / 32,
                  clip=clip)
        ck.adam_update_multi(*lists, lrs, wds, **hp)
        for w, g, m, v, lr, wd in zip(*one, lrs, wds):
            ck.adam_update(w, g, m, v, lr, wd=wd, **hp)
    torch.cuda.synchronize()
    for j, (a, b) in enumerate(zip(lists, one)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert _bits(x, y), (kind, j, i, tuple(x.shape))
    after = ck.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ops", [("sgd", 3), ("adam", 4)])
@pytest.mark.parametrize("clip", [-1.0, 0.01])
@pytest.mark.parametrize("case", ["resnet50", "lengths", "offset1",
                                  "offset2", "offset3", "nan_inf"])
def test_multi_update_is_the_per_array_kernel_bit_for_bit(dev, kind, ops,
                                                          clip, case):
    """One launch over the list; every element as the per-array kernel
    writes it: ResNet-50's 157 arrays, lengths around a vector and a
    chunk, views 1-3 floats into their storage (4-byte accesses), NaN and
    +-inf gradients; lr 0 and wd 0 among the arrays."""
    shapes = _resnet50_shapes() if case == "resnet50" else MULTI_LENGTHS
    offset = int(case[-1]) if case.startswith("offset") else 0
    lists, lrs, wds = _multi_lists(dev, shapes, ops, 0, offset,
                                   special=case == "nan_inf")
    got = _multi_against_per_array(lists, lrs, wds, kind, clip)
    per_array = "sgd_mom" if kind == "sgd" else "adam"
    assert got == {per_array + "_multi": 1, per_array: len(shapes)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ops", [("sgd", 3), ("adam", 4)])
def test_multi_update_mixed_alignment_and_many_launches(dev, kind, ops):
    """Arrays whose gradient alone is misaligned take 4-byte accesses
    beside aligned ones in one launch; 2000 arrays of 7 take
    ceil(2000 / MULTI_CAP) launches, bit for bit the per-array kernel."""
    lists, lrs, wds = _multi_lists(dev, MULTI_LENGTHS, ops, 1)
    base = torch.randn(4097 + 2, device=dev)
    lists[1][4] = base[2:]
    lists[1][1] = base[1:4]
    got = _multi_against_per_array(lists, lrs, wds, kind, -1.0)
    assert got[("sgd_mom" if kind == "sgd" else "adam") + "_multi"] == 1
    lists, lrs, wds = _multi_lists(dev, [(7,)] * 2000, ops, 2)
    got = _multi_against_per_array(lists, lrs, wds, kind, 0.01)
    assert got[("sgd_mom" if kind == "sgd" else "adam") + "_multi"] == \
        -(-2000 // ck.MULTI_CAP)


@pytest.mark.cuda
def test_multi_update_empty_and_zero_length_launch_nothing(dev):
    before = ck.launch_counts()
    ck.sgd_mom_update_multi([], [], [], [], [])
    z = [torch.zeros(0, device=dev)]
    ck.adam_update_multi(z, z, z, z, [0.1], [0.0])
    lists, lrs, wds = _multi_lists(dev, [(0,), (5,), (0,)], 3, 3)
    _multi_against_per_array(lists, lrs, wds, "sgd", -1.0)
    after = ck.launch_counts()
    assert after["adam_multi"] == before["adam_multi"]
    assert after["sgd_mom_multi"] == before["sgd_mom_multi"] + 1


@pytest.mark.cuda
def test_multi_update_refusals_name_the_array(dev):
    """A CUDA list raises, naming the array, for what the kernel does not
    take; nothing launches and nothing gives way to another path."""
    lists, lrs, wds = _multi_lists(dev, [(4, 3), (5,), (6,)], 3, 4)
    w, g, m = lists
    before = ck.launch_counts()
    cases = [
        ((w, g[:2] + [g[2].double()], m), r"grads\[2\] is torch.float64"),
        ((w, [g[0], g[1].to(torch.bfloat16), g[2]], m),
         r"grads\[1\] is torch.bfloat16; .*later slice"),
        (([w[0].t()] + w[1:], [g[0].t()] + g[1:], [m[0].t()] + m[1:]),
         r"weights\[0\] must be contiguous"),
        ((w, g, m[:1] + [m[2], m[2]]), r"moms\[1\] is \(6,\)"),
        ((w, g[:1] + [g[1].cpu()] + g[2:], m),
         r"grads\[1\] is on cpu, weights\[0\] on cuda:0"),
        (([x.cpu() for x in w], g, m), r"grads\[0\] is on cuda:0"),
        ((w, g, m[:2]), "differ in length"),
    ]
    for args, msg in cases:
        with pytest.raises(MXNetError, match=msg):
            ck.sgd_mom_update_multi(*args, lrs, wds, 0.9)
    mean = [x.clone() for x in m]
    with pytest.raises(MXNetError, match=r"vars\[2\] is torch.float16"):
        ck.adam_update_multi(w, g, mean, m[:2] + [m[2].half()], lrs, wds)
    assert ck.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_optimizer_states_reloaded_mid_fit_give_the_same_bits(
        dev, optimizer, tmp_path):
    """Two batches, a checkpoint with optimizer states, a fresh module
    loading it and two more batches: the bits of an uninterrupted 4-batch
    fit, one multi launch a step and no per-array launch."""
    rs = np.random.RandomState(0)
    X = rs.rand(32, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.float32)
    from mxnet_tpu_torch import models
    sym = models.mlp.get_symbol(10)
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4} \
        if optimizer == "sgd" else {"learning_rate": 1e-3, "wd": 1e-4}
    init = mx.mod.Module(sym, context=mx.gpu(0))
    init.bind([("data", (8, 1, 28, 28))], [("softmax_label", (8,))])
    init.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    params = {k: v.asnumpy() for k, v in init.get_params()[0].items()}

    def fit(mod, lo, hi, start=False):
        ck.reset_launch_counts()
        mod.fit(mx.io.NDArrayIter(X[lo:hi], y[lo:hi], batch_size=8),
                num_epoch=1, optimizer=optimizer, optimizer_params=opt,
                arg_params=mx.convert.params_from_numpy(params, mx.gpu(0))
                if start else None)
        upd = "sgd_mom" if optimizer == "sgd" else "adam"
        counts = ck.launch_counts()
        assert counts[upd + "_multi"] == (hi - lo) // 8 and not counts[upd]
        return mod

    def state(mod):
        st = mx.convert.optimizer_states_to_numpy(mod)
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
            {k: v if isinstance(v, list) else [v] for k, v in st.items()}, \
            mod._optimizer._index_update_count, mod._optimizer.num_update

    whole = state(fit(mx.mod.Module(sym, context=mx.gpu(0)), 0, 32, True))
    first = fit(mx.mod.Module(sym, context=mx.gpu(0)), 0, 16, True)
    first.save_checkpoint(str(tmp_path / "m"), 1, save_optimizer_states=True)
    fresh = mx.mod.Module.load(str(tmp_path / "m"), 1,
                               load_optimizer_states=True, context=mx.gpu(0))
    got = state(fit(fresh, 16, 32))
    assert got[2] == whole[2] and got[3] == whole[3]
    for k, v in whole[0].items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    for k, v in whole[1].items():
        for a, b in zip(got[1][k], v):
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.cuda
def test_training_kernels_refuse_what_they_do_not_take(dev):
    x = _rnd(dev, 4, 8)
    with pytest.raises(MXNetError, match="float32"):
        ck.softmax(x.double())
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


#: the LayerNorm backward's shapes: the LM's, one row, one column, the
#: eligibility bound, odd C, a short row, and the register route's limit
#: +-1 (C = 1024)
LN_BWD_SHAPES = [(8192, 512), (1, 512), (7, 1), (3, 65536), (5, 13),
                 (300, 100), (70, 1023), (70, 1024), (70, 1025)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", LN_BWD_SHAPES)
def test_ln_bwd_fused_kernel(dev, n, c):
    """``layernorm_bwd``, one launch for dx, dgamma and dbeta, against its
    plain version (dx within 2e-5, the sums over N rows within 1e-4);
    only ``ln_bwd`` moves, once; each single-half wrapper gives its half
    bit for bit (the same kernel with the other half off) and moves its
    own counter."""
    x = 3 * _rnd(dev, n, c) + 1
    g, b = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    ct = _rnd(dev, n, c, seed=3)
    _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
    before = ck.launch_counts()
    dx, dg, db = ck.layernorm_bwd(x, g, ct, mean, rstd)
    after = ck.launch_counts()
    want = ck.layernorm_bwd_plain(x, g, ct, mean, rstd)
    _same(dx, want[0])
    _same((dg, db), want[1:], tol=1e-4)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"ln_bwd": 1}
    assert dx.shape == (n, c) and dg.shape == db.shape == (c,)
    before = ck.launch_counts()
    assert torch.equal(ck.layernorm_bwd_dx(x, g, ct, mean, rstd), dx)
    for got, ref in zip(ck.layernorm_bwd_dparams(x, ct, mean, rstd),
                        (dg, db)):
        assert torch.equal(got, ref)
    after = ck.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"ln_bwd_dx": 1, "ln_bwd_dparams": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8192, 512), (70, 1024), (300, 4096)])
def test_ln_bwd_fused_repeats_bit_for_bit(dev, n, c):
    """The fused call's parameter gradients in a fixed order (no float
    atomics): repeated calls give identical bits, dx too."""
    x, ct = _rnd(dev, n, c), _rnd(dev, n, c, seed=1)
    g = _rnd(dev, c, seed=2)
    mean = x.mean(1)
    rstd = torch.rsqrt(x.var(1, unbiased=False) + 1e-5)
    first = ck.layernorm_bwd(x, g, ct, mean, rstd)
    for _ in range(3):
        again = ck.layernorm_bwd(x, g, ct, mean, rstd)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_ln_bwd_does_not_spill(dev):
    """ptxas' report shows 0 bytes of spill stores and loads for every
    instance of the LayerNorm backward: its rows and running column sums
    live in registers."""
    res = {fn: r for fn, r in ck.resources("ln_bwd").items()
           if "registers" in r}
    assert len(res) >= 3 * 6, sorted(res)
    for fn, r in res.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, (fn, r)


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
    """Refused: k and v of other shapes, a dtype no instance takes,
    non-contiguous rows. Head dims 24 and 144, Tq != Tk and a LayerNorm
    backward over 65537 columns run and match the plain versions."""
    for dh in (24, 144):
        q = _rnd(dev, 1, 2, 16, dh)
        _same(ck.flash_attention(q, q, q, True),
              ck.flash_attention_plain(q, q, q, True))
    q = _rnd(dev, 1, 2, 16, 64)
    kv = _rnd(dev, 1, 2, 8, 64)
    _same(ck.flash_attention(q, kv, kv), ck.flash_attention_plain(q, kv, kv))
    with pytest.raises(MXNetError, match="Tk"):
        ck.flash_attention(q, kv, _rnd(dev, 1, 2, 9, 64))
    with pytest.raises(MXNetError, match="float32"):
        ck.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(MXNetError, match="contiguous"):
        t = q.transpose(2, 3)
        ck.flash_attention(t, t, t)
    x = _rnd(dev, 4, 8)
    m = torch.zeros(4, device=dev)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.layernorm_bwd_dx(x.t(), x[0], x.t(), m, m)
    big = _rnd(dev, 1, 65537)
    for got, want in zip(ck.layernorm_bwd_dparams(big, big, m[:1], m[:1]),
                         ck.layernorm_bwd_dparams_plain(big, big, m[:1],
                                                        m[:1])):
        _same(got, want)
    with pytest.raises(MXNetError, match="float32"):
        ck.bias_gelu_dx(x.double(), x[0].double(), x.double())


_GRAD_CASES = {
    "LayerNorm": (lambda d: [3 * _rnd(d, 4, 64, 512) + 1,
                             _rnd(d, 512, seed=1), _rnd(d, 512, seed=2)],
                  {}, ("layernorm", "ln_bwd")),
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
                    "layernorm": 2 * L + 1, "ln_bwd": 2 * L + 1,
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
        # the same seed, so the same Xavier draws on both devices (the
        # card draws them with the threefry kernel)
        mx.random.seed(0)
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
            assert counts["softmax"] == counts["softmax_ce_bwd"] == 8
            # Module.update: one multi-tensor launch a step, no per-array
            assert counts[upd + "_multi"] == 8 and counts[upd] == 0, counts
            # Xavier drew each weight on the card: one uniform launch each
            assert counts["uniform"] == sum(
                k.endswith("weight") for k in out["gpu"]), counts
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
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (1, 2048, 1000),
                                   (257, 64, 33), (5, 13, 7)])
def test_qfc_matmul_half_kernel(dev, storage, m, k, n, half):
    """Row 16's 16-bit instances: x widened exactly, float32 sums and a
    float32 output, within 1e-5 of the output's largest magnitude of the
    plain version on the same values; only their counter moves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rnd(dev, m, k).to(half)
    w = _quant_weight(dev, n, k, storage)
    s = _rnd(dev, n, seed=1).abs() / 100 + 1e-3
    name = "qfc_matmul_" + ("bf16" if half == torch.bfloat16 else "f16")
    before = ck.launch_counts()
    got = ck.qfc_matmul(x, w, s)
    after = ck.launch_counts()
    ref = ck.qfc_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= \
        1e-5 * max(float(ref.abs().max()), 1e-30)
    assert _moved(before, after, (name, "qfc_matmul")) == \
        {name: 1, "qfc_matmul": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_quantized_module_under_compute_dtype_on_card(dev, half):
    """``Module(quantize_symbol(...), compute_dtype=...)`` (int8) on the
    card and on the CPU from the same parameters: the probabilities in
    the compute dtype within a few of its ulps at 1 (2e-2 for bfloat16,
    2.5e-3 for float16) and the same top-1; one 16-bit matmul launch, one
    multi-weight dequant launch (the conv prologue's) and the head's
    16-bit softmax a forward."""
    data = mx.sym.var("data")
    c = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                           pad=(1, 1), name="c1")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Activation(c, act_type="relu"), num_hidden=10, name="f1"),
        name="softmax")
    shape = (4, 3, 8, 8)
    shapes, _, _ = net.infer_shape(data=shape)
    rs = np.random.RandomState(0)
    params = {n: (0.3 * rs.randn(*sh)).astype(np.float32)
              for n, sh in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    qsym, qargs = mx.ops.quant.quantize_symbol(net, params, dtype="int8")
    X = rs.rand(*shape).astype(np.float32)
    sfx = "bf16" if half == "bfloat16" else "f16"
    outs = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        m = mx.mod.Module(qsym, context=ctx, compute_dtype=half)
        m.bind([("data", shape)], [("softmax_label", (4,))],
               for_training=False)
        m.init_params(initializer=None, arg_params=qargs, aux_params={})
        ck.reset_launch_counts()
        m.forward(mx.io.DataBatch([X], None), is_train=False)
        out = m.get_outputs()[0]
        assert str(out.astorch().dtype) == "torch." + half
        outs[ctx.device_type] = out.asnumpy().astype(np.float32)
        if ctx.device_type == "gpu":
            counts = {k: v for k, v in ck.launch_counts().items() if v}
            assert counts == {"qfc_matmul_" + sfx: 1,
                              "dequant_rows_multi": 1, "softmax_" + sfx: 1}
    np.testing.assert_allclose(outs["gpu"], outs["cpu"],
                               atol=_PROB_TOL[half])
    assert outs["gpu"].argmax(1).tolist() == outs["cpu"].argmax(1).tolist()


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


def _resnet50_conv_shapes():
    """The 53 conv weights' shapes of ResNet-50 (1000 classes)."""
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(1000, 50, "3,224,224")
    shapes, _, _ = sym.infer_shape(data=(1, 3, 224, 224))
    return [s for s in shapes if len(s) == 4 and s != (1, 3, 224, 224)]


def _dequant_lists(dev, shapes, storage, seed=0):
    ws = [_quant_weight(dev, sh[0], int(np.prod(sh[1:])), storage,
                        seed=seed + i).reshape(sh)
          for i, sh in enumerate(shapes)]
    ss = [_rnd(dev, sh[0], seed=seed + i).abs() / 100 + 1e-3
          for i, sh in enumerate(shapes)]
    return ws, ss


def _int_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
def test_dequant_rows_multi_resnet50_bitwise(dev, storage):
    """The multi-weight dequant over ResNet-50's 53 conv weights: one
    launch, each output bit for bit the plain version's and the
    single-array kernel's, in its weight's shape, 16-byte aligned."""
    shapes = _resnet50_conv_shapes()
    assert len(shapes) == 53
    ws, ss = _dequant_lists(dev, shapes, storage)
    before = ck.launch_counts()
    got = ck.dequant_rows_multi(ws, ss)
    after = ck.launch_counts()
    assert _moved(before, after, ("dequant_rows_multi", "dequant_rows")) == \
        {"dequant_rows_multi": 1, "dequant_rows": 0}
    torch.cuda.synchronize()
    for w, sc, g in zip(ws, ss, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert g.data_ptr() % 16 == 0
        assert torch.equal(_int_bits(g), _int_bits(ck.dequant_rows_plain(w, sc)))
        assert torch.equal(_int_bits(g).reshape(w.shape[0], -1),
                           _int_bits(ck.dequant_rows(w.reshape(w.shape[0], -1),
                                                 sc)))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
def test_dequant_rows_multi_edges(dev, storage):
    """The scalar route in the same launch (147 columns, 13 columns, one
    column, an offset view of a weight), an empty weight, and more weights
    than one table holds (two launches, in order): bit for bit the plain
    version's; the same bits on a repeat."""
    shapes = [(64, 3, 7, 7), (5, 13), (3, 1), (0, 16), (256, 64, 1, 1)] + \
        [(2, 16)] * (ck.DEQUANT_CAP + 3)
    ws, ss = _dequant_lists(dev, shapes, storage, seed=7)
    flat = _quant_weight(dev, 1, 1 + 32 * 48, storage, seed=3).reshape(-1)
    ws.append(flat[1:].view(32, 48))            # 1 byte off: the scalar route
    ss.append(_rnd(dev, 32, seed=4).abs() + 1e-3)
    before = ck.launch_counts()["dequant_rows_multi"]
    got = ck.dequant_rows_multi(ws, ss)
    again = ck.dequant_rows_multi(ws, ss)
    assert ck.launch_counts()["dequant_rows_multi"] == before + 4
    torch.cuda.synchronize()
    for w, sc, g, g2 in zip(ws, ss, got, again):
        assert g.shape == w.shape
        assert torch.equal(_int_bits(g), _int_bits(ck.dequant_rows_plain(w, sc)))
        assert torch.equal(_int_bits(g), _int_bits(g2))


@pytest.mark.cuda
def test_dequant_rows_multi_refuses_what_it_does_not_take(dev):
    w = _quant_weight(dev, 4, 16, torch.int8)
    e = _quant_weight(dev, 4, 16, torch.float8_e4m3fn)
    s = torch.ones(4, device=dev)
    with pytest.raises(MXNetError, match="one storage type"):
        ck.dequant_rows_multi([w, e], [s, s])
    with pytest.raises(MXNetError, match="takes torch.int8 or"):
        ck.dequant_rows_multi([w.float()], [s])
    with pytest.raises(MXNetError, match="scales\\[1\\] .*torch.float32"):
        ck.dequant_rows_multi([w, w], [s, s.half()])
    with pytest.raises(MXNetError, match="want scales\\[0\\] \\(O,\\)"):
        ck.dequant_rows_multi([w], [torch.ones(3, device=dev)])
    with pytest.raises(MXNetError, match="contiguous"):
        ck.dequant_rows_multi([w.t()], [torch.ones(16, device=dev)])
    with pytest.raises(MXNetError, match="CUDA tensor"):
        ck.dequant_rows_multi([w, w.cpu()], [s, s.cpu()])
    with pytest.raises(MXNetError, match="on a CUDA device"):
        ck.dequant_rows_multi([w.cpu(), w], [s.cpu(), s])


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
    # 16-bit data runs (its own instance of the matmul; the dequant is
    # float32 whatever the data), float64 data has no matmul instance
    with pytest.raises(MXNetError, match="float32"):
        mx.ops.registry.dispatch(qfc, fattrs,
                                 [_rnd(dev, 2, 8).double(), w, s], [],
                                 False, None)
    for hd in (torch.float16, torch.bfloat16):
        (out,), _ = mx.ops.registry.dispatch(
            qcv, cattrs, [_rnd(dev, 1, 2, 5, 5).to(hd), wc, s.to(hd)], [],
            False, None)
        assert out.dtype == hd
    # an fp8 weight widened by compute_dtype is no quantized weight
    with pytest.raises(MXNetError, match="int8 or torch.float8_e4m3fn"):
        ck.qfc_matmul(_rnd(dev, 2, 8).half(), w.half(), s)
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
    build after warmup, and exactly one dequant launch per forward (the
    conv prologue's, over every conv weight) and one fused
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
            mod.init_params(initializer=None,
                            arg_params=mx.convert.params_from_numpy(params,
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
                assert warm["dequant_rows_multi"] == \
                    warm["qfc_matmul"] == 6
                assert counts["dequant_rows_multi"] == \
                    counts["qfc_matmul"] == 7
                assert counts["dequant_rows"] == 0
            else:
                assert not any(counts.values()), counts
            server.stop()
        np.testing.assert_allclose(outs["gpu"], outs["cpu"], atol=1e-5,
                                   rtol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ------------------------------------------------ FusedConvBNReLU's kernels
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64, 56, 56), (8, 512, 7, 7),
                                   (4, 8, 1, 1), (2, 3, 5, 3),
                                   (1, 16, 12, 12), (3, 1, 6, 6),
                                   (1, 1, 1, 1)])
def test_bn_kernels(dev, shape):
    """bn_stats within 1e-5 of each channel's sum of squares (float32 sums
    in another order; the bound also holds the channel's sum, as
    sum(x)^2 <= n sum(x^2)), bn_apply_relu bit for bit."""
    x = 2 * _rnd(dev, *shape) + 0.5
    (s, sq), (ps, psq) = ck.bn_stats(x), ck.bn_stats_plain(x)
    torch.cuda.synchronize()
    bound = 1e-5 * psq
    assert ((s - ps).abs() <= bound).all() and \
        ((sq - psq).abs() <= bound).all()
    c = shape[1]
    scale, shift = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    assert torch.equal(ck.bn_apply_relu(x, scale, shift),
                       ck.bn_apply_relu_plain(x, scale, shift))


@pytest.mark.cuda
def test_bn_kernels_misaligned_repeat_and_refuse(dev):
    """A contiguous view that is only 4-byte aligned takes the scalar
    path and still agrees; bn_stats repeats bit for bit (no atomics);
    NaN passes through the apply pass; what the kernels do not take
    raises."""
    xv = _rnd(dev, 1 + 2 * 8 * 16)[1:].view(2, 8, 4, 4)
    ones, zeros = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    assert torch.equal(ck.bn_apply_relu(xv, ones, zeros),
                       ck.bn_apply_relu_plain(xv, ones, zeros))
    (s, sq), (ps, psq) = ck.bn_stats(xv), ck.bn_stats_plain(xv)
    assert ((sq - psq).abs() <= 1e-5 * psq).all()
    x = _rnd(dev, 32, 64, 56, 56)
    first, again = ck.bn_stats(x), ck.bn_stats(x)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    nan = torch.tensor([[[[float("nan"), -1.0]]]], device=dev)
    one = torch.ones(1, device=dev)
    assert ck.bn_apply_relu(nan, one, one * 0)[0, 0, 0, 0].isnan()
    with pytest.raises(MXNetError, match="contiguous"):
        ck.bn_stats(x.transpose(2, 3))
    with pytest.raises(MXNetError, match="float32"):
        ck.bn_apply_relu(x.double(), x.new_ones(64), x.new_zeros(64))
    with pytest.raises(MXNetError, match=r"\(N, C, H, W\)"):
        ck.bn_stats(x[0])
    with pytest.raises(MXNetError, match="scale and shift"):
        ck.bn_apply_relu(x, x.new_ones(63), x.new_zeros(63))
    with pytest.raises(MXNetError, match="CUDA tensor"):
        ck.bn_apply_relu(x, torch.ones(64), torch.zeros(64))


@pytest.mark.cuda
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("extra", [{"fix_gamma": False}, {"fix_gamma": True},
                                   {"use_global_stats": True}],
                         ids=["gamma", "fix_gamma", "global_stats"])
def test_fused_op_on_card(dev, is_train, extra):
    """FusedConvBNReLU's CUDA variant on the card against the same
    autograd.Function on CPU tensors (where its kernels are their plain
    halves), TF32 off: output and new moving statistics within 2e-5,
    gradients of data, weight, gamma and beta within 1e-4 (float32
    convolutions sum in another order); the kernels launched."""
    op = mx.ops.get_op("FusedConvBNReLU")
    attrs = op.normalize_attrs(dict(kernel=(3, 3), num_filter=16,
                                    pad=(1, 1), stride=(2, 2), eps=2e-5,
                                    **extra))
    make = [(4, 8, 15, 15), (16, 8, 3, 3), (16,), (16,), (16,), (16,)]
    arrays = [_rnd(torch.device("cpu"), *s, seed=i) for i, s in
              enumerate(make)]
    arrays[1] = 0.2 * arrays[1]
    arrays[5] = arrays[5].abs() + 0.5                 # moving variance
    ct = _rnd(torch.device("cpu"), 4, 16, 8, 8, seed=9)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    before = ck.launch_counts()
    res = {}
    try:
        for where in (dev, torch.device("cpu")):
            ins = [a.to(where).requires_grad_(True) for a in arrays[:4]]
            (y,), aux = op.variants["cuda"]["fn"](
                attrs, ins, [a.to(where) for a in arrays[4:]], is_train,
                None)
            grads = torch.autograd.grad(y, ins, ct.to(where),
                                        allow_unused=True)
            res[where.type] = [y.detach().cpu()] + [a.cpu() for a in aux] + \
                [torch.zeros_like(a) if g is None else g.cpu()
                 for g, a in zip(grads, arrays)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    after = ck.launch_counts()
    train_stats = is_train and not extra.get("use_global_stats")
    assert after["bn_apply_relu"] == before["bn_apply_relu"] + 1
    assert after["bn_stats"] == before["bn_stats"] + int(train_stats)
    for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
        tol = 2e-5 if i < 3 else 1e-4
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


# ------------------------------------------------ the bfloat16 instances
#: the 16-bit instances: name -> (torch dtype, counter suffix, mantissa
#: bits, smallest normal exponent)
HALVES = {"bfloat16": (torch.bfloat16, "bf16", 7, -126),
          "float16": (torch.float16, "f16", 10, -14)}
#: card-vs-CPU limit on probabilities and logits: a few ulps at 1
#: (2.56), so float16's is bfloat16's 2e-2 over 8
_PROB_TOL = {"bfloat16": 2e-2, "float16": 2.5e-3}


def _ulps16(half, a, b, atol=0.0):
    """Largest |a - b|, less ``atol``, in ulps of the 16-bit type ``half``
    at the larger magnitude (values below the normal range in ulps of the
    smallest normal)."""
    bits, emin = HALVES[half][2:]
    torch.cuda.synchronize()
    a, b = a.double().cpu(), b.double().cpu()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.tensor(2.0 ** emin, dtype=torch.float64))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    over = ((a - b).abs() - atol).clamp(min=0.0)
    return float((over / ulp).max()) if a.numel() else 0.0


def _misaligned_bf16(dev, n, *shape, dtype=torch.bfloat16):
    """A contiguous 16-bit view one element (2 bytes) off its
    allocation, so the kernels take their one-value-at-a-time path."""
    return (4 * _rnd(dev, 1 + n)).to(dtype)[1:].view(*shape)


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", SOFTMAX_SHAPES + [(4, 2)])
def test_softmax_bf16_kernel(dev, n, c, half):
    """The bfloat16 instance within one bfloat16 ulp of its plain version
    (a row sums in another order in float32, which can move a quotient
    across a rounding boundary); only its own counter moves."""
    hd, sfx = HALVES[half][:2]
    xs = [(4 * _rnd(dev, n, c)).to(hd),
          _misaligned_bf16(dev, n * c, n, c, dtype=hd)]
    for x in xs:
        before = ck.launch_counts()
        got = ck.softmax(x)
        after = ck.launch_counts()
        assert got.dtype == hd
        assert after["softmax_" + sfx] == before["softmax_" + sfx] + 1
        assert after["softmax"] == before["softmax"]
        assert _ulps16(half, got, ck.softmax_plain(x)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("c", [1000, 7])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_ce_bwd_bf16_kernel(dev, c, use_ignore, half):
    """Bit for bit its plain version: labels past 256 (257, 999: float32
    on both sides), outside the classes, and ignored rows; the pair path
    (even C) and the scalar one (odd C, or a misaligned view)."""
    hd, sfx = HALVES[half][:2]
    n = 6
    p = ck.softmax_plain((4 * _rnd(dev, n, c)).to(hd))
    lab = torch.tensor([257, 999, c - 1, 0, c, -1], dtype=torch.float32,
                       device=dev).clamp(max=c)
    lab[0] = min(257, c - 1)
    for pp in (p, _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        for scale in (1.0, 1 / n):
            got = ck.softmax_ce_bwd(pp, lab, scale, use_ignore, 0.0)
            assert got.dtype == hd
            want = ck.softmax_ce_bwd_plain(pp, lab, scale, use_ignore, 0.0)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("shape", [(32, 64, 112, 112), (32, 512, 7, 7),
                                   (4, 256, 14, 14), (2, 3, 5, 3),
                                   (4, 8, 1, 1), (1, 1, 1, 1)])
def test_bn_kernels_bf16(dev, shape, half):
    """bn_stats' bfloat16 instance within 1e-5 of each channel's sum of
    squares (float32 sums in another order), bn_apply_relu's bit for
    bit, on planes (HW % 8 == 0), slabs (HW = 196, 49, 1) and one value a
    load (HW = 15); only the bfloat16 counters move."""
    hd, sfx = HALVES[half][:2]
    x = (2 * _rnd(dev, *shape) + 0.5).to(hd)
    c = shape[1]
    scale, shift = _rnd(dev, c, seed=1), _rnd(dev, c, seed=2)
    before = ck.launch_counts()
    (s, sq), y = ck.bn_stats(x), ck.bn_apply_relu(x, scale, shift)
    after = ck.launch_counts()
    assert s.dtype == torch.float32 and y.dtype == hd
    (ps, psq), py = ck.bn_stats_plain(x), ck.bn_apply_relu_plain(
        x, scale, shift)
    torch.cuda.synchronize()
    bound = 1e-5 * psq
    assert ((s - ps).abs() <= bound).all() and \
        ((sq - psq).abs() <= bound).all()
    assert torch.equal(y, py)
    for k in ("bn_stats", "bn_apply_relu"):
        assert after[k + "_" + sfx] == before[k + "_" + sfx] + 1
        assert after[k] == before[k]


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_bn_kernels_bf16_misaligned_repeat_and_nan(dev, half):
    hd, sfx = HALVES[half][:2]
    xv = _misaligned_bf16(dev, 2 * 8 * 16, 2, 8, 4, 4, dtype=hd)
    ones, zeros = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    assert torch.equal(ck.bn_apply_relu(xv, ones, zeros),
                       ck.bn_apply_relu_plain(xv, ones, zeros))
    (s, sq), (ps, psq) = ck.bn_stats(xv), ck.bn_stats_plain(xv)
    assert ((sq - psq).abs() <= 1e-5 * psq).all()
    x = _rnd(dev, 32, 64, 56, 56).to(hd)
    first, again = ck.bn_stats(x), ck.bn_stats(x)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    nan = torch.tensor([[[[float("nan"), -1.0]]]], device=dev,
                       dtype=hd)
    one = torch.ones(1, device=dev)
    assert ck.bn_apply_relu(nan, one, one * 0)[0, 0, 0, 0].isnan()
    with pytest.raises(MXNetError, match="float32"):
        ck.bn_apply_relu(x, ones.to(hd), zeros)


@pytest.mark.cuda
def test_float32_only_kernels_refuse_bf16_naming_the_later_slice(dev):
    """The updates, which take float32 master weights, states and
    gradients only, refuse a bfloat16 or float16 gradient, naming their
    later slice; every kernel with 16-bit instances (float16 launches now)
    refuses a dtype no instance takes, naming it."""
    x = _rnd(dev, 8, 64)
    w = x.clone()
    for hd in (torch.bfloat16, torch.float16):
        with pytest.raises(MXNetError, match="later slice"):
            ck.sgd_mom_update(w, x.to(hd), w.clone(), 0.1)
        with pytest.raises(MXNetError, match="later slice"):
            ck.adam_update(w, x.to(hd), w.clone(), w.clone(), 0.1)
    d, g, st = x.double(), x[0].double(), torch.ones(8, device=dev)
    for call in (lambda: ck.layernorm_bwd_dx(d, g, d, st, st),
                 lambda: ck.layernorm_bwd_dparams(d, d, st, st),
                 lambda: ck.bias_gelu_dx(d, g, d),
                 lambda: ck.layernorm(d, g, g, 1e-5),
                 lambda: ck.bias_gelu(d, g),
                 lambda: ck.embedding(torch.zeros(2, dtype=torch.int32,
                                                  device=dev), d),
                 lambda: ck.flash_attention(*[_rnd(dev, 1, 1, 8, 64)
                                              .double()] * 3),
                 lambda: ck.softmax(d)):
        with pytest.raises(MXNetError, match="torch.float64 data; it has "
                           "torch.bfloat16, torch.float16, torch.float32"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("v,d", [(32000, 512), (50, 13), (7, 4)])
def test_embedding_bf16_kernel(dev, v, d, half):
    """Bit for bit its plain version (each row scaled in float32 and
    rounded once), out-of-range ids included, at the 16-byte path (D % 8
    == 0), the one-value path and on a misaligned table; only the
    bfloat16 counter moves."""
    hd, sfx = HALVES[half][:2]
    ids = torch.tensor([0, v - 1, -1, -v, v, -v - 1, 3],
                       dtype=torch.int32, device=dev)
    for w in (_rnd(dev, v, d).to(hd),
              _misaligned_bf16(dev, v * d, v, d, dtype=hd)):
        for scale in (1.0, float(np.sqrt(d))):
            before = ck.launch_counts()
            got = ck.embedding(ids, w, scale)
            after = ck.launch_counts()
            assert got.dtype == hd
            assert after["embedding_" + sfx] == before["embedding_" + sfx] + 1
            assert after["embedding"] == before["embedding"]
            _same(got, ck.embedding_plain(ids, w, scale), tol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", LN_SHAPES)
def test_layernorm_bf16_kernel(dev, n, c, half):
    """y within one bfloat16 ulp of its plain version beyond the float32
    kernel's 2e-5 (the product order can move a rounding), mean and rstd
    float32 within 2e-5; aligned and misaligned x."""
    hd, sfx = HALVES[half][:2]
    g = _rnd(dev, c, seed=1).to(hd)
    b = _rnd(dev, c, seed=2).to(hd)
    for x in ((3 * _rnd(dev, n, c) + 1).to(hd),
              _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        before = ck.launch_counts()
        y, mean, rstd = ck.layernorm(x, g, b, 1e-5)
        after = ck.launch_counts()
        py, pmean, prstd = ck.layernorm_plain(x, g, b, 1e-5)
        assert y.dtype == hd and mean.dtype == torch.float32
        assert _ulps16(half, y, py, atol=TOL) <= 1
        _same((mean, rstd), (pmean, prstd))
        _, stats = ck.layernorm_stats(x, g, b, 1e-5)
        assert torch.equal(stats[2], 1.0 / stats[1])
        assert after["layernorm_" + sfx] == before["layernorm_" + sfx] + 1
        assert after["layernorm"] == before["layernorm"]


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", [(8, 2048), (3, 13), (1, 4)])
def test_bias_gelu_bf16_kernel(dev, n, c, half):
    hd, sfx = HALVES[half][:2]
    b = _rnd(dev, c, seed=1).to(hd)
    for x in ((3 * _rnd(dev, n, c)).to(hd),
              _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        before = ck.launch_counts()
        y = ck.bias_gelu(x, b)
        after = ck.launch_counts()
        assert y.dtype == hd
        assert _ulps16(half, y, ck.bias_gelu_plain(x, b), atol=TOL) <= 1
        assert after["bias_gelu_" + sfx] == before["bias_gelu_" + sfx] + 1
        assert after["bias_gelu"] == before["bias_gelu"]


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("dh", [64, 128, 16, 48, 80, 96, 112])
@pytest.mark.parametrize("S,C", [(1, 256), (16, 256), (17, 100), (64, 64)])
def test_decode_attention_bf16_kernel(dev, dh, S, C, half):
    """bfloat16 q and caches, widened exactly: within 2e-5 of the plain
    read of the same values (float32 arithmetic in another order), at
    cursors 0, mid, C - S and C - 1; the output float32; only the
    bfloat16 counter moves."""
    hd, sfx = HALVES[half][:2]
    B, H = 4, 2
    cursors = torch.tensor([0, (C - S) // 2, C - S, C - 1],
                           dtype=torch.int32, device=dev)
    q = _rnd(dev, B, H, S, dh).to(hd)
    kc, vc = (_rnd(dev, B, H, C, dh, seed=s).to(hd)
              for s in (1, 2))
    before = ck.launch_counts()
    got = ck.decode_attention(q, kc, vc, cursors)
    after = ck.launch_counts()
    assert got.dtype == torch.float32
    _same(got, ck.decode_attention_plain(q, kc, vc, cursors))
    assert after["decode_attention_" + sfx] == \
        before["decode_attention_" + sfx] + 1
    assert after["decode_attention"] == before["decode_attention"]


@pytest.mark.cuda
def test_bf16_decode_kernels_refuse_what_they_do_not_take(dev):
    bf = torch.bfloat16
    q = _rnd(dev, 1, 1, 1, 64).to(bf)
    kc = _rnd(dev, 1, 1, 8, 64).to(bf)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    shifted = _misaligned_bf16(dev, 8 * 64, 1, 1, 8, 64)
    _same(ck.decode_attention(q, shifted, shifted, pos),            # 2-byte
          ck.decode_attention_plain(q, shifted, shifted, pos))      # copies
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.decode_attention(q.float(), kc, kc, pos)       # float32 q
    with pytest.raises(MXNetError, match="want torch.bfloat16"):
        ck.decode_attention_bf16(q, kc.float(), kc.float(), pos)
    q24, k24 = q[..., :24].contiguous(), kc[..., :24].contiguous()
    _same(ck.decode_attention(q24, k24, k24, pos),
          ck.decode_attention_plain(q24, k24, k24, pos))
    x, g = _rnd(dev, 2, 8).to(bf), _rnd(dev, 8).to(bf)
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.layernorm(x, g.float(), g, 1e-5)               # float32 gamma
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.bias_gelu(x, g.float())
    with pytest.raises(MXNetError, match="int32"):
        ck.embedding(torch.zeros(2, dtype=torch.int64, device=dev), x)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.layernorm(x.t(), g, g, 1e-5)


def _bf16_decode_model(n_layer, seed, cache_dtype=None):
    V, D, H, CAP = 300, 64, 1, 32

    def gen(s):
        return tfm.get_decode_symbol(
            vocab_size=V, d_model=D, n_layer=n_layer, n_head=H,
            capacity=CAP, per_slot=True, step_len=s, cache_dtype=cache_dtype)
    sym = gen(1)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(seed)
    params = {n: ((1.0 if n.endswith("gamma") else 0.0)
                  + 0.3 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    return gen, params


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("cache_dtype", [None, "fp8"])
def test_bf16_decode_on_card_matches_cpu(dev, cache_dtype, half):
    """``serve_decoder(compute_dtype=half)`` on the card and on the
    CPU: a fixed token chain (ids past 256) teacher-forced through the
    served rung-2 driver gives logits within 2e-2 (atol and rtol: cuBLAS
    and oneDNN round bfloat16 products at other places); on the card
    every S=1 step launches 1 / 2L + 1 / L / L of the four bfloat16
    instances and no other kernel, no library loads after warmup, and an
    fp8 cache cell holds the bfloat16 cache after its first step. In
    float16 the logits are held to two float16 ulps of the largest."""
    hd, sfx = HALVES[half][:2]
    gen, params = _bf16_decode_model(2, 0, cache_dtype)
    chain = np.random.RandomState(1).randint(0, 300, (12, 2))
    chain[0] = [299, 257]
    logits = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        sched = mx.serve.serve_decoder(
            gen(1), mx.convert.params_from_numpy(params, ctx), ladder=[2],
            clock=FakeClock(), start=False, context=ctx,
            compute_dtype=half)
        drv = sched.engine.driver(2)
        drv.join(0)
        drv.join(1)
        ck.reset_launch_counts()
        logits[ctx.device_type] = np.concatenate(
            [drv.step(tok[:, None]).asnumpy() for tok in chain], axis=1)
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            want = dict.fromkeys(counts, 0)
            want.update({"embedding_" + sfx: 12, "layernorm_" + sfx: 5 * 12,
                         "bias_gelu_" + sfx: 2 * 12,
                         "decode_attention_" + sfx: 2 * 12})
            assert counts == want
            assert sched.stats()["compiles_since_warmup"] == 0
        cache = drv._mod._exec_group.executor.aux_dict["lm_l0_attn_k_cache"]
        assert cache.astorch().dtype == (
            hd if cache_dtype else torch.float32)
    if half == "bfloat16":
        np.testing.assert_allclose(logits["gpu"], logits["cpu"], atol=2e-2,
                                   rtol=2e-2)
    else:       # two float16 ulps of the largest logit (measured 1.25)
        assert _bf16_of_max(torch.from_numpy(logits["gpu"]),
                            torch.from_numpy(logits["cpu"]), half) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_bf16_fast_paths_on_card(dev, half):
    """Chunked prefill (S=4), speculative decoding (a 1-layer draft,
    spec_k 3) and the prefix store under bfloat16 on the card: every
    request answers, 3 of 4 prefix hits, only the bfloat16 decode
    instances launch; an S=4 window's logits card vs CPU within 2e-2."""
    hd, sfx = HALVES[half][:2]
    gen, target = _bf16_decode_model(2, 0)
    dgen, draft = _bf16_decode_model(1, 1)
    rs = np.random.RandomState(2)
    shared = rs.randint(0, 300, 7).tolist()
    prompts = [shared + [int(t)] for t in rs.randint(0, 300, 4)]
    window = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        sched = mx.serve.serve_decoder(
            gen(1), mx.convert.params_from_numpy(target, ctx),
            ladder=[1, 2, 4], clock=FakeClock(), start=False, context=ctx,
            compute_dtype=half, symbol_gen=gen, prefill_chunk=4,
            draft_symbol_gen=dgen,
            draft_params=mx.convert.params_from_numpy(draft, ctx),
            spec_k=3, prefix_cache_mb=1)
        first = sched.submit(prompts[0], max_new_tokens=6, prefix_id="p")
        sched.pump(max_iterations=2)
        hs = [first] + [sched.submit(p, max_new_tokens=6, prefix_id="p")
                        for p in prompts[1:]]
        sched.pump()
        assert all(len(h.result(timeout=0)) == 6 for h in hs)
        st = sched.stats()
        assert st["prefix"]["hits"] == 3 and st["spec"]["proposed"] > 0
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            bf16 = {"embedding_" + sfx, "layernorm_" + sfx, "bias_gelu_" + sfx,
                    "decode_attention_" + sfx}
            assert all(counts[k] > 0 for k in bf16), counts
            assert not any(v for k, v in counts.items() if k not in bf16)
        drv = sched.engine.driver(1)
        drv.leave(0)
        drv.join(0)
        window[ctx.device_type] = drv.step(
            np.asarray([prompts[1][:4]])).asnumpy()
    tol = _PROB_TOL[half]
    np.testing.assert_allclose(window["gpu"], window["cpu"], atol=tol,
                               rtol=tol)


def _bf16_nets():
    """A narrow plain ResNet, and a small net with FusedConvBNReLU, a
    BatchNorm, pooling and the softmax head (this file imports no test
    helpers, which import JAX)."""
    from mxnet_tpu_torch.models import resnet
    plain = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                          filter_list=[16, 32, 64, 128, 256], num_classes=10,
                          image_shape=(3, 40, 40), bottle_neck=True)
    sym = mx.sym
    bn = dict(fix_gamma=False, eps=2e-5, momentum=0.9)
    body = sym.FusedConvBNReLU(data=sym.var("data"), num_filter=16,
                               kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               name="c0", **bn)
    body = sym.FusedConvBNReLU(data=body, num_filter=32, kernel=(3, 3),
                               pad=(1, 1), name="c1", **bn)
    body = sym.Activation(data=sym.BatchNorm(data=body, name="b2", **bn),
                          act_type="relu")
    body = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg")
    fused = sym.SoftmaxOutput(data=sym.FullyConnected(
        data=sym.Flatten(data=body), num_hidden=10, name="fc"),
        name="softmax")
    return {"plain": plain, "fused": fused}


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("net", ["plain", "fused"])
def test_bf16_fit_and_serve_on_card(dev, net, half):
    """``Module(compute_dtype=half)`` fitted two batches at lr 0.01
    on the card and on the CPU from the same parameters, TF32 off: the
    bfloat16 instances launch (softmax and the CE gradient; the
    BatchNorm pair for the fused net) and no float32 instance of them
    does; every cell stays float32. cuDNN's and oneDNN's bfloat16
    convolutions round their sums apart, and two steps carry that on (a
    narrow net's conv0 weight moves 1e-2 apart), so each weight and
    moving statistic is held within 3 times the distance between the
    CPU's own bfloat16 and float32 fits (plus 1e-6). Then one forward
    served on the card and on the CPU: probabilities within 2e-2 (a few
    bfloat16 ulps at 1) and the same top-1."""
    hd, sfx = HALVES[half][:2]
    sym = _bf16_nets()[net]
    rs = np.random.RandomState(0)
    X = rs.rand(8, 3, 40, 40).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.float32)
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind([("data", (4, 3, 40, 40))], [("softmax_label", (4,))])
    init.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    sgd = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res, counts = {}, None
    try:
        for ctx, cd in ((mx.gpu(0), half), (mx.cpu(), half),
                        (mx.cpu(), None)):
            ck.reset_launch_counts()
            m = mx.mod.Module(sym, context=ctx, compute_dtype=cd)
            m.fit(mx.io.NDArrayIter(X, y, batch_size=4), num_epoch=1,
                  arg_params=mx.convert.params_from_numpy(args, ctx),
                  aux_params=mx.convert.params_from_numpy(auxs, ctx),
                  optimizer_params=sgd)
            if counts is None:
                counts = ck.launch_counts()
            a, x = m.get_params()
            for cells in (a, x):
                assert {v.astorch().dtype for v in cells.values()} == \
                    {torch.float32}
            server = mx.serve.serve(m, context=ctx, ladder=[1, 2, 4],
                                    start=False, clock=FakeClock())
            try:
                h = server.submit({"data": X[:3]})
                server._clock.advance(1.0)
                while server.pump():
                    pass
                out = h.result(timeout=0)[0]
                assert out.astorch().dtype == (hd if cd
                                               else torch.float32)
            finally:
                server.stop()
            res[ctx.device_type + str(cd)] = (
                {k: v.asnumpy() for k, v in a.items()},
                {k: v.asnumpy() for k, v in x.items()}, out.asnumpy())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = {"softmax_" + sfx: 2, "softmax_ce_bwd_" + sfx: 2,
            "softmax": 0, "softmax_ce_bwd": 0, "bn_stats": 0,
            "bn_apply_relu": 0}
    if net == "fused":
        want.update({"bn_stats_" + sfx: 2 * 2, "bn_apply_relu_" + sfx: 2 * 2})
    assert {k: counts[k] for k in want} == want
    card, cpu, cpu32 = (res[k] for k in ("gpu" + half, "cpu" + half,
                                         "cpuNone"))
    for i in (0, 1):
        for k, v in cpu[i].items():
            spread = np.abs(v - cpu32[i][k]).max()
            np.testing.assert_allclose(card[i][k], v, atol=3 * spread + 1e-6,
                                       err_msg=k)
    go, co = card[2], cpu[2]
    np.testing.assert_allclose(go, co, atol=_PROB_TOL[half])
    assert go.argmax(1).tolist() == co.argmax(1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_kept_bf16_casts_follow_the_update_kernel(dev, half):
    """The SGD kernel writes weights through raw pointers; its wrapper
    bumps their version counters, so an inference forward after
    ``update()`` re-casts them: the same outputs as a fresh Module on the
    updated parameters."""
    hd, sfx = HALVES[half][:2]
    rs = np.random.RandomState(6)
    X = rs.randn(4, 16).astype(np.float32)
    y = np.asarray([3, 9, 0, 5], np.float32)
    data = mx.sym.var("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.BatchNorm(data, fix_gamma=False, name="bn"), num_hidden=10,
        name="fc"), name="softmax")
    shapes = ([("data", X.shape)], [("softmax_label", y.shape)])
    mod = mx.mod.Module(net, context=mx.gpu(0), compute_dtype=half)
    mod.bind(*shapes)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9})
    batch = mx.io.DataBatch([X], [y])
    mod.forward(batch, is_train=False)
    first = mod.get_outputs()[0].asnumpy()
    before = ck.launch_counts()["sgd_mom_multi"]
    mod.forward_backward(batch)
    mod.update()
    assert ck.launch_counts()["sgd_mom_multi"] == before + 1
    mod.forward(batch, is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    fresh = mx.mod.Module(net, context=mx.gpu(0), compute_dtype=half)
    fresh.bind(*shapes, for_training=False)
    fresh.init_params(arg_params=mod.get_params()[0],
                      aux_params=mod.get_params()[1])
    fresh.forward(batch, is_train=False)
    np.testing.assert_array_equal(got, fresh.get_outputs()[0].asnumpy())
    assert np.abs(got - first).max() > 1e-3


# --------------------------------------------------------------------------
# user kernels (mx.rtc), CustomOp and autograd on the card
# --------------------------------------------------------------------------
def _grid_stride(n="n"):
    return ("for (long long i = blockIdx.x * (long long)blockDim.x + "
            f"threadIdx.x; i < {n}; i += (long long)gridDim.x * blockDim.x)"
            "\n")


def _relu_ops():
    """``tc_relu_user`` (forward + VJP kernels, reference torch.relu) and
    ``tc_relu_novjp`` (no VJP kernel), registered once."""
    if "tc_relu_user" not in mx.sym.__dict__:
        mx.rtc.register_cuda_op(
            "tc_relu_user",
            kernel=lambda attrs: _grid_stride() +
            "    out[i] = data[i] > 0.0f ? data[i] : 0.0f;",
            vjp_kernel=lambda attrs: _grid_stride() +
            "    grad_data[i] = data[i] > 0.0f ? ct[i] : 0.0f;",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            reference=lambda attrs, x: torch.relu(x))
        mx.rtc.register_cuda_op(
            "tc_relu_novjp",
            kernel=lambda attrs: _grid_stride() +
            "    out[i] = data[i] > 0.0f ? data[i] : 0.0f;",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            reference=lambda attrs, x: torch.relu(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [None, ((64,), (128,)), ((3, 2), (32, 2))],
                         ids=["default", "1d", "2d"])
def test_rtc_push(dev, dims):
    """Rtc over 2^20 floats: ``out = 2 x + y`` equals torch.add(y, x,
    alpha=2) bit for bit, with the default launch and with given dims (a
    grid-stride body over every thread of the launch)."""
    n = 1 << 20
    x, y = _rnd(dev, n, seed=1), _rnd(dev, n, seed=2)
    out = mx.nd.array(np.zeros(n, np.float32), ctx=mx.gpu(0))
    body = ("    long long t = (blockIdx.y * (long long)gridDim.x + "
            "blockIdx.x) * blockDim.x * blockDim.y + threadIdx.y * "
            "blockDim.x + threadIdx.x;\n"
            "    long long step = (long long)gridDim.x * gridDim.y * "
            "blockDim.x * blockDim.y;\n"
            f"    for (long long i = t; i < {n}; i += step)\n"
            "        out[i] = 2.0f * x[i] + y[i];")
    xs, ys = mx.nd.NDArray(x), mx.nd.NDArray(y)
    rtc = mx.rtc.Rtc("tc_axpb", [("x", xs), ("y", ys)], [("out", out)], body)
    before = mx.rtc.launch_counts()["tc_axpb"]
    kw = {} if dims is None else {"grid_dims": dims[0],
                                  "block_dims": dims[1]}
    rtc.push([xs, ys], [out], **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.astorch(), torch.add(y, x, alpha=2.0))
    assert mx.rtc.launch_counts()["tc_axpb"] == before + 1
    with pytest.raises(MXNetError, match="shape"):
        rtc.push([xs, mx.nd.NDArray(y[:10])], [out])
    with pytest.raises(MXNetError, match="block"):
        rtc.push([xs, ys], [out], block_dims=(0,))


@pytest.mark.cuda
def test_rtc_push_writes_through_a_view(dev):
    """A non-contiguous output (a column of a wider array) is written in
    place: the array it views sees the result, its other column stays."""
    n = 1 << 12
    x = _rnd(dev, n, seed=3)
    base = torch.zeros(n, 2, device=dev)
    col = mx.nd.NDArray(base[:, 0])
    assert not col.astorch().is_contiguous()
    xs = mx.nd.NDArray(x)
    rtc = mx.rtc.Rtc("tc_twice", [("x", xs)], [("out", col)],
                     _grid_stride(n) + "    out[i] = 2.0f * x[i];")
    rtc.push([xs], [col])
    torch.cuda.synchronize()
    assert torch.equal(base[:, 0], 2.0 * x)
    assert torch.equal(col.astorch(), 2.0 * x)
    assert not base[:, 1].any()


@pytest.mark.cuda
def test_register_cuda_op_forward_and_vjp(dev):
    """The forward kernel equals torch.relu and the VJP kernel torch's
    threshold_backward bit for bit, zeros included (x == 0 gives 0), on
    shapes that do not fill a block; through mx.nd under autograd and
    through an executor."""
    _relu_ops()
    for shape in [(32, 64, 56, 56), (3, 5), (1,)]:
        x = _rnd(dev, *shape, seed=3)
        x.view(-1)[::7] = 0.0
        ct = _rnd(dev, *shape, seed=4)
        counts = mx.rtc.launch_counts()
        xs = mx.nd.NDArray(x.clone())
        gx = mx.nd.NDArray(torch.zeros_like(x))
        mx.autograd.mark_variables(xs, gx)
        with mx.autograd.train_section():
            y = mx.nd.tc_relu_user(xs)
        mx.autograd.backward(y, out_grads=mx.nd.NDArray(ct))
        torch.cuda.synchronize()
        leaf = x.clone().requires_grad_(True)
        want = torch.relu(leaf)
        want.backward(ct)
        assert torch.equal(y.astorch(), want.detach())
        assert torch.equal(gx.astorch(), leaf.grad)
        now = mx.rtc.launch_counts()
        assert now["tc_relu_user"] == counts["tc_relu_user"] + 1
        assert now["tc_relu_user_vjp"] == counts["tc_relu_user_vjp"] + 1
    # in an executor graph: card (kernels) against CPU (reference)
    sym = mx.sym.tc_relu_user(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=7, name="fc"))
    rs = np.random.RandomState(5)
    vals = {"data": rs.randn(4, 9), "fc_weight": rs.randn(7, 9),
            "fc_bias": rs.randn(7)}
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        exe = sym.simple_bind(ctx, data=(4, 9))
        for k, v in vals.items():
            exe.arg_dict[k][:] = v.astype(np.float32)
        exe.forward(is_train=True)
        exe.backward([mx.nd.array(np.ones((4, 7), np.float32), ctx=ctx)])
        got.append([exe.outputs[0].asnumpy()] +
                   [exe.grad_dict[k].asnumpy() for k in sorted(vals)])
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_op_without_vjp_refuses_grad(dev):
    _relu_ops()
    x = mx.nd.NDArray(_rnd(dev, 4, 6, seed=6))
    torch.testing.assert_close(mx.nd.tc_relu_novjp(x).astorch(),
                               torch.relu(x.astorch()))
    exe = mx.sym.tc_relu_novjp(mx.sym.var("data")).simple_bind(
        mx.gpu(0), data=(4, 6))
    with pytest.raises(MXNetError, match="vjp_kernel"):
        exe.forward(is_train=True)
    exe.forward(is_train=False)


@pytest.mark.cuda
def test_user_kernel_bf16_and_int32_signatures(dev):
    if "tc_bf16_twice" not in mx.sym.__dict__:
        mx.rtc.register_cuda_op(
            "tc_bf16_twice",
            kernel=lambda attrs: _grid_stride() +
            "    out[i] = __float2bfloat16(2.0f * __bfloat162float(data[i]));",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)])
    x = _rnd(dev, 1000, seed=7).to(torch.bfloat16)
    got = mx.nd.tc_bf16_twice(mx.nd.NDArray(x)).astorch()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (x.float() * 2.0).to(torch.bfloat16))
    idx = torch.arange(-500, 500, dtype=torch.int32, device=dev)
    out = mx.nd.NDArray(torch.zeros_like(idx))
    rtc = mx.rtc.Rtc("tc_affine_i32", [("idx", mx.nd.NDArray(idx))],
                     [("out", out)], _grid_stride(1000) +
                     "    out[i] = 3 * idx[i] + 1;")
    assert "const int* idx, int* out" in rtc.source
    rtc.push([mx.nd.NDArray(idx)], [out])
    assert torch.equal(out.astorch(), 3 * idx + 1)


def _custom_ops():
    if "tc_scale_nd" in mx.operator.get_all_registered():
        return

    class ScaleNd(mx.operator.CustomOp):
        """A body in NDArray arithmetic: it stays on the device."""

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 3.0 + 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3.0)

    @mx.operator.register("tc_scale_nd")
    class ScaleNdProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            assert ctx == mx.gpu(0) or ctx == mx.cpu()
            return ScaleNd()

    class Softmax(mx.operator.CustomOp):
        """The canonical custom softmax: numpy on the host."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().astype(np.int64)
            p = out_data[0].asnumpy().copy()
            p[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], p)

    @mx.operator.register("tc_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Softmax()


@pytest.mark.cuda
def test_custom_op_on_cuda_tensors(dev):
    """CustomOps on the card: an NDArray body keeps its tensors on the
    device, a numpy body round-trips through the host; forward and
    backward equal the CPU's, and the custom softmax head's gradients
    equal SoftmaxOutput's."""
    _custom_ops()
    rs = np.random.RandomState(8)
    xv = rs.randn(6, 5).astype(np.float32)
    lab = rs.randint(0, 10, 6).astype(np.float32)
    wv = rs.randn(10, 5).astype(np.float32)
    y = mx.nd.Custom(mx.nd.array(xv, ctx=mx.gpu(0)), op_type="tc_scale_nd")
    assert y.context == mx.gpu(0) and y.astorch().is_cuda
    np.testing.assert_allclose(y.asnumpy(), xv * 3.0 + 1.0, rtol=1e-6)
    fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=10,
                               no_bias=True, name="fc")
    label = mx.sym.var("softmax_label")
    got = {}
    for name, net in (("custom", mx.sym.Custom(fc, label,
                                                op_type="tc_softmax")),
                      ("plain", mx.sym.SoftmaxOutput(fc, label))):
        for ctx in (mx.gpu(0), mx.cpu()):
            exe = net.simple_bind(ctx, data=(6, 5), softmax_label=(6,))
            exe.arg_dict["data"][:] = xv
            exe.arg_dict["softmax_label"][:] = lab
            exe.arg_dict["fc_weight"][:] = wv
            exe.forward(is_train=True)
            exe.backward()
            got[name, str(ctx)] = (exe.outputs[0].asnumpy(),
                                   exe.grad_dict["fc_weight"].asnumpy())
    want = got["plain", "cpu(0)"]
    for key, (prob, grad) in got.items():
        np.testing.assert_allclose(prob, want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad, want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_autograd_backward_on_cuda(dev):
    """A conv -> relu -> conv -> residual add through mx.nd inside a train
    section on the card: the gradients of the marked weights and input
    equal the CPU's, TF32 off."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rs = np.random.RandomState(9)
        vals = [rs.randn(2, 8, 10, 10), 0.2 * rs.randn(4, 8, 1, 1),
                0.2 * rs.randn(8, 4, 3, 3)]
        head = rs.randn(2, 8, 10, 10).astype(np.float32)
        got = []
        for ctx in (mx.gpu(0), mx.cpu()):
            xs = [mx.nd.array(v.astype(np.float32), ctx=ctx) for v in vals]
            gs = [mx.nd.zeros(v.shape, ctx=ctx) for v in vals]
            mx.autograd.mark_variables(xs, gs)
            with mx.autograd.train_section():
                h = mx.nd.Activation(mx.nd.Convolution(
                    xs[0], xs[1], kernel=(1, 1), num_filter=4, no_bias=True),
                    act_type="relu")
                out = mx.nd.Convolution(h, xs[2], kernel=(3, 3), pad=(1, 1),
                                        num_filter=8, no_bias=True) + xs[0]
            mx.autograd.backward(out, out_grads=mx.nd.array(head, ctx=ctx))
            got.append([g.asnumpy() for g in gs])
        for a, b in zip(*got):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# --------------------------------------- LM training in bfloat16 (rows 11-14)
def _bf16_of_max(got, want, half="bfloat16"):
    """Largest |got - want| in ulps of the 16-bit type ``half`` at want's
    largest magnitude."""
    bits, emin = HALVES[half][2:]
    torch.cuda.synchronize()
    g, w = got.double().cpu(), want.double().cpu()
    top = max(float(w.abs().max()), 2.0 ** emin)
    return float((g - w).abs().max()) / 2.0 ** (np.floor(np.log2(top)) -
                                                 bits)


def _moved(before, after, names):
    """{counter: launches since ``before``} for the counters in names."""
    return {k: after[k] - before[k] for k in names}


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", [(8192, 512), (1, 512), (7, 1), (3, 65536),
                                 (5, 13), (300, 100)])
def test_ln_bwd_bf16_kernels(dev, n, c, half):
    """The bfloat16 instances against their plain versions on the same
    values: dx within one bfloat16 ulp beyond 2e-5 (float32 arithmetic in
    another order can move a rounding), dgamma / dbeta (float32 sums over
    N rows, rounded once) within one ulp beyond 1e-4; aligned rows and a
    misaligned view (one value at a time); only the bfloat16 counters
    move, once a call, and the outputs are bfloat16."""
    hd, sfx = HALVES[half][:2]
    bf = hd
    g = (1 + 0.3 * _rnd(dev, c, seed=1)).to(bf)
    b = _rnd(dev, c, seed=2).to(bf)
    ct = _rnd(dev, n, c, seed=3).to(bf)
    for x in ((3 * _rnd(dev, n, c) + 1).to(bf),
              _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
        before = ck.launch_counts()
        dx = ck.layernorm_bwd_dx(x, g, ct, mean, rstd)
        dg, db = ck.layernorm_bwd_dparams(x, ct, mean, rstd)
        after = ck.launch_counts()
        assert dx.dtype == dg.dtype == db.dtype == bf
        assert _ulps16(half, dx, ck.layernorm_bwd_dx_plain(
            x, g, ct, mean, rstd), atol=TOL) <= 1
        for got, want in zip((dg, db), ck.layernorm_bwd_dparams_plain(
                x, ct, mean, rstd)):
            assert _ulps16(half, got, want, atol=1e-4) <= 1
        assert _moved(before, after, (
            "layernorm_bwd_dx_" + sfx, "layernorm_bwd_dparams_" + sfx,
            "layernorm_bwd_" + sfx, "ln_bwd_dx", "ln_bwd_dparams",
            "ln_bwd")) == {
                "layernorm_bwd_dx_" + sfx: 1, "layernorm_bwd_dparams_" + sfx: 1,
                "layernorm_bwd_" + sfx: 0, "ln_bwd_dx": 0,
                "ln_bwd_dparams": 0, "ln_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_ln_bwd_dparams_bf16_repeats_bit_for_bit(dev, half):
    hd, sfx = HALVES[half][:2]
    bf = hd
    x, ct = _rnd(dev, 8192, 512).to(bf), _rnd(dev, 8192, 512, seed=1).to(bf)
    xf = x.float()
    mean = xf.mean(1)
    rstd = torch.rsqrt(xf.var(1, unbiased=False) + 1e-5)
    first = ck.layernorm_bwd_dparams(x, ct, mean, rstd)
    for _ in range(3):
        again = ck.layernorm_bwd_dparams(x, ct, mean, rstd)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", LN_BWD_SHAPES)
def test_ln_bwd_fused_bf16_kernel(dev, n, c, half):
    """The fused call's 16-bit instance against its plain version on the
    same values, aligned and on a misaligned view (one value at a time):
    dx within one ulp beyond 2e-5, dgamma / dbeta within one ulp beyond
    1e-4, all three 16-bit; only ``layernorm_bwd_<half>`` moves, once a
    call; repeated calls and the single-half wrappers give the same
    bits."""
    hd, sfx = HALVES[half][:2]
    g = (1 + 0.3 * _rnd(dev, c, seed=1)).to(hd)
    b = _rnd(dev, c, seed=2).to(hd)
    ct = _rnd(dev, n, c, seed=3).to(hd)
    for x in ((3 * _rnd(dev, n, c) + 1).to(hd),
              _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
        before = ck.launch_counts()
        got = ck.layernorm_bwd(x, g, ct, mean, rstd)
        after = ck.launch_counts()
        assert all(t.dtype == hd for t in got)
        want = ck.layernorm_bwd_plain(x, g, ct, mean, rstd)
        assert _ulps16(half, got[0], want[0], atol=TOL) <= 1
        for a, w in zip(got[1:], want[1:]):
            assert _ulps16(half, a, w, atol=1e-4) <= 1
        assert _moved(before, after, (
            "layernorm_bwd_" + sfx, "layernorm_bwd_dx_" + sfx,
            "layernorm_bwd_dparams_" + sfx, "ln_bwd")) == {
                "layernorm_bwd_" + sfx: 1, "layernorm_bwd_dx_" + sfx: 0,
                "layernorm_bwd_dparams_" + sfx: 0, "ln_bwd": 0}
        for a, w in zip(ck.layernorm_bwd(x, g, ct, mean, rstd), got):
            assert torch.equal(a, w)
        assert torch.equal(ck.layernorm_bwd_dx(x, g, ct, mean, rstd), got[0])
        for a, w in zip(ck.layernorm_bwd_dparams(x, ct, mean, rstd),
                        got[1:]):
            assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("n,c", [(8192, 2048), (3, 13), (1, 4), (2, 16)])
def test_bias_gelu_dx_bf16_kernel(dev, n, c, half):
    """Within one bfloat16 ulp beyond 2e-5 of the plain version (erff and
    expf against PyTorch's, float32 either way), aligned and misaligned;
    only the bfloat16 counter moves."""
    hd, sfx = HALVES[half][:2]
    bf = hd
    b = _rnd(dev, c, seed=1).to(bf)
    ct = _rnd(dev, n, c, seed=2).to(bf)
    for x in ((3 * _rnd(dev, n, c)).to(bf),
              _misaligned_bf16(dev, n * c, n, c, dtype=hd)):
        before = ck.launch_counts()
        dx = ck.bias_gelu_dx(x, b, ct)
        after = ck.launch_counts()
        assert dx.dtype == bf
        assert _ulps16(half, dx, ck.bias_gelu_dx_plain(x, b, ct),
                          atol=TOL) <= 1
        assert _moved(before, after, ("bias_gelu_dx_" + sfx, "bias_gelu_dx")
                      ) == {"bias_gelu_dx_" + sfx: 1, "bias_gelu_dx": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(8, 8, 1024, 64), (2, 2, 1, 64),
                                   (1, 2, 1000, 64), (2, 1, 200, 128),
                                   (1, 1, 64, 128), (1, 3, 65, 64),
                                   (2, 2, 127, 64), (2, 2, 128, 64),
                                   (2, 2, 129, 64), (1, 2, 257, 64),
                                   (1, 2, 127, 128), (1, 2, 129, 128),
                                   (1, 2, 257, 128), (1, 4, 1024, 128),
                                   (8, 16, 1024, 32), (2, 2, 1, 32),
                                   (1, 2, 127, 32), (1, 2, 129, 32),
                                   (1, 3, 257, 32), (2, 2, 1, 16),
                                   (1, 2, 129, 16), (2, 8, 1024, 48),
                                   (1, 2, 127, 48), (1, 2, 257, 48),
                                   (2, 8, 1024, 80), (1, 2, 65, 80),
                                   (1, 2, 129, 96), (2, 2, 1, 96),
                                   (1, 3, 200, 112), (1, 2, 63, 112)])
def test_flash_attention_bf16_kernel(dev, shape, causal, half):
    """16-bit q and k straight into the tensor cores, S scaled in
    float32, the float32 online softmax, P . V as p_hi . V + p_lo . V,
    the output rounded once: within one ulp of the type beyond 2e-5 of
    the plain version on the same values (T = 1, T on both sides of the
    128-row query tile and of the key tile, 128 at Dh 64 and 64 at Dh
    128, Dh 128 at T = 1024); only the instance's counter moves."""
    hd, sfx = HALVES[half][:2]
    q, k, v = (_rnd(dev, *shape, seed=i).to(hd)
               for i in range(3))
    before = ck.launch_counts()
    got = ck.flash_attention(q, k, v, causal)
    after = ck.launch_counts()
    assert got.dtype == hd
    assert _ulps16(half, got, ck.flash_attention_plain(q, k, v, causal),
                      atol=TOL) <= 1
    assert _moved(before, after, ("flash_attention_" + sfx, "flash_attention")
                  ) == {"flash_attention_" + sfx: 1, "flash_attention": 0}


@pytest.mark.cuda
def test_lm_bf16_kernels_refuse_what_they_do_not_take(dev):
    bf = torch.bfloat16
    q = _rnd(dev, 1, 2, 16, 64).to(bf)
    shifted = _misaligned_bf16(dev, 2 * 16 * 64, 1, 2, 16, 64)
    assert ck._flash_operands(shifted, shifted, shifted)[0] is not shifted
    assert _ulps16("bfloat16",                                # realigned
                   ck.flash_attention(shifted, shifted, shifted, True),
                   ck.flash_attention_plain(shifted, shifted, shifted, True),
                   atol=TOL) <= 1
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.flash_attention(q, q.float(), q, True)
    t = _rnd(dev, 1, 2, 16, 24).to(bf)
    assert _ulps16("bfloat16", ck.flash_attention(t, t, t),
                   ck.flash_attention_plain(t, t, t), atol=TOL) <= 1
    x, g = _rnd(dev, 4, 8).to(bf), _rnd(dev, 8).to(bf)
    m = torch.zeros(4, device=dev)
    with pytest.raises(MXNetError, match="takes torch.float32"):
        ck.layernorm_bwd_dx(x, g, x, m.to(bf), m)       # bfloat16 mean
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.layernorm_bwd_dparams(x, x.float(), m, m)
    with pytest.raises(MXNetError, match="takes torch.bfloat16"):
        ck.bias_gelu_dx(x, g.float(), x)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.bias_gelu_dx(x.t(), g[:4], x.t())


_BF16_GRAD_CASES = {
    "LayerNorm": (lambda d: [3 * _rnd(d, 4, 64, 512) + 1,
                             1 + 0.3 * _rnd(d, 512, seed=1),
                             _rnd(d, 512, seed=2)], {},
                  ("layernorm_bf16", "layernorm_bwd_bf16")),
    "FusedBiasGeLU": (lambda d: [_rnd(d, 256, 2048), _rnd(d, 2048, seed=1)],
                      {}, ("bias_gelu_bf16", "bias_gelu_dx_bf16")),
    "attention": (lambda d: [_rnd(d, 2, 4, 300, 64, seed=i)
                             for i in range(3)],
                  {"causal": True}, ("flash_attention_bf16",)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("name", sorted(_BF16_GRAD_CASES))
def test_op_gradient_bf16_on_card(dev, name, half):
    """The op's CUDA variant on bfloat16 inputs with autograd on the card
    (the bfloat16 instances forward and backward) against its plain op on
    the CPU in bfloat16: the output and every gradient bfloat16, within
    two bfloat16 ulps of each array's largest magnitude (float32 sums in
    other orders, rounded at other places: the plain op's bias gradient
    already lies one such ulp from the variant's on the CPU); only the
    bfloat16 instances launch."""
    hd, sfx = HALVES[half][:2]
    make, kwargs, kernels = _BF16_GRAD_CASES[name]
    kernels = [k.replace("_bf16", "_" + sfx) for k in kernels]
    op = mx.ops.get_op(name)
    attrs = op.normalize_attrs(kwargs)
    res = {}
    before = ck.launch_counts()
    for where in ("cuda", "cpu"):
        ins = [t.to(where, hd).detach().requires_grad_(True)
               for t in make(dev)]
        fn = op.variants["cuda"]["fn"] if where == "cuda" else op.forward
        out = fn(attrs, ins, [], True, None)[0][0]
        ct = _rnd(dev, *out.shape, seed=9).to(where, hd)
        out.backward(ct)
        res[where] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
    after = ck.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert set(moved) == set(kernels), moved
    for a, b in zip(res["cuda"], res["cpu"]):
        assert a.dtype == b.dtype == hd
        assert _bf16_of_max(a, b, half) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_small_lm_bf16_fit_alike_on_card_and_cpu(dev, half):
    """Four bfloat16 SGD batches of a small LM (V = 300: ids and labels
    past 256; d_model 128, 2 heads: Dh = 64) from the same parameters on
    the card and on the CPU, TF32 off: every parameter float32 and within
    3 times the CPU's own bfloat16-vs-float32 distance plus 1e-6 (cuBLAS
    and oneDNN round bfloat16 products at other places); on the card
    each step launches only the bfloat16 instances, 1 / 2L + 1 (x3) / L
    (x2) / L / 1 / 1 of them (SGD without momentum is no kernel)."""
    hd, sfx = HALVES[half][:2]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _lm_bf16_fit_both(half)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _lm_bf16_fit_both(half):
    sfx = HALVES[half][1]
    V, D, L, H, T, B, N = 300, 128, 2, 2, 48, 4, 4
    sym = tfm.get_symbol(V, D, L, H, T)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B * T,))
    rs = np.random.RandomState(0)
    params = {n: ((1.0 if n.endswith("gamma") else 0.0)
                  + 0.1 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    out = {}
    for ctx, cd in ((mx.gpu(0), half), (mx.cpu(), half), (mx.cpu(), None)):
        ck.reset_launch_counts()
        mod = mx.mod.Module(sym, context=ctx, compute_dtype=cd)
        mod.fit(tfm.SyntheticLMIter(V, B, T, N, seed=1), num_epoch=1,
                arg_params=mx.convert.params_from_numpy(params, ctx),
                optimizer="sgd", optimizer_params={"learning_rate": 0.05})
        got = mod.get_params()[0]
        assert {v.astorch().dtype for v in got.values()} == {torch.float32}
        out[(ctx.device_type, cd)] = {k: v.asnumpy() for k, v in got.items()}
        counts = ck.launch_counts()
        if ctx.device_type == "gpu":
            want = {"embedding": 1, "layernorm": 2 * L + 1,
                    "layernorm_bwd": 2 * L + 1,
                    "bias_gelu": L, "bias_gelu_dx": L,
                    "flash_attention": L, "softmax": 1,
                    "softmax_ce_bwd": 1}
            want = {k + "_" + sfx: n for k, n in want.items()}
            assert counts == {k: N * want.get(k, 0) for k in counts}, counts
        else:
            assert not any(counts.values()), counts
    card, cpu, cpu32 = (out[k] for k in (("gpu", half), ("cpu", half),
                                         ("cpu", None)))
    for k, v in cpu.items():
        assert np.abs(v - params[k]).max() > 0, k
        spread = float(np.abs(v - cpu32[k]).max())
        np.testing.assert_allclose(card[k], v, atol=3 * spread + 1e-6,
                                   rtol=0, err_msg=k)


# ------------------------- ring attention's partial flash kernel (row 15)
#: (B, H, Tq, Tk, Dh, q_off, k_off, causal): the sequence-parallel LM's
#: shard shapes (T = 4096 over seq = 4) non-causal, on the diagonal, a past
#: shard, a future shard (every row sees no key) and a shifted diagonal,
#: then Tq != Tk (ragged tiles), Dh 128 and one query
_PARTIAL_CASES = [(2, 8, 1024, 1024, 64, 0, 0, False),
                  (2, 8, 1024, 1024, 64, 1024, 1024, True),
                  (2, 8, 1024, 1024, 64, 2048, 1024, True),
                  (2, 8, 1024, 1024, 64, 0, 1024, True),
                  (1, 2, 256, 256, 64, 30, 0, True),
                  (1, 3, 200, 1000, 64, 900, 0, True),
                  (1, 2, 1000, 65, 64, 0, 0, True),
                  (2, 1, 130, 70, 128, 64, 0, True),
                  (1, 1, 1, 64, 64, 5, 0, True),
                  # shifts that are no multiple of a tile (128 queries;
                  # 128 keys at Dh 64, 64 at Dh 128)
                  (1, 2, 300, 260, 64, 517, 130, True),
                  (1, 2, 200, 333, 128, 77, 0, True),
                  (2, 2, 256, 384, 64, 0, 93, True),
                  # Dh 32: the ring's past shard and diagonal at the
                  # bench LM over 16 heads, a ragged shift, one query
                  (2, 16, 1024, 1024, 32, 2048, 1024, True),
                  (2, 16, 1024, 1024, 32, 1024, 1024, True),
                  (1, 2, 300, 260, 32, 517, 130, True),
                  (1, 1, 1, 64, 32, 5, 0, True),
                  # the head dims between the tiles: a past shard, the
                  # diagonal, a ragged shift and one query
                  (2, 8, 512, 512, 16, 1024, 512, True),
                  (2, 8, 512, 512, 48, 512, 512, True),
                  (1, 2, 300, 260, 80, 517, 130, True),
                  (1, 1, 1, 64, 96, 5, 0, True),
                  (1, 2, 200, 333, 112, 77, 0, True),
                  (2, 2, 256, 384, 48, 0, 93, True)]


def _partial_close(got, want, tol=TOL):
    """acc, m and l: the -inf rows of m (rows that see no key) exactly
    where the plain version has them, with l = 0 and acc = 0 there; every
    finite value within ``tol`` of the array's largest magnitude (the
    kernel sums the products and the online softmax in another order)."""
    torch.cuda.synchronize()
    acc, m, l = got
    racc, rm, rl = want
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))
    dead = torch.isneginf(rm)
    assert not l[dead].any() and not acc[dead].any()
    for a, b in ((acc, racc), (m[~dead], rm[~dead]), (l, rl)):
        assert a.dtype == torch.float32
        if b.numel():
            top = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) <= tol * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32"] + list(HALVES))
@pytest.mark.parametrize("case", _PARTIAL_CASES)
def test_flash_attention_partial_kernel(dev, case, dtype):
    """Each instance against the plain version on the same values (16-bit
    q, k, v widened exactly, float32 state out); only its counter
    moves."""
    B, H, tq, tk, dh, q_off, k_off, causal = case
    dt = getattr(torch, dtype)
    q = _rnd(dev, B, H, tq, dh, seed=1).to(dt)
    k, v = (_rnd(dev, B, H, tk, dh, seed=i).to(dt) for i in (2, 3))
    name = "flash_attention_partial" + (
        "" if dtype == "float32" else "_" + HALVES[dtype][1])
    before = ck.launch_counts()
    got = ck.flash_attention_partial(q, k, v, q_off, k_off, causal)
    after = ck.launch_counts()
    _partial_close(got, ck.flash_attention_partial_plain(q, k, v, q_off,
                                                         k_off, causal))
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}


#: a demangled flash kernel: ``...::tc::flash_tc<__half, (int)64,
#: (bool)1>`` (16-bit: the tile's head dim) or ``...::cc::flash_fwd<
#: (int)64, (bool)0>``
_FLASH_INSTANCE = re.compile(r"::(flash_tc|flash_fwd)<(?:(\w+), )?"
                             r"\(int\)(\d+), \(bool\)([01])>")


def _flash_instances():
    """{(element type, tile Dh, partial): what the compiler made of it}
    for the flash-attention library's ten kernels (float32 on the CUDA
    cores, ``flash_fwd``; the 16-bit instances, ``flash_tc``)."""
    out = {}
    for fn, res in ck.resources("flash_attention").items():
        m = _FLASH_INSTANCE.search(fn)
        if m:
            kind, elem, tile, partial = m.groups()
            assert (kind == "flash_fwd") == (elem is None)
            out[(elem or "float", int(tile), partial == "1")] = res
    return out


@pytest.mark.cuda
def test_flash_attention_16bit_instances_use_wgmma(dev):
    """The SASS of the bfloat16 and float16 instances, both modes, every
    tile (Dh 64's, which also runs Dh 16 to 48, and Dh 128's), holds
    HGMMA (wgmma); the float32 instances' holds none: the reference's
    Precision.HIGHEST rules out TF32."""
    inst = _flash_instances()
    assert set(inst) == {(e, dh, p) for e in ("float", "__nv_bfloat16",
                                              "__half")
                         for dh in ((32, 64, 128) if e == "float"
                                    else (64, 128))
                         for p in (False, True)}
    for key, res in inst.items():
        hgmma = res["sass"].get("HGMMA", 0)
        assert (hgmma > 0) == (key[0] != "float"), (key, hgmma)


@pytest.mark.cuda
def test_flash_attention_16bit_instances_do_not_spill(dev):
    """ptxas' report (``build_log["flash_attention"]``) shows 0 bytes of
    spill stores and loads for every 16-bit instance."""
    ck.build(["flash_attention"])
    assert "spill stores" in ck.build_log["flash_attention"]
    for key, res in _flash_instances().items():
        if key[0] != "float":
            assert res["spill_stores"] == res["spill_loads"] == 0, key


@pytest.mark.cuda
def test_flash_attention_partial_refuses_what_it_does_not_take(dev):
    q = _rnd(dev, 1, 2, 16, 144)                # the wide route runs it
    for got, want in zip(ck.flash_attention_partial(q, q, q),
                         ck.flash_attention_partial_plain(q, q, q)):
        _same(got, want)
    q = _rnd(dev, 1, 2, 16, 64)
    with pytest.raises(MXNetError, match="Tk"):
        ck.flash_attention_partial(q, _rnd(dev, 1, 2, 8, 64),
                                   _rnd(dev, 1, 2, 9, 64))
    with pytest.raises(MXNetError, match="float32"):
        ck.flash_attention_partial(q.double(), q.double(), q.double())
    with pytest.raises(MXNetError, match="contiguous"):
        t = q.transpose(2, 3)
        ck.flash_attention_partial(t, t, t)


def _ring_mesh(n=4):
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(seq=n), [mx.gpu(0)] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,launches", [(True, 10), (False, 16)])
def test_ring_of_four_on_one_card(dev, causal, launches):
    """Ring attention over [gpu(0)] * 4 against full attention on the card
    (forward 2e-5 of the output's scale: online softmax in another order)
    and its gradients (the plain ring's recompute) against the unsharded
    ones within 1e-4 of each array's largest magnitude; the partial kernel
    launches once per (position, step) but for a causal ring's future
    shards, and the normalized flash kernel not at all."""
    from mxnet_tpu_torch.parallel import ring_attention_sharded
    from mxnet_tpu_torch.rtc import _attention_plain
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qkv = [_rnd(dev, 2, 4, 256, 64, seed=i).requires_grad_(True)
               for i in range(3)]
        ck.reset_launch_counts()
        out = ring_attention_sharded(*qkv, _ring_mesh(), causal=causal)
        counts = ck.launch_counts()
        assert {k: n for k, n in counts.items() if n} == \
            {"flash_attention_partial": launches}
        ref = _attention_plain({"causal": causal}, *qkv)
        _same(out, ref, tol=TOL)
        ct = _rnd(dev, 2, 4, 256, 64, seed=7)
        got = torch.autograd.grad(out, qkv, ct)
        want = torch.autograd.grad(ref, qkv, ct)
        for g, w in zip(got, want):
            torch.cuda.synchronize()
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None] + list(HALVES))
def test_small_lm_seq_parallel_fit_on_card(dev, half):
    """A small LM (d_model 128, 2 heads: Dh 64; T 64) through
    fit(spmd=True, mesh=MeshConfig(seq=4)) over [gpu(0)] * 4 and over
    [cpu(i)] * 4 from the same parameters, TF32 off: the card launches
    L x 10 partial kernels a step and no normalized flash kernel, and
    every parameter agrees with the CPU's within 1e-4 (float32, as the
    unsharded small LM) or 3 times the CPU's own 16-bit-vs-float32
    distance plus 1e-6."""
    from mxnet_tpu_torch.parallel import MeshConfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        V, D, L, H, T, B, N = 300, 128, 2, 2, 64, 2, 3
        sym = tfm.get_symbol(V, D, L, H, T)
        shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B * T,))
        rs = np.random.RandomState(0)
        params = {n: ((1.0 if n.endswith("gamma") else 0.0)
                      + 0.1 * rs.randn(*s)).astype(np.float32)
                  for n, s in zip(sym.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        out = {}
        runs = [(mx.gpu(0), half), (mx.cpu(), half)]
        if half is not None:
            runs.append((mx.cpu(), None))
        for ctx, cd in runs:
            ck.reset_launch_counts()
            mod = mx.mod.Module(sym, context=[ctx] * 4, compute_dtype=cd)
            mod.fit(tfm.SyntheticLMIter(V, B, T, N, seed=1), num_epoch=1,
                    arg_params=mx.convert.params_from_numpy(params, ctx),
                    spmd=True, mesh=MeshConfig(seq=4), optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05})
            out[(ctx.device_type, cd)] = {
                k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            counts = ck.launch_counts()
            sfx = "" if cd is None else "_" + HALVES[cd][1]
            if ctx.device_type == "gpu":
                assert counts["flash_attention_partial" + sfx] == N * L * 10
                assert counts["flash_attention" + sfx] == 0
        card, cpu = out[("gpu", half)], out[("cpu", half)]
        for k, v in cpu.items():
            assert np.abs(v - params[k]).max() > 0, k
            if half is None:
                np.testing.assert_allclose(card[k], v, atol=1e-4, rtol=1e-4,
                                           err_msg=k)
            else:
                spread = float(np.abs(v - out[("cpu", None)][k]).max())
                np.testing.assert_allclose(card[k], v, rtol=0,
                                           atol=3 * spread + 1e-6, err_msg=k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ------------------------------------------- row 16's GEMV route, row 14 / 15
#: M at the route's break at N 1000 on an H100's 132 SMs (976: the GEMV
#: route up to it, the tiled route above; 975 at N 1001) and on both sides
#: of it, and the serving rungs
_QFC_BREAK = ck.QFC_GEMV_PER_SM * 132 // 1000
_QFC_MS = sorted({1, 8, _QFC_BREAK - 1, _QFC_BREAK, _QFC_BREAK + 1})
_QFC_X = {"float32": (torch.float32, "qfc_matmul"),
          "bfloat16": (torch.bfloat16, "qfc_matmul_bf16"),
          "float16": (torch.float16, "qfc_matmul_f16")}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000, 1001])
@pytest.mark.parametrize("k", [4, 13, 300, 2048])
@pytest.mark.parametrize("m", _QFC_MS)
@pytest.mark.parametrize("xt", list(_QFC_X))
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
def test_qfc_matmul_routes(dev, storage, xt, m, k, n):
    """Every instance at the GEMV route's break M and M +- 1 (the tiled
    route above), K of one 16-byte unit's quarter, unaligned and ragged
    units, N of one channel, of a ragged channel group and past the
    serving head, on aligned x and on an offset view (its pointer not 16
    bytes aligned): within 1e-5 of the output's largest magnitude of the
    plain version, two calls bit for bit, one launch a call on the
    instance's counter and on no other."""
    dt, name = _QFC_X[xt]
    base = _rnd(dev, m * k + 1, seed=m + k).to(dt)
    w = _quant_weight(dev, n, k, storage, seed=n)
    s = _rnd(dev, n, seed=1).abs() / 100 + 1e-3
    for x in (base[:m * k].view(m, k), base[1:].view(m, k)):
        before = ck.launch_counts()
        got = ck.qfc_matmul(x, w, s)
        after = ck.launch_counts()
        again = ck.qfc_matmul(x, w, s)
        ref = ck.qfc_matmul_plain(x, w, s)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        assert float((got - ref).abs().max()) <= \
            1e-5 * max(float(ref.abs().max()), 1e-30)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        moved = {c: after[c] - before[c] for c in after
                 if after[c] != before[c]}
        assert moved == {name: 1}


@pytest.mark.cuda
def test_qfc_matmul_gemv_more_bands_than_a_grid_row(dev):
    """One output channel keeps the GEMV route at any M: 300000 rows are
    75000 bands of 4, more than a grid's y extent (65535), in one launch."""
    m, k, n = 300000, 16, 1
    x = _rnd(dev, m, k, seed=6)
    w = _quant_weight(dev, n, k, torch.int8, seed=7)
    s = _rnd(dev, n, seed=8).abs() / 100 + 1e-3
    assert ck._qfc_route(m, n, k, ck._sm_count(0))[0] == 4
    got, ref = ck.qfc_matmul(x, w, s), ck.qfc_matmul_plain(x, w, s)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _QSTORAGE, ids=["int8", "e4m3"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (1, 2048, 1000),
                                   (3, 300, 33), (8, 2048, 7)])
def test_qfc_matmul_matches_gemv_emulation(dev, storage, m, k, n):
    """The kernel against ``tests/qfc_gemv_emul.py``, the same route, lane
    order, butterfly and split order on the CPU (FMAs emulated in float64
    and rounded once): within 1e-6 of the output's largest magnitude."""
    x = _rnd(dev, m, k, seed=3)
    w = _quant_weight(dev, n, k, storage, seed=4)
    s = _rnd(dev, n, seed=5).abs() / 100 + 1e-3
    got = ck.qfc_matmul(x, w, s).cpu()
    want = qfc_gemv(x.cpu(), w.cpu(), s.cpu(),
                    torch.cuda.get_device_properties(0).multi_processor_count)
    assert float((got - want).abs().max()) <= \
        1e-6 * float(want.abs().max())


@pytest.mark.cuda
def test_qfc_matmul_does_not_spill(dev):
    """ptxas' report: no instance of either route spills, and none runs on
    the tensor cores (float32 FMAs, as the reference's HIGHEST)."""
    res = ck.resources("qfc_matmul")
    gemv = [fn for fn in res if "qfc_gemv" in fn]
    assert len(gemv) == 18, sorted(res)
    for fn, r in res.items():
        if "registers" in r:
            assert r["spill_stores"] == r["spill_loads"] == 0, fn
            sass = r.get("sass", {})
            assert not sass.get("HGMMA") and not sass.get("HMMA"), fn


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 1000])
def test_flash_attention_float32_tiles(dev, T, dh, causal):
    """Row 14 float32 at T on both sides of the 64-key and the 64- / 128-
    query tiles, every head dim: within 2e-5 of the plain version."""
    q, k, v = (_rnd(dev, 2, 3, T, dh, seed=T + i) for i in range(3))
    _same(ck.flash_attention(q, k, v, causal),
          ck.flash_attention_plain(q, k, v, causal))


#: (Tq, Tk, q_off, k_off): past, diagonal, future and Tq != Tk shards,
#: at the float32 tiles' edges
_F32_SHARDS = [(1024, 1024, 2048, 1024), (1024, 1024, 1024, 1024),
               (129, 129, 0, 129), (128, 129, 0, 0), (129, 128, 64, 0),
               (200, 65, 300, 100), (65, 200, 0, 63), (1, 1000, 999, 0),
               (1000, 1, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("shard", _F32_SHARDS)
def test_flash_attention_partial_float32_shards(dev, shard, dh):
    """Row 15 float32: acc, m and l against the plain version, the rows
    that see no key exactly -inf / 0 / 0; only its counter moves."""
    tq, tk, q_off, k_off = shard
    q = _rnd(dev, 1, 2, tq, dh, seed=1)
    k, v = (_rnd(dev, 1, 2, tk, dh, seed=i) for i in (2, 3))
    before = ck.launch_counts()
    got = ck.flash_attention_partial(q, k, v, q_off, k_off, True)
    after = ck.launch_counts()
    _partial_close(got, ck.flash_attention_partial_plain(q, k, v, q_off,
                                                         k_off, True))
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"flash_attention_partial": 1}


@pytest.mark.cuda
def test_flash_attention_float32_instances_do_not_spill(dev):
    """ptxas' report shows 0 bytes of spill stores and loads for the six
    float32 instances (both modes, every head dim)."""
    inst = {key: r for key, r in _flash_instances().items()
            if key[0] == "float"}
    assert len(inst) == 6
    for key, res in inst.items():
        assert res["spill_stores"] == res["spill_loads"] == 0, key


# ------------------------------------------------- row 7 in one launch
_BN_DTYPES = {"float32": (torch.float32, "bn_stats"),
              "bfloat16": (torch.bfloat16, "bn_stats_bf16"),
              "float16": (torch.float16, "bn_stats_f16")}
#: planes and slabs, HW 1, 7 x 7, 14 x 14, 56 x 56, 3 x 5, C = 1, N = 1,
#: many splits, and ResNet-50's stage-1 and stage-4 tensors
_BN_SHAPES = [(3, 16, 7, 7), (4, 64, 1, 1), (2, 16, 14, 14), (3, 8, 56, 56),
              (600, 2, 2, 2), (32, 512, 7, 7), (1, 1, 1, 1), (2, 3, 3, 5),
              (5, 1, 7, 7), (32, 64, 56, 56), (1, 256, 14, 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(_BN_DTYPES))
@pytest.mark.parametrize("shape", _BN_SHAPES)
def test_bn_stats_matches_emulation_bit_for_bit(dev, shape, dtype):
    """Each instance gives the bits of ``tests/bn_stats_emul.py`` (the same
    plan, the same float32 sums in the same order) on a 16-byte aligned x
    and on a view 4 (2) bytes off, twice in a row."""
    dt = _BN_DTYPES[dtype][0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = int(np.prod(shape))
    flat = (2 * _rnd(dev, n + 1) + 0.5).to(dt)
    for x in (flat[:n].view(shape), flat[1:].view(shape)):
        got = [ck.bn_stats(x), ck.bn_stats(x)]
        torch.cuda.synchronize()
        want = bn_stats_emul(x.float().cpu().numpy(), x.element_size(),
                             x.data_ptr() % 16 == 0, sms)
        for s in got:
            for a, b in zip(s, want):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(_BN_DTYPES))
def test_bn_stats_one_launch_a_call(dev, dtype):
    """Three calls: three launches on the instance's counter, and on the
    card (the profiler's device events) kernels of the one-launch design
    only, never more than three, exactly three in one of up to three
    profiled rounds (the profiler can drop an event of a short session),
    whichever route the shape takes; one (2, C) allocation of outputs."""
    dt, counter = _BN_DTYPES[dtype]
    for shape in ((32, 64, 56, 56), (32, 512, 7, 7), (4, 256, 14, 14),
                  (2, 3, 5, 3), (70, 3, 4, 4)):
        x = _rnd(dev, *shape).to(dt)
        s, sq = ck.bn_stats(x)          # the workspace, allocated once
        assert s.data_ptr() + 4 * shape[1] == sq.data_ptr()
        torch.cuda.synchronize()
        seen = []
        for _round in range(3):
            before = ck.launch_counts()[counter]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    ck.bn_stats(x)
                torch.cuda.synchronize()
            assert ck.launch_counts()[counter] == before + 3
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            assert all("bn_stats_planes" in k or "bn_stats_slabs" in k
                       for k in kernels), kernels
            seen.append(len(kernels))
            if len(kernels) == 3:
                break
        assert max(seen) == 3, (shape, seen)


# ------------------------------------------------------------ head dim 32
@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(1, 256), (1, 4096), (16, 256), (64, 256),
                                 (3, 100)])
@pytest.mark.parametrize("inst", list(DECODE_INSTANCES))
def test_decode_attention_repeats_bit_for_bit_at_head_dim_32(dev, inst, S, C):
    """The Dh 32 read (a lane's one V dim) at the bench LM's rows (8
    rows of 16 heads): two calls give the same bits and agree with the
    plain version, the counters back at 0."""
    q, kc, vc, pos = _split_inputs(dev, inst, 8, 16, S, C, 32, seed=4)
    a = ck.decode_attention(q, kc, vc, pos)
    b = ck.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _same(a, ck.decode_attention_plain(q, kc, vc, pos))
    for _ws, counters in ck._DECODE_WS.values():
        assert not counters.any()


def _dh32_lm_params(sym, **shapes):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(0)
    return {n: ((1.0 if n.endswith("gamma") else 0.0)
                + 0.1 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _small_lm_decodes(half, dh):
    """A small LM at head dim ``dh`` (2 heads, 2 layers) through
    serve_decoder on the card and on the CPU: the same greedy chains in
    float32 (a 16-bit card run: tokens of the CPU's vocabulary, every chain
    its length) and the decode read launched in the instance of the
    type."""
    V, D, L, H, CAP = 96, 2 * dh, 2, 2, 32
    sym = tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                n_head=H, capacity=CAP, per_slot=True)
    params = _dh32_lm_params(sym, data=(1, 1))
    prompts = [np.random.RandomState(i).randint(0, V, 5).tolist()
               for i in range(3)]
    chains = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ck.reset_launch_counts()
        sched = mx.serve.serve_decoder(
            sym, mx.convert.params_from_numpy(params, ctx), ladder=[1, 2, 4],
            clock=FakeClock(), start=False, context=ctx,
            compute_dtype=half if ctx.device_type == "gpu" else None)
        hs = [sched.submit(p, max_new_tokens=8) for p in prompts]
        sched.pump()
        chains[ctx.device_type] = [h.result(timeout=0).tolist() for h in hs]
        if ctx.device_type == "gpu":
            name = "decode_attention" + (
                "" if half is None else "_" + HALVES[half][1])
            assert ck.launch_counts()[name] > 0
    if half is None:
        assert chains["gpu"] == chains["cpu"]
    for chain in chains["gpu"]:
        assert len(chain) == 8 and all(0 <= t < V for t in chain)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None] + list(HALVES))
def test_small_lm_at_head_dim_32_decodes_on_card(dev, half):
    """``_small_lm_decodes`` at Dh 32 (d_model 64)."""
    _small_lm_decodes(half, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [None] + list(HALVES))
@pytest.mark.parametrize("dh", [48, 80])
def test_small_lm_at_head_dims_48_and_80_decodes_on_card(dev, dh, half):
    """``_small_lm_decodes`` at Dh 48 and 80 (d_model 96, 160), head dims
    between the kernels' tiles."""
    _small_lm_decodes(half, dh)


def _small_lm_fits(dh):
    """Four SGD batches of a small LM at head dim ``dh`` (2 heads) on the
    card and on the CPU, TF32 off: parameters within 1e-4 and L flash
    launches a step; then two ring steps (fit(spmd=True, mesh=
    MeshConfig(seq=4))) launch L x 10 partial kernels a step."""
    from mxnet_tpu_torch.parallel import MeshConfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        V, D, L, H, T, B, N = 96, 2 * dh, 2, 2, 64, 4, 4
        sym = tfm.get_symbol(V, D, L, H, T)
        params = _dh32_lm_params(sym, data=(B, T), softmax_label=(B * T,))
        out = {}
        for ctx in (mx.gpu(0), mx.cpu()):
            ck.reset_launch_counts()
            mod = mx.mod.Module(sym, context=ctx)
            mod.fit(tfm.SyntheticLMIter(V, B, T, N, seed=1), num_epoch=1,
                    arg_params=mx.convert.params_from_numpy(params, ctx),
                    optimizer="sgd", optimizer_params={"learning_rate": 0.05})
            out[ctx.device_type] = {k: v.asnumpy()
                                    for k, v in mod.get_params()[0].items()}
            if ctx.device_type == "gpu":
                assert ck.launch_counts()["flash_attention"] == N * L
        for k, v in out["cpu"].items():
            np.testing.assert_allclose(out["gpu"][k], v, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        ck.reset_launch_counts()
        mod = mx.mod.Module(sym, context=[mx.gpu(0)] * 4)
        mod.fit(tfm.SyntheticLMIter(V, B, T, 2, seed=1), num_epoch=1,
                arg_params=mx.convert.params_from_numpy(params, mx.gpu(0)),
                spmd=True, mesh=MeshConfig(seq=4), optimizer="sgd",
                optimizer_params={"learning_rate": 0.05})
        counts = ck.launch_counts()
        assert counts["flash_attention_partial"] == 2 * L * 10
        assert counts["flash_attention"] == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_small_lm_at_head_dim_32_fits_on_card(dev):
    """``_small_lm_fits`` at Dh 32 (d_model 64)."""
    _small_lm_fits(32)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [48, 80])
def test_small_lm_at_head_dims_48_and_80_fit_on_card(dev, dh):
    """``_small_lm_fits`` at Dh 48 and 80 (d_model 96, 160)."""
    _small_lm_fits(dh)


# -------------------------- inputs the kernels once refused (slice 21)
#: head dims no multiple of 16 and above 128: one value a row, narrow
#: copies, the tiles' edges and the wide routes' column groups
ANY_DHS = [1, 2, 8, 24, 40, 72, 120, 136, 192, 256, 512, 520]


def _flash_case(dev, dtype, B, H, tq, tk, dh, seed=0):
    return (_rnd(dev, B, H, tq, dh, seed=seed).to(dtype),
            _rnd(dev, B, H, tk, dh, seed=seed + 1).to(dtype),
            _rnd(dev, B, H, tk, dh, seed=seed + 2).to(dtype))


def _flash_close(dtype, got, want):
    """float32 within 2e-5; 16-bit within one ulp beyond 2e-5 (the
    normalized output, rounded once), NaN where the plain version is."""
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if dtype is torch.float32:
        _same(got, want)
    else:
        half = {torch.bfloat16: "bfloat16", torch.float16: "float16"}[dtype]
        ok = ~torch.isnan(want)
        assert _ulps16(half, got[ok], want[ok], atol=TOL) <= 1


_FLASH_COUNTER = {torch.float32: "", torch.bfloat16: "_bf16",
                  torch.float16: "_f16"}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", ANY_DHS)
@pytest.mark.parametrize("S", [1, 16, 64])
@pytest.mark.parametrize("inst", list(DECODE_INSTANCES))
def test_decode_attention_at_any_head_dim(dev, inst, S, dh):
    """Any Dh >= 1 in the decode read, every instance, S = 1 and windows,
    at the split edges, against the plain read (float32 out, 2e-5), one
    launch on the instance's counter."""
    q, kc, vc, pos = _split_inputs(dev, inst, 4, 2, S, 300, dh)
    counter = DECODE_INSTANCES[inst][2]
    before = ck.launch_counts()[counter]
    got = ck.decode_attention(q, kc, vc, pos)
    assert ck.launch_counts()[counter] == before + 1
    _same(got, ck.decode_attention_plain(q, kc, vc, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [40, 64, 256])
@pytest.mark.parametrize("S", [64, 65, 128, 256])
@pytest.mark.parametrize("inst", list(DECODE_INSTANCES))
def test_decode_attention_windows_past_64_rows(dev, inst, S, dh):
    """Windows of S > 64 rows (more 16-row query tiles) at capacity 512,
    every instance, against the plain read; the split emulation agrees
    in float32."""
    q, kc, vc, pos = _split_inputs(dev, inst, 4, 2, S, 512, dh)
    got = ck.decode_attention(q, kc, vc, pos)
    _same(got, ck.decode_attention_plain(q, kc, vc, pos))
    if inst == "f32":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _same(got.cpu(), decode_attention_split(q.cpu(), kc.cpu(), vc.cpu(),
                                                pos.cpu(), sms))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", ANY_DHS)
@pytest.mark.parametrize("dtype", list(_FLASH_COUNTER))
def test_flash_attention_at_any_head_dim(dev, dtype, dh):
    """Any Dh >= 1 in the flash forward and its partial mode, every
    instance, causal and not: against the plain versions, one launch each
    on the instance's counter (16-bit Dh <= 128 not a multiple of 8 after
    a zero-padded copy; above 128 the wide route)."""
    q, k, v = _flash_case(dev, dtype, 1, 3, 70, 70, dh)
    sfx = _FLASH_COUNTER[dtype]
    for causal in (True, False):
        before = ck.launch_counts()
        got = ck.flash_attention(q, k, v, causal)
        after = ck.launch_counts()
        assert after["flash_attention" + sfx] == \
            before["flash_attention" + sfx] + 1
        _flash_close(dtype, got, ck.flash_attention_plain(q, k, v, causal))
        acc, m, l = ck.flash_attention_partial(q, k, v, 7, 3, causal)
        want = ck.flash_attention_partial_plain(q, k, v, 7, 3, causal)
        _same((acc, m, l), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [24, 64, 128])
def test_flash_attention_float32_on_misaligned_operands(dev, dh):
    """float32 operands 1, 2 or 3 floats off 16 bytes reach the 16-byte
    copies as an aligned per-call copy: both modes against their plain
    versions, one launch each on the float32 counters."""
    for off in (1, 2, 3):
        base = _rnd(dev, 3 * 70 * dh + off)
        q = base[off:].reshape(1, 3, 70, dh)
        assert q.data_ptr() % 16 != 0
        before = ck.launch_counts()
        got = ck.flash_attention(q, q, q, True)
        acc = ck.flash_attention_partial(q, q, q, 5, 0, True)
        after = ck.launch_counts()
        assert after["flash_attention"] == before["flash_attention"] + 1
        assert after["flash_attention_partial"] == \
            before["flash_attention_partial"] + 1
        _flash_close(torch.float32, got,
                     ck.flash_attention_plain(q, q, q, True))
        _same(acc, ck.flash_attention_partial_plain(q, q, q, 5, 0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(24, 70), (70, 24), (130, 257),
                                   (257, 130), (1, 64), (64, 1)])
@pytest.mark.parametrize("dtype", list(_FLASH_COUNTER))
def test_flash_attention_with_tq_ne_tk(dev, dtype, tq, tk, causal):
    """Tq != Tk: the mask bottom-right aligned; a query row that sees no
    key (Tq > Tk, causal) NaN, as the plain version and the reference."""
    q, k, v = _flash_case(dev, dtype, 2, 2, tq, tk, 64)
    got = ck.flash_attention(q, k, v, causal)
    want = ck.flash_attention_plain(q, k, v, causal)
    _flash_close(dtype, got, want)
    if causal and tq > tk:
        assert torch.isnan(got[:, :, :tq - tk].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [65535, 65536])
@pytest.mark.parametrize("dtype", list(_FLASH_COUNTER))
def test_flash_attention_over_b_times_h_past_65535(dev, dtype, bh):
    """B*H on the grid's x axis: 65535 and 65536 rows, both modes."""
    q, k, v = _flash_case(dev, dtype, bh, 1, 5, 5, 64)
    _flash_close(dtype, ck.flash_attention(q, k, v, True),
                 ck.flash_attention_plain(q, k, v, True))
    _same(ck.flash_attention_partial(q, k, v, 2, 0, True),
          ck.flash_attention_partial_plain(q, k, v, 2, 0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [65536, 65537, 128256, 262144])
@pytest.mark.parametrize("dtype", list(_FLASH_COUNTER))
def test_softmax_rows_past_65536(dev, dtype, c):
    """Rows past the register routes (the streaming route), and at their
    bound, against the plain version (one ulp in 16 bits), with a NaN row
    and a row of -inf alone NaN."""
    x = 4 * _rnd(dev, 3, c)
    x[1, 7] = float("nan")
    x[2] = float("-inf")
    x = x.to(dtype)
    got, want = ck.softmax(x), ck.softmax_plain(x)
    if dtype is torch.float32:
        _same(got, want)
    else:
        half = {torch.bfloat16: "bfloat16", torch.float16: "float16"}[dtype]
        assert torch.isnan(got[1:]).all()
        assert _ulps16(half, got[:1], want[:1], atol=TOL) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [65537, 131072])
@pytest.mark.parametrize("dtype", list(_FLASH_COUNTER))
def test_ln_bwd_rows_past_65536(dev, dtype, c):
    """The LayerNorm backward's walked route past the JAX bound: dx, dγ
    and dβ against the plain version (float32 1e-4, 16-bit one ulp beyond
    it), the parameter sums repeating bit for bit."""
    x, ct = _rnd(dev, 5, c).to(dtype), _rnd(dev, 5, c, seed=1).to(dtype)
    g = (1 + 0.1 * _rnd(dev, c, seed=2)).to(dtype)
    _, mean, rstd = ck.layernorm_plain(x, g, g, 1e-5)
    got = ck.layernorm_bwd(x, g, ct, mean, rstd)
    want = ck.layernorm_bwd_plain(x, g, ct, mean, rstd)
    for a, b in zip(got, want):
        if dtype is torch.float32:
            _same(a, b, tol=1e-4)
        else:
            half = {torch.bfloat16: "bfloat16",
                    torch.float16: "float16"}[dtype]
            assert _ulps16(half, a, b, atol=1e-4) <= 1
    assert torch.equal(ck.layernorm_bwd(x, g, ct, mean, rstd)[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["null", "valid"])
@pytest.mark.parametrize("shape", [(4, 10, 3, 5), (3, 7, 33)])
def test_softmax_output_multi_output_on_card(dev, shape, norm):
    """``multi_output`` (N, C, H, W) and (N, C, T) with ignored positions:
    the op's CUDA variant (the softmax and cross-entropy kernels over the
    (N * d..., C) rows, one launch each) against the plain op on the
    CPU, probabilities and gradients."""
    op = mx.ops.get_op("SoftmaxOutput")
    attrs = op.normalize_attrs({"multi_output": True, "use_ignore": True,
                                "ignore_label": 0, "normalization": norm})
    x = _rnd(dev, *shape)
    label = torch.randint(0, shape[1], (shape[0],) + shape[2:],
                          generator=torch.Generator().manual_seed(1)).to(
        dev, torch.float32)
    res = []
    for d, run in ((dev, op.variants["cuda"]["fn"]), ("cpu", op.forward)):
        xx = x.to(d).clone().requires_grad_(True)
        before = ck.launch_counts()
        (prob,), _ = run(attrs, [xx, label.to(d)], [], True, None)
        prob.backward(torch.ones_like(prob))
        res.append((prob.detach().cpu(), xx.grad.cpu()))
        if d == dev:
            assert _moved(before, ck.launch_counts(),
                          ("softmax", "softmax_ce_bwd")) == {
                "softmax": 1, "softmax_ce_bwd": 1}
    _same(res[0], res[1])


@pytest.mark.cuda
@pytest.mark.parametrize("axis,shape", [(1, (4, 96, 7)), (-2, (3, 50, 9)),
                                        (1, (2, 33, 4, 5))])
def test_layernorm_over_any_axis_on_card(dev, axis, shape):
    """``LayerNorm(axis)``: the op's CUDA variant (the axis moved last,
    the forward kernel and the one backward call) against the plain op on
    the CPU, outputs in the JAX op's shapes and gradients."""
    op = mx.ops.get_op("LayerNorm")
    attrs = op.normalize_attrs({"axis": axis})
    c = shape[axis]
    base = [_rnd(dev, *shape), 1 + 0.1 * _rnd(dev, c, seed=1),
            0.1 * _rnd(dev, c, seed=2)]
    ct = _rnd(dev, *shape, seed=3)
    res = []
    for d, run in ((dev, op.variants["cuda"]["fn"]), ("cpu", op.forward)):
        leaves = [t.to(d).clone().requires_grad_(True) for t in base]
        before = ck.launch_counts()
        outs, _ = run(attrs, leaves, [], True, None)
        outs[0].backward(ct.to(d))
        res.append(tuple(o.detach().cpu() for o in outs) +
                   tuple(t.grad.cpu() for t in leaves))
        if d == dev:
            assert _moved(before, ck.launch_counts(),
                          ("layernorm", "ln_bwd")) == {"layernorm": 1,
                                                       "ln_bwd": 1}
    assert [t.shape for t in res[0]] == [t.shape for t in res[1]]
    _same(res[0], res[1], tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("half", list(HALVES))
def test_fp8_graph_under_compute_dtype_on_card(dev, half):
    """An fp8-quantized convnet under ``compute_dtype``: the e4m3 weights
    reach rows 16 and 17 as stored (their e4m3 instances launch: the dense
    layer's 16-bit one, the conv dequant's), and the card's probabilities
    match the CPU Module's within the type's few ulps at 1."""
    from mxnet_tpu_torch.ops.quant import quantize_symbol
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10,
                                name="f1")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    shape = (4, 3, 8, 8)
    arg_shapes, _, _ = sym.infer_shape(data=shape)
    rs = np.random.RandomState(0)
    params = {n: (0.3 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    qsym, qargs = quantize_symbol(sym, params, dtype="fp8")
    X = rs.rand(*shape).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        before = ck.launch_counts()
        mod = mx.mod.Module(qsym, context=ctx, compute_dtype=half)
        mod.bind([("data", shape)], [("softmax_label", (4,))],
                 for_training=False)
        mod.init_params(initializer=None, arg_params=qargs, aux_params={},
                        allow_missing=False)
        mod.forward(mx.io.DataBatch([X], []), is_train=False)
        outs.append(mod.get_outputs()[0].astorch().float().cpu())
        if ctx.device_type == "gpu":
            moved = {k: v - before[k] for k, v in ck.launch_counts().items()
                     if v != before[k]}
            sfx = HALVES[half][1]
            assert moved.get("qfc_matmul_" + sfx) == 1, moved
            assert moved.get("dequant_rows_multi", 0) + \
                moved.get("dequant_rows", 0) == 1, moved
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=_PROB_TOL[half])


@pytest.mark.cuda
def test_qfc_matmul_rows_past_one_grid(dev):
    """M past 64 x 65535 rows (the tiled route's grid y): two launches at
    row offsets, against the plain version."""
    from mxnet_tpu_torch.ops.quant import quantize_per_channel
    m = ck.QFC_CHUNK_M + 3
    x = _rnd(dev, m, 4)
    wq, scale = quantize_per_channel(torch.randn(3, 4), dtype="int8")
    wq, scale = wq.to(dev), scale.to(dev)
    before = ck.launch_counts()["qfc_matmul"]
    got = ck.qfc_matmul(x, wq, scale)
    assert ck.launch_counts()["qfc_matmul"] == before + 2
    want = ck.qfc_matmul_plain(x, wq, scale)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------- threefry
def _tkey(seed):
    return mx.random.split(mx.random.prng_key(seed))[1]


#: Dropout sizes: one value, odd, no multiple of a 16-byte unit, the VGG
#: drop6 shape at batch 32, the bench LM's (8, 1024, 512)
DROPOUT_SHAPES = [(1,), (7,), (4099,), (3, 5, 11), (32, 4096),
                  (8, 1024, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
def test_dropout_kernel_bit_for_bit(dev, dtype, shape):
    """y and the mask equal the plain version's bit for bit (aligned and
    on a view one element off 16 bytes), one launch a call."""
    name = {torch.float32: "dropout", torch.bfloat16: "dropout_bf16",
            torch.float16: "dropout_f16"}[dtype]
    n = int(np.prod(shape))
    flat = _rnd(dev, n + 1, seed=3).to(dtype)
    for x in (flat[:n].view(shape), flat[1:].view(shape)):
        for i, keep in enumerate((0.9, 0.5, 0.3)):
            key = _tkey(i)
            before = ck.launch_counts()[name]
            y, m = ck.dropout(x, key, keep)
            assert ck.launch_counts()[name] == before + 1
            py, pm = ck.dropout_plain(x.cpu(), key, keep)
            assert torch.equal(y.cpu(), py) and torch.equal(m.cpu(), pm)
            assert y.dtype == m.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 11), (1 << 20,)])
def test_uniform_kernel(dev, shape):
    """Uniform draws bit for bit the plain version's; normal within 1e-5
    of max(1, |value|) (erfinvf against torch.erfinv), exponential
    within 2 float32 ulps; one launch a call."""
    key = _tkey(5)
    for lo, hi in ((0.0, 1.0), (-0.07, 0.07), (-2.5, 3.3)):
        before = ck.launch_counts()["uniform"]
        got = ck.uniform(key, shape, lo, hi, device=dev)
        assert ck.launch_counts()["uniform"] == before + 1
        assert torch.equal(got.cpu(), ck.uniform_plain(key, shape, lo, hi))
    got = ck.uniform(key, shape, transform=mx.random.NORMAL, device=dev)
    want = ck.uniform_plain(key, shape, transform=mx.random.NORMAL)
    err = (got.cpu() - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5
    got = ck.uniform(key, shape, transform=mx.random.EXPONENTIAL,
                     device=dev).cpu()
    want = ck.uniform_plain(key, shape, transform=mx.random.EXPONENTIAL)
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 2


@pytest.mark.cuda
def test_dropout_op_and_samplers_on_card(dev):
    """A Dropout graph's forward and gradients on the card equal the
    CPU's after the same seed (the same key chain, the masks bit for
    bit); the imperative samplers and an initializer draw the CPU's
    values, in float32 and in the 16-bit types (the threefry kernel's
    16-bit instances)."""
    def graph():
        d = mx.sym.Dropout(mx.sym.var("data"), p=0.4, name="d0")
        return mx.sym.Group([d, mx.sym.Dropout(d, p=0.25, name="d1")])
    x = np.random.RandomState(0).randn(16, 300).astype("f")
    outs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        mx.random.seed(7)
        exe = graph().simple_bind(ctx, grad_req="write", data=x.shape)
        exe.arg_dict["data"][:] = x
        before = ck.launch_counts()["dropout"]
        o = exe.forward(is_train=True)
        exe.backward([mx.nd.array(np.ones(x.shape, "f"), ctx=ctx)] * 2)
        if ctx.device_type == "gpu":
            assert ck.launch_counts()["dropout"] == before + 2
        outs[ctx.device_type] = ([t.asnumpy() for t in o],
                                 exe.grad_dict["data"].asnumpy())
    for a, b in zip(outs["cpu"][0], outs["gpu"][0]):
        assert np.array_equal(a, b)
    assert np.array_equal(outs["cpu"][1], outs["gpu"][1])
    draws = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        mx.random.seed(11)
        with ctx:
            u = mx.nd.random_uniform(low=-1.0, high=2.0, shape=(33, 7))
            w = mx.nd.zeros((64, 3, 3, 3))
        mx.initializer.Xavier()("c_weight", w)
        draws[ctx.device_type] = (u.asnumpy(), w.asnumpy())
    for a, b in zip(draws["cpu"], draws["gpu"]):
        assert np.array_equal(a, b)
    for dtype, name in (("float16", "uniform_f16"),
                        ("bfloat16", "uniform_bf16")):
        got = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            mx.random.seed(13)
            before = ck.launch_counts()[name]
            with ctx:
                u = mx.nd.random_uniform(low=-1.0, high=2.0, shape=(33, 7),
                                         dtype=dtype)
            if ctx.device_type == "gpu":
                assert ck.launch_counts()[name] == before + 1
            got[ctx.device_type] = u.astorch().cpu()
        assert torch.equal(got["cpu"], got["gpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_uniform_kernel_16bit(dev, dtype):
    """The 16-bit instances: uniform draws bit for bit the plain
    version's (the type's low random bits, float16's single rounding of
    the float32 product and sum, bfloat16's rounding at each op); normal
    and exponential within 1 ulp of the type (erfinvf / log1pf against
    PyTorch's, each rounded to the type); one launch a call, counted
    under its own counter."""
    name = {torch.bfloat16: "uniform_bf16", torch.float16: "uniform_f16"}[
        dtype]
    key = _tkey(9)

    def ulps(a, b):
        return int((a.view(torch.int16).long() -
                    b.view(torch.int16).long()).abs().max())
    for shape in ((1,), (7,), (3, 5, 11), (1 << 20,)):
        for lo, hi in ((0.0, 1.0), (-0.07, 0.07), (-2.5, 3.3)):
            before = ck.launch_counts()[name]
            got = ck.uniform(key, shape, lo, hi, device=dev, dtype=dtype)
            assert ck.launch_counts()[name] == before + 1
            assert got.dtype == dtype
            assert torch.equal(got.cpu(), ck.uniform_plain(
                key, shape, lo, hi, dtype=dtype))
        for tr in (mx.random.NORMAL, mx.random.EXPONENTIAL):
            got = ck.uniform(key, shape, transform=tr, device=dev,
                             dtype=dtype).cpu()
            assert ulps(got, ck.uniform_plain(key, shape, transform=tr,
                                              dtype=dtype)) <= 1


# ------------------------------------------ grid and index limits lifted
@pytest.mark.cuda
def test_bn_stats_one_channel_past_2_31_values(dev):
    """One channel of 2^31 + 1 bfloat16 values (4.3 GB; an odd plane, so
    the one-value walk): zeros but for values at both ends and past 2^31,
    so a 32-bit offset would miss them; the sums are exact."""
    hw = 2 ** 31 + 1
    x = torch.zeros((1, 1, 1, hw), dtype=torch.bfloat16, device=dev)
    x[0, 0, 0, 0] = 2.0
    x[0, 0, 0, 2 ** 31 - 1] = -1.0
    x[0, 0, 0, 2 ** 31] = 3.0
    before = ck.launch_counts()["bn_stats_bf16"]
    s, q = ck.bn_stats(x)
    assert ck.launch_counts()["bn_stats_bf16"] == before + 1
    assert float(s[0]) == 4.0 and float(q[0]) == 14.0
    del x
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_decode_attention_rows_past_one_grid(dev):
    """S past 16 x 65535 query rows: the window's tiles in two launches,
    against the plain version."""
    s = ck.DECODE_WIN_ROWS * ck.GRID_Y + 1
    q = _rnd(dev, 1, 1, s, 16, seed=1)
    kc, vc = _rnd(dev, 1, 1, 32, 16, seed=2), _rnd(dev, 1, 1, 32, 16, seed=3)
    pos = torch.tensor([3], dtype=torch.int32, device=dev)
    before = ck.launch_counts()["decode_attention"]
    got = ck.decode_attention(q, kc, vc, pos)
    assert ck.launch_counts()["decode_attention"] == before + 2
    _same(got, ck.decode_attention_plain(q, kc, vc, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.bfloat16, 16),
                                      (torch.float16, 16)])
def test_flash_attention_rows_past_one_grid(dev, dtype, dh):
    """Tq past the grid's y limit of query tiles (64 x 65535 in float32 at
    Dh 64, 128 x 65535 in 16 bits), non-causal over Tk 64: two launches,
    against the plain version."""
    tq = ck.flash_query_rows(dh, dtype) * ck.GRID_Y + 1
    q = _rnd(dev, 1, 1, tq, dh, seed=4).to(dtype)
    k, v = (_rnd(dev, 1, 1, 64, dh, seed=s).to(dtype) for s in (5, 6))
    name = "flash_attention" + {torch.float32: "", torch.bfloat16: "_bf16",
                                torch.float16: "_f16"}[dtype]
    before = ck.launch_counts()[name]
    got = ck.flash_attention(q, k, v, causal=False)
    assert ck.launch_counts()[name] == before + 2
    want = ck.flash_attention_plain(q, k, v, False)
    tol = TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ---------------------------------- checkpoint, Predictor, warm restarts
def _ckpt_mlp():
    data = mx.sym.var("data")
    act = mx.sym.Activation(mx.sym.FullyConnected(
        data, num_hidden=32, name="fc1"), act_type="relu")
    act = mx.sym.Dropout(act, p=0.3)
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        act, num_hidden=5, name="fc2"), name="softmax")


class _CkptKill(Exception):
    pass


def _ckpt_fit(ctx, kill_at=None, ckpt=None, resume=False, seed=7):
    rs = np.random.RandomState(0)
    X, y = rs.rand(48, 20).astype("f"), rs.randint(0, 5, 48).astype("f")
    mx.random.seed(seed)
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(_ckpt_mlp(), context=ctx)
    rs = np.random.RandomState(1)
    args = {"fc1_weight": rs.randn(32, 20) * 0.1, "fc1_bias": np.zeros(32),
            "fc2_weight": rs.randn(5, 32) * 0.1, "fc2_bias": np.zeros(5)}

    def cb(p):
        if (p.epoch, p.nbatch) == kill_at:
            raise _CkptKill()
    mgr = mx.checkpoint.CheckpointManager(ckpt, every_n_batches=2) \
        if ckpt else None
    try:
        mod.fit(it, num_epoch=2, batch_end_callback=cb, optimizer="adam",
                arg_params=mx.convert.params_from_numpy(
                    {k: v.astype("f") for k, v in args.items()}, mx.cpu()),
                optimizer_params={"learning_rate": 0.01, "lr_scheduler":
                                  mx.lr_scheduler.FactorScheduler(4, 0.5)},
                checkpoint=mgr, resume=resume)
    except _CkptKill:
        pass
    finally:
        if mgr is not None:
            mgr.close()
    return mod


@pytest.mark.cuda
def test_checkpoint_kill_resume_on_card_bit_for_bit(dev, tmp_path):
    """A CUDA module killed at (1, 2) resumes in a fresh one under another
    seed and ends bit for bit on the uninterrupted card fit: parameters,
    Adam states, counts; the resumed fit launches adam_multi and dropout
    on the card."""
    ctx = mx.gpu(0)
    full = _ckpt_fit(ctx)
    d = str(tmp_path / "ck")
    _ckpt_fit(ctx, kill_at=(1, 2), ckpt=d)
    before = ck.launch_counts()
    resumed = _ckpt_fit(ctx, resume=d, seed=99)
    after = ck.launch_counts()
    for name in ("adam_multi", "dropout"):
        assert after[name] > before[name], name
    a, b = full.get_params()[0], resumed.get_params()[0]
    for k in a:
        assert torch.equal(a[k].astorch(), b[k].astorch()), k
    for i, st in full._updater.states.items():
        for x, z in zip(st, resumed._updater.states[i]):
            assert torch.equal(x.astorch(), z.astorch())
    assert full._opt_counts() == resumed._opt_counts()


@pytest.mark.cuda
def test_checkpoint_capture_on_card_is_not_torn(dev, tmp_path, monkeypatch):
    """The writer is held back before its device-to-host copy while two
    more steps update the weights and Adam states in place on the card;
    the commit holds the values of the captured step."""
    from mxnet_tpu_torch.checkpoint import state as cstate
    import threading
    mod = _ckpt_fit(mx.gpu(0))
    want = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    release, entered = threading.Event(), threading.Event()
    plain = cstate.to_host

    def held(snap):
        entered.set()
        assert release.wait(60)
        return plain(snap)
    monkeypatch.setattr(cstate, "to_host", held)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(mod, 2, 0)
    assert entered.wait(60)
    rs = np.random.RandomState(3)
    it = mx.io.NDArrayIter(rs.rand(16, 20).astype("f"),
                           rs.randint(0, 5, 16).astype("f"), batch_size=8)
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
    assert not np.array_equal(mod.get_params()[0]["fc1_weight"].asnumpy(),
                              want["fc1_weight"])
    release.set()
    mgr.wait()
    mgr.close()
    _, _, payload = mx.checkpoint.read_committed_payload(str(tmp_path /
                                                             "ck"))
    for k, v in want.items():
        assert np.array_equal(payload["device"]["arg_params"][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_predictor_on_card_matches_cpu(dev, tmp_path, quantize):
    """The same artifact through a Predictor on the card and on the CPU:
    float32 within 1e-5, int8 within 1e-5 of the largest logit (the
    quantized kernels sum in another order), with the quantized kernels
    launched on the card."""
    data = mx.sym.var("data")
    c = mx.sym.Activation(mx.sym.Convolution(
        data, kernel=(3, 3), num_filter=8, pad=(1, 1), name="conv1"),
        act_type="relu")
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(c), num_hidden=6, name="fc"), name="softmax")
    shapes = {"data": (4, 3, 8, 8)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(0)
    params = {n: (0.3 * rs.randn(*s)).astype("f")
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    path = str(tmp_path / "m.mxt")
    mx.export_model(path, sym, mx.convert.params_from_numpy(params, mx.cpu()),
                    {}, shapes, quantize=quantize)
    x = rs.rand(*shapes["data"]).astype("f")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = ck.launch_counts()
        got = mx.Predictor(path).forward(data=x)[0].asnumpy()
        after = ck.launch_counts()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    want = mx.Predictor(path, device=mx.cpu()).forward(data=x)[0].asnumpy()
    assert after["softmax"] == before["softmax"] + 1
    if quantize:
        assert after["qfc_matmul"] == before["qfc_matmul"] + 1
        assert after["dequant_rows_multi"] == before["dequant_rows_multi"] + 1
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.cuda
def test_restore_server_on_card_builds_nothing_after_warmup(dev, tmp_path):
    """A card server (a bucket model and a Predictor) committed with
    ``checkpoint_to`` and restored with ``restore_server`` answers the
    same requests with the same outputs and no kernel build after
    warmup."""
    data = mx.sym.var("data")
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=6, name="fc"), name="softmax")
    rs = np.random.RandomState(0)
    params = {"fc_weight": rs.randn(6, 12).astype("f"),
              "fc_bias": rs.randn(6).astype("f")}
    path = str(tmp_path / "m.mxt")
    mx.export_model(path, sym, mx.convert.params_from_numpy(params, mx.cpu()),
                    {}, {"data": (4, 12)})
    clock = mx.serve.FakeClock()
    server = mx.serve.InferenceServer(clock=clock)
    server.register("b", symbol=sym,
                    arg_params=mx.convert.params_from_numpy(params, mx.cpu()),
                    aux_params={}, data_shapes={"data": (12,)},
                    ladder=[1, 4], context=mx.gpu(0))
    server.register("p", predictor=path)
    xs = [rs.rand(r, 12).astype("f") for r in (1, 3, 4)]

    def answers(srv):
        out = []
        for m in ("b", "p"):
            for x in xs:
                h = srv.submit({"data": x}, model=m)
                srv._clock.advance(1.0)
                srv.pump()
                out.append(h.result(timeout=0)[0].asnumpy())
        return out
    want = answers(server)
    server.checkpoint_to(str(tmp_path / "ck"))
    del server
    restored = mx.serve.restore_server(str(tmp_path / "ck"),
                                       clock=mx.serve.FakeClock())
    for g, w in zip(answers(restored), want):
        assert np.array_equal(g, w)
    assert restored.stats()["compiles_since_warmup"] == 0


# --------------------------------------------------------------------------
# the tensor surface on the card (plain PyTorch ops, no kernel of their own)
# --------------------------------------------------------------------------
_TIED = np.array([[3, 1, 3, 2, 1, 3, 0, 3] * 8,
                  [0] * 64,
                  list(range(32)) * 2], np.float32)


def _nd_both(name, x, **attrs):
    """``mx.nd.<name>`` on gpu(0) and on the CPU: (card, CPU) as numpy
    lists."""
    out = []
    for ctx in (mx.gpu(0), mx.cpu()):
        res = getattr(mx.nd, name)(mx.nd.array(x, ctx=ctx), **attrs)
        out.append([r.asnumpy() for r in (res if isinstance(res, list)
                                          else [res])])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,attrs", [
    ("sort", {"is_ascend": a}) for a in (True, False)] + [
    ("argsort", {"is_ascend": a, "axis": ax}) for a in (True, False)
    for ax in (-1, 0)] + [
    ("topk", {"k": k, "ret_typ": r, "is_ascend": a})
    for k in (1, 5, 40) for r in ("indices", "value", "both", "mask")
    for a in (False, True)])
def test_ordering_with_ties_on_card_equals_cpu(dev, name, attrs):
    """Ties: the stable sort flipped for is_ascend=False, topk the lower
    index first (torch.topk orders ties arbitrarily on the card)."""
    rows = np.concatenate([_TIED, np.random.RandomState(3).randint(
        0, 5, (5, 64)).astype(np.float32)])
    card, cpu = _nd_both(name, rows, **attrs)
    assert len(card) == len(cpu)
    for g, w in zip(card, cpu):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.cuda
def test_ordering_ties_at_the_lm_head_width(dev):
    """(8, 32000) rows of few distinct values: every row is ties."""
    x = np.random.RandomState(1).randint(0, 7, (8, 32000)).astype(np.float32)
    for asc in (False, True):
        for ret in ("both", "mask"):
            card, cpu = _nd_both("topk", x, k=40, ret_typ=ret, is_ascend=asc)
            assert all(np.array_equal(g, w) for g, w in zip(card, cpu))
        card, cpu = _nd_both("argsort", x, is_ascend=asc)
        assert np.array_equal(card[0], cpu[0])


@pytest.mark.cuda
def test_creation_ops_land_on_the_card(dev):
    made = [mx.nd.ones((2, 3), ctx=mx.gpu(0)),
            mx.nd.full((4,), 2.5, ctx=mx.gpu(0)),
            mx.nd.empty((3,), ctx=mx.gpu(0)),
            mx.nd.arange(0, 6, 2, ctx=mx.gpu(0))]
    with mx.gpu(0):
        made += [mx.nd._zeros(shape=(2, 2)), mx.nd._ones(shape=(3,)),
                 mx.nd._full(shape=(2,), value=1.5), mx.nd._arange(start=4),
                 mx.nd.zeros((2,))]
    for a in made:
        assert a.astorch().device.type == "cuda", a
    assert made[2].asnumpy().tolist() == [0.0, 0.0, 0.0]
    ex = mx.sym.ones((2, 3), dtype="int32").simple_bind(ctx=mx.gpu(0))
    out = ex.forward()[0]
    assert out.astorch().device.type == "cuda" and out.dtype == np.int32


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_mul_scalar", "_add_scalar",
                                  "_div_scalar", "_mod_scalar",
                                  "_rsub_scalar", "_maximum_scalar",
                                  "_equal_scalar", "_power_scalar"])
def test_integer_scalar_ops_keep_their_dtype_on_card(dev, name):
    x = np.array([[3, -3, 7], [1, 5, -8]], np.int32)
    card, cpu = _nd_both(name, x, scalar=2.5)
    want = np.float32 if name == "_div_scalar" else np.int32  # true division
    assert card[0].dtype == cpu[0].dtype == want
    assert np.array_equal(card[0], cpu[0])
    if name == "_mul_scalar":
        assert card[0].tolist() == [[6, -6, 14], [2, 10, -16]]


# --------------------------------------------------------------------------
# the remaining nn layers and losses, DCGAN
# --------------------------------------------------------------------------
@pytest.fixture
def no_tf32():
    """cuDNN's convolutions in full float32 (its default is TF32)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _op_both(name, arrays, attrs, seed=0, train=True):
    """``name`` as a one-node graph on the card and on the CPU: a training
    forward after mx.random.seed(seed), a backward from the same head
    gradients; [(outputs, {input: gradient})] as numpy, card first."""
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        node = getattr(mx.sym, name)(*[mx.sym.var(k) for k in arrays],
                                     name="t", **attrs)
        ex = node.simple_bind(ctx=ctx, grad_req="write",
                              **{k: v.shape for k, v in arrays.items()})
        mx.random.seed(seed)
        outs = ex.forward(is_train=train, **{
            k: mx.nd.array(v, ctx=ctx) for k, v in arrays.items()})
        rs = np.random.RandomState(seed)
        if train:
            ex.backward([mx.nd.array(rs.uniform(0.5, 1.5, o.shape).astype(
                np.float32), ctx=ctx) for o in outs])
        runs.append(([o.asnumpy() for o in outs],
                     {k: ex.grad_dict[k].asnumpy() for k in arrays}))
    return runs


def _agree(card, cpu, tol=TOL):
    for g, w in zip(card[0], cpu[0]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    for k, w in cpu[1].items():
        assert np.abs(card[1][k] - w).max() <= 1e-5 * max(
            float(np.abs(w).max()), 1e-30), k


@pytest.mark.cuda
def test_roi_pooling_at_fast_rcnn_shape_within_its_peak_memory(dev):
    """128 ROIs over VGG-16's conv5_3 of a 600 x 800 image (512 x 38 x 50,
    scale 1/16, 7 x 7 bins): the card's output equals the CPU's (a max),
    its backward allocates under 1 GiB beyond the inputs (the chunks are
    recomputed), and each non-empty cell's gradient reaches the image."""
    from mxnet_tpu_torch.ops import nn as tnn
    rs = np.random.RandomState(0)
    data = np.maximum(rs.randn(1, 512, 38, 50), 0).astype(np.float32)
    x1, y1 = rs.uniform(0, 760, 128), rs.uniform(0, 560, 128)
    rois = np.stack([np.zeros(128), x1, y1,
                     np.minimum(x1 + rs.uniform(16, 400, 128), 799),
                     np.minimum(y1 + rs.uniform(16, 300, 128), 599)],
                    1).astype(np.float32)
    attrs = {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}
    want = tnn._roi_pooling(attrs, torch.tensor(data), torch.tensor(rois))
    x = torch.tensor(data, device=dev, requires_grad=True)
    r = torch.tensor(rois, device=dev)
    out = tnn._roi_pooling(attrs, x, r)
    assert torch.equal(out.detach().cpu(), want)
    g = torch.rand(out.shape, device=dev,
                   generator=torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grad, = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1 << 30
    _, ym, xm = tnn.roi_bins(r, 1.0 / 16, (7, 7), (38, 50), 1)
    full = ym.any(-1)[:, None, :, None] & xm.any(-1)[:, None, None]
    torch.testing.assert_close(grad.sum(), (g * full).sum(), rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("attrs,shape", [
    ({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (2, 3),
      "num_filter": 3}, (2, 2, 3, 4)),
    ({"kernel": (2, 3), "stride": (1, 2), "pad": (0, 1), "adj": (1, 1),
      "num_filter": 2, "num_group": 2}, (1, 2, 3, 3)),
    ({"kernel": (2, 2), "stride": (3, 3), "pad": (2, 2), "num_filter": 2},
     (1, 2, 4, 4)),
    ({"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "num_filter": 64,
      "no_bias": False}, (8, 128, 8, 8)),
])
def test_deconvolution_with_adj_at_the_stride_on_card(dev, no_tf32, attrs,
                                                      shape):
    """``adj`` at or past the stride and padding past k - 1 (PyTorch's
    ``conv_transpose`` refuses both: the output is cropped and padded
    instead), and DCGAN's layer, card vs CPU."""
    rs = np.random.RandomState(2)
    ng = attrs.get("num_group", 1)
    arrays = {"data": rs.uniform(-1, 1, shape).astype(np.float32),
              "weight": rs.uniform(-1, 1, (shape[1], attrs["num_filter"] //
                                           ng) + attrs["kernel"]).astype(
                                               np.float32)}
    if not attrs.get("no_bias", True):
        arrays["bias"] = rs.uniform(-1, 1, attrs["num_filter"]).astype(
            np.float32)
    card, cpu = _op_both("Deconvolution", arrays, attrs)
    _agree(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("attrs,corner", [
    ({"num_args": 1, "offset": (4, 3), "h_w": (3, 3)}, (2, 3)),
    ({"num_args": 1, "offset": (-1, 9), "h_w": (4, 2)}, (1, 4)),
    ({"num_args": 1, "h_w": (3, 3), "center_crop": True}, (1, 1))])
def test_crop_clamps_its_offset_on_card(dev, attrs, corner):
    """``lax.dynamic_slice``'s start: a negative one counted from the end,
    then clamped so the window fits (``corner``)."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 2, 5, 6)).astype(
        np.float32)
    card, cpu = _op_both("Crop", {"data": x}, attrs)
    assert np.array_equal(card[0][0], cpu[0][0])
    assert np.array_equal(card[1]["data"], cpu[1]["data"])
    (oy, ox), (h, w) = corner, attrs["h_w"]
    assert np.array_equal(card[0][0], x[:, :, oy:oy + h, ox:ox + w])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 16), (64, 256, 8, 8)])
def test_rrelu_slopes_on_card_are_the_cpus_bit_for_bit(dev, shape):
    """rrelu's training slopes: the threefry kernel's uniform draws under
    the node's key (one launch), the CPU's plain draws bit for bit."""
    x = np.random.RandomState(4).uniform(-1, 1, shape).astype(np.float32)
    attrs = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.6}
    before = ck.launch_counts()["uniform"]
    card, cpu = _op_both("LeakyReLU", {"data": x}, attrs, seed=5)
    assert ck.launch_counts()["uniform"] == before + 1
    assert np.array_equal(card[0][0], cpu[0][0])
    assert np.array_equal(card[1]["data"], cpu[1]["data"])
    card, cpu = _op_both("LeakyReLU", {"data": x}, attrs, train=False)
    assert np.array_equal(card[0][0], cpu[0][0])


@pytest.mark.cuda
def test_dcgan_iteration_on_card_matches_cpu(dev, no_tf32):
    """One iteration of examples/dcgan.py's loop through two Modules
    (chip_smoke's copy of it) at ngf = ndf = 16, batch 8, card vs CPU from
    the same parameters and noise (``chip_smoke.dcgan_parity``: outputs
    and moving statistics within 1e-5, every parameter within 2 lr +
    1e-5, and the share of a module's elements past 1e-5, where Adam's
    first step took the other sign of a gradient within float32 noise of
    0, within 3 times the CPU's own share from parameters one ulp away,
    plus 1e-4), and one ``adam_multi`` launch a ``Module.update``."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    rs = np.random.RandomState(6)
    init = cs.dcgan_modules(mx, mx.cpu(), 8, 16, 16, 100,
                            rng=torch.Generator().manual_seed(0))
    params = [tuple({k: v.asnumpy() for k, v in d.items()}
                    for d in m.get_params()) for m in init]
    ck.reset_launch_counts()
    cs.dcgan_parity(mx, params, rs.randn(8, 100, 1, 1).astype(np.float32),
                    cs.real_blobs(rs, 8))
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        {"adam_multi": 2}


# --------------------------------------------------------------------------
# the contrib ops
# --------------------------------------------------------------------------
def _grid(n):
    """A (1, 2 n^2, 4) grid of anchors 0.2 and 0.4 wide."""
    c = (np.arange(n) + 0.5) / n
    cy, cx = np.meshgrid(c, c, indexing="ij")
    boxes = [np.stack([cx - h, cy - h, cx + h, cy + h], -1).reshape(-1, 4)
             for h in (0.1, 0.2)]
    return np.concatenate(boxes)[None].astype(np.float32)


def _contrib(name, tensors, attrs):
    op = mx.ops.get_op(name)
    return op.forward(op.normalize_attrs(attrs), tensors, [], False,
                      None)[0]


@pytest.mark.cuda
def test_nms_ops_repeat_bit_for_bit_on_card(dev):
    """MultiBoxDetection and MultiProposal (their NMS loops over the whole
    batch's masks, stable sorts) twice on the card: the same bits, and
    the CPU's ids and ordering."""
    rs = np.random.RandomState(7)
    anchor = torch.tensor(_grid(8), device=dev)
    cls = torch.tensor(rs.dirichlet(np.ones(3), (4, 128)).transpose(
        0, 2, 1).astype(np.float32), device=dev)
    loc = torch.tensor(rs.uniform(-0.2, 0.2, (4, 512)).astype(np.float32),
                       device=dev)
    attrs = {"nms_threshold": 0.3, "threshold": 0.05}
    a = _contrib("MultiBoxDetection", [cls, loc, anchor], attrs)[0]
    b = _contrib("MultiBoxDetection", [cls, loc, anchor], attrs)[0]
    want = _contrib("MultiBoxDetection", [t.cpu() for t in (cls, loc,
                                                            anchor)], attrs)[0]
    assert torch.equal(a, b)
    assert torch.equal(a[..., 0].cpu(), want[..., 0])
    torch.testing.assert_close(a.cpu(), want, rtol=2e-5, atol=2e-5)
    ins = [torch.tensor(rs.uniform(0, 1, (2, 24, 6, 7)).astype(np.float32),
                        device=dev),
           torch.tensor(rs.uniform(-0.2, 0.2, (2, 48, 6, 7)).astype(
               np.float32), device=dev),
           torch.tensor([[96.0, 112.0, 1.0], [80.0, 100.0, 0.8]], device=dev)]
    attrs = {"feature_stride": 16, "scales": (1.0, 2.0, 4.0, 8.0),
             "rpn_pre_nms_top_n": 300, "rpn_post_nms_top_n": 50,
             "rpn_min_size": 4, "output_score": True}
    a = _contrib("MultiProposal", ins, attrs)
    b = _contrib("MultiProposal", ins, attrs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_multibox_target_forced_match_is_deterministic_on_card(dev):
    """Label rows that pick the same best anchor (a padding row after a
    valid box whose best anchor is 0, and two boxes over one anchor): the
    last row decides, on the card as on the CPU, every run."""
    anchor = torch.tensor(_grid(4))
    label = torch.tensor([[[1, 0.0, 0.0, 0.15, 0.15], [-1, 0, 0, 0, 0],
                           [0, 0.3, 0.3, 0.5, 0.5], [1, 0.32, 0.3, 0.52,
                                                     0.5]],
                          [[0, 0.6, 0.6, 0.9, 0.9], [0, 0.6, 0.62, 0.9,
                                                     0.92],
                           [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]]])
    cls = torch.tensor(np.random.RandomState(8).uniform(
        -1, 1, (2, 3, 32)).astype(np.float32))
    attrs = {"negative_mining_ratio": 3}
    want = _contrib("MultiBoxTarget", [anchor, label, cls], attrs)
    runs = [_contrib("MultiBoxTarget", [t.to(dev) for t in (anchor, label,
                                                           cls)], attrs)
            for _ in range(3)]
    for got in runs:
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-5,
                                   atol=2e-5)
    assert want[1][0, :4].tolist() == [0.0] * 4   # the padding row's write


@pytest.mark.cuda
def test_count_sketch_on_card_matches_cpu(dev):
    """``index_add_`` sums in no fixed order on the card: within 1e-6 of
    the largest magnitude of the CPU's sketch, hashes negative included."""
    rs = np.random.RandomState(9)
    data = rs.randn(64, 4096).astype(np.float32)
    h = rs.randint(-3000, 3000, (1, 4096)).astype(np.float32)
    s = np.where(rs.rand(1, 4096) < 0.5, -1, 1).astype(np.float32)
    attrs = {"out_dim": 512}
    want = _contrib("count_sketch", [torch.tensor(a) for a in (data, h, s)],
                    attrs)[0]
    got = _contrib("count_sketch", [torch.tensor(a, device=dev)
                                    for a in (data, h, s)], attrs)[0]
    assert (got.cpu() - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_and_gradient_on_card_match_cpu(dev, lengths):
    """T 50, batch 8, 12 classes, labels up to 10 (a zero-length one among
    them): the loss within 2e-5 card vs CPU; the gradient as near the
    CPU's float64 gradient as 3 times the CPU's float32 one (alpha
    reaches about -200, where a float32 ulp is 1.5e-5)."""
    rs = np.random.RandomState(10)
    T, N, C, L = 50, 8, 12, 10
    label = np.zeros((N, L), np.float32)
    lens = rs.randint(0, L + 1, N)
    lens[0] = 0
    for i, k in enumerate(lens):
        label[i, :k] = rs.randint(1, C, k)
    data = rs.randn(T, N, C).astype(np.float32)
    attrs, extra = {}, []
    if lengths:
        attrs = {"use_data_lengths": True, "use_label_lengths": True}
        extra = [rs.randint(30, T + 1, N).astype(np.float32),
                 lens.astype(np.float32)]
    head = rs.uniform(0.5, 1.5, N)
    out = []
    for where, dt in (("cpu", torch.float64), ("cpu", torch.float32),
                      (dev, torch.float32)):
        x = torch.tensor(data, device=where, dtype=dt, requires_grad=True)
        rest = [torch.tensor(a, device=where) for a in [label] + extra]
        loss = _contrib("CTCLoss", [x] + rest, attrs)[0]
        g, = torch.autograd.grad(loss, x, torch.tensor(head, device=where,
                                                       dtype=dt))
        out.append((loss.detach().cpu().double(), g.cpu().double()))
    (_, g64), (lw, gw), (lg, gg) = out
    torch.testing.assert_close(lg, lw, rtol=2e-5, atol=2e-5)
    assert (gg - g64).abs().max() <= 3 * (gw - g64).abs().max()
