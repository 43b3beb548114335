"""The BatchNorm statistics kernel (``csrc/bn_stats.cu``, row 7) on the CPU.

The kernel sums each channel in one launch: a grid of (channel groups,
splits of N) planned on the host from the shape alone
(``cuda_kernels._bn_stats_plan``), planes of one channel or slabs of a few
channels a block, each block's lanes combined in a fixed tree and the
splits of a group (one thread-block cluster, at most eight) added in
split order by its first block. The kernel runs
only on a card; here ``tests/bn_stats_emul.py`` emulates its order of
work in numpy float32 with the wrapper's own plan (132 SMs, an H100's)
and is held, on the same numpy-seeded values, within 1e-5 of each
channel's sum of squares (float32 sums in other orders; it bounds the sum
too, since sum(x)^2 <= n sum(x^2)) to

* the JAX package's Pallas kernel ``_pl_channel_stats`` in interpret mode,
  in float32, bfloat16 and float16, and
* the port's plain version, ``bn_stats_plain``, what a CPU tensor runs,

at HW = 1, 7 x 7 (ResNet-50's stage 4: slabs), 15, 14 x 14 (stage 3:
slabs in 16 bits), 56 x 56, with C = 1, N = 1 and enough rows for many
splits, x 16-byte aligned or not. Then the plan: ResNet-50's 33 tensors
each in one wave of the grid, their routes; and FusedConvBNReLU's
``autograd.Function``, which no longer fills zero cotangents for the
moving statistics: a fused net's gradients bit for bit those of the same
step with them filled.
"""
import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.registry import get_op as torch_op

from bn_stats_emul import bn_stats_emul
from test_torch_fused_cbr import BN, IMAGE, NARROW, fused_resnet

SMS = 132
TOL = 1e-5
#: dtype -> (torch dtype, numpy type of the values handed to JAX, bytes)
DTYPES = {"float32": (torch.float32, np.float32, 4),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16, 2),
          "float16": (torch.float16, np.float16, 2)}
SHAPES = [(2, 8, 1, 1), (4, 64, 1, 1), (3, 16, 7, 7), (2, 40, 7, 7),
          (1, 4, 3, 5), (2, 3, 3, 5), (5, 1, 7, 7), (1, 1, 1, 1),
          (2, 16, 14, 14), (3, 8, 56, 56), (600, 2, 2, 2)]
#: the stages of ResNet-50's fused step at batch 32: (C, HW) of its 33
#: Conv -> BatchNorm -> ReLU outputs and how many there are of each
RESNET50_CBR = [((64, 112 * 112), 1), ((64, 56 * 56), 6),
                ((128, 56 * 56), 1), ((128, 28 * 28), 7),
                ((256, 28 * 28), 1), ((256, 14 * 14), 11),
                ((512, 14 * 14), 1), ((512, 7 * 7), 5)]


def _within(got, want_s, want_q, sq):
    bound = TOL * np.asarray(sq, np.float64) + 1e-30
    for g, w in zip(got, (want_s, want_q)):
        assert (np.abs(np.asarray(g, np.float64) -
                       np.asarray(w, np.float64)) <= bound).all()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_pallas_and_plain(shape, dtype, aligned):
    t_dt, np_dt, size = DTYPES[dtype]
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy((3 * rs.randn(*shape) + 1).astype(
        np.float32)).to(t_dt)
    got = bn_stats_emul(x.float().numpy(), size, aligned, SMS)
    ps, pq = ck.bn_stats_plain(x)
    _within(got, ps.numpy(), pq.numpy(), pq.numpy())
    js, jq = pk._pl_channel_stats(jnp.asarray(x.float().numpy().astype(
        np_dt)))
    _within(got, js, jq, pq.numpy())


def test_emulation_sums_exactly_where_float32_is_exact():
    """Small integers: every order gives the exact sums."""
    rs = np.random.RandomState(3)
    for shape in SHAPES:
        x = rs.randint(-8, 9, shape).astype(np.float32)
        want = (x.sum(axis=(0, 2, 3)), (x * x).sum(axis=(0, 2, 3)))
        for size in (4, 2):
            for aligned in (True, False):
                s, q = bn_stats_emul(x, size, aligned, SMS)
                np.testing.assert_array_equal(s, want[0])
                np.testing.assert_array_equal(q, want[1])


@pytest.mark.parametrize("size", [4, 2])
def test_plan_of_resnet50(size):
    """Every tensor of the fused step in one wave of about four blocks an
    SM; HW 49 (and 196 in 16 bits) as slabs of a power of two of channels
    whose every row is one aligned run, the rest as planes, 16 bytes a
    load."""
    vec = 16 // size
    for (c, hw), _count in RESNET50_CBR:
        route, v, group, stage, rows, splits = ck._bn_stats_plan(
            32, c, hw, size, True, SMS)
        assert v == vec and rows * splits >= 32 > rows * (splits - 1)
        blocks = -(-c // group) * splits
        assert ck.BN_STATS_BLOCKS_PER_SM * SMS // 2 <= blocks <= \
            ck.BN_STATS_BLOCKS_PER_SM * SMS
        if hw % vec:
            assert route == ck.BN_SLABS and (group * hw) % vec == 0
            assert group & (group - 1) == 0 and group <= 256
            assert stage * group * hw // vec <= \
                ck.BN_STATS_LOADS * ck.BN_STATS_THREADS
        else:
            assert route == ck.BN_PLANES and group == 1
    assert sum(n for _, n in RESNET50_CBR) == 33


def test_plan_falls_back_to_one_value_a_load():
    """x not 16-byte aligned, or no slab that is one aligned run: planes,
    one value a load."""
    assert ck._bn_stats_plan(32, 64, 3136, 4, False, SMS)[:3] == \
        (ck.BN_PLANES, 1, 1)
    assert ck._bn_stats_plan(2, 3, 15, 4, True, SMS)[:3] == \
        (ck.BN_PLANES, 1, 1)
    assert ck._bn_stats_plan(0, 3, 49, 4, True, SMS)[4:] == (0, 1)


# ------------------------------------------------ the fused op's backward
def _fused_step(monkeypatch, materialize):
    """One fused narrow-net step on the CPU through FusedConvBNReLU's CUDA
    variant (its autograd.Function; its kernels are their plain halves on
    CPU tensors): the gradients and the new moving statistics."""
    op = torch_op("FusedConvBNReLU")
    monkeypatch.setattr(op, "forward", op.variants["cuda"]["fn"])
    if materialize:
        forward = ck._ConvBNReLUFn.forward

        def filled(ctx, *args):
            out = forward(ctx, *args)
            ctx.set_materialize_grads(True)
            return out
        monkeypatch.setattr(ck._ConvBNReLUFn, "forward",
                            staticmethod(filled))
    rs = np.random.RandomState(5)
    X = rs.rand(2, *IMAGE).astype(np.float32)
    y = rs.randint(0, 10, 2).astype(np.float32)
    with mxt.name.NameManager():
        sym = fused_resnet(mxt.sym, **NARROW)
    mod = mxt.mod.Module(sym, context=mxt.cpu())
    mod.bind([("data", X.shape)], [("softmax_label", y.shape)])
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    cpu = mxt.cpu()
    mod.forward_backward(mxt.io.DataBatch([mxt.nd.array(X, ctx=cpu)],
                                          [mxt.nd.array(y, ctx=cpu)]))
    exe = mod._exec_group.executor
    return ({k: v.asnumpy() for k, v in exe.grad_dict.items()},
            {k: v.asnumpy() for k, v in exe.aux_dict.items()})


def test_fused_grads_unchanged_without_filled_cotangents(monkeypatch):
    with monkeypatch.context() as m:
        grads, auxs = _fused_step(m, materialize=False)
    with monkeypatch.context() as m:
        ref_grads, ref_auxs = _fused_step(m, materialize=True)
    assert sorted(grads) == sorted(ref_grads)
    assert any(np.abs(g).max() > 0 for g in grads.values())
    for k in ref_grads:
        np.testing.assert_array_equal(grads[k], ref_grads[k], err_msg=k)
    for k in ref_auxs:
        np.testing.assert_array_equal(auxs[k], ref_auxs[k], err_msg=k)


def test_fused_fn_with_only_its_statistics_read():
    """A graph that reads only the new moving statistics (no gradient):
    the Function's backward is not reached; one that reads y alone gets
    the plain composition's gradients bit for bit."""
    attrs = torch_op("FusedConvBNReLU").normalize_attrs(
        dict(kernel=(3, 3), num_filter=6, pad=(1, 1), **BN))
    rs = np.random.RandomState(1)
    arrays = [rs.randn(2, 4, 9, 9), 0.3 * rs.randn(6, 4, 3, 3),
              rs.rand(6) + 0.5, rs.randn(6), 0.1 * rs.randn(6),
              rs.rand(6) + 0.5]
    ts = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    leaves = [t.clone().requires_grad_(True) for t in ts[:4]]
    y, new_mean, new_var = ck.conv_bn_relu_fn(attrs, *leaves, *ts[4:], True)
    assert not new_mean.requires_grad and not new_var.requires_grad
    ct = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    got = torch.autograd.grad(y, leaves, ct)
    plain = [t.clone().requires_grad_(True) for t in ts[:4]]
    ref_y, _ = ck.cbr_plain(attrs, *plain, *ts[4:], True)
    want = torch.autograd.grad(ref_y, plain, ct)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
