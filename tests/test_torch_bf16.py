"""Mixed precision (``compute_dtype="bfloat16"`` and ``"float16"``):
``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU at small sizes. Each
test runs for both 16-bit types where it is the same test; "bfloat16"
below stands for either, with its ulp (2^-7 relative for bfloat16, 2^-10
for float16).

The JAX package's mixed precision casts every floating argument and aux
state to bfloat16 where the graph reads it (labels of loss heads
excepted), keeps the bound arrays float32, and runs its Pallas kernels
on bfloat16: each reads bfloat16, computes in float32 and stores
bfloat16. Held here:

* the four kernels on the bfloat16 ResNet path — their plain versions
  against the JAX package's Pallas kernels in interpret mode on the same
  bfloat16 inputs: softmax, the cross-entropy gradient and the apply pass
  within one bfloat16 ulp (the two sum a row, and round ``x * scale +
  shift``, at other places in float32, which can move a value across a
  bfloat16 rounding boundary), the channel statistics within 1e-5 of each
  channel's sum of squares (float32 sums in another order);
* the executor's cast: arguments and aux states cast, labels exempt (ids
  257 and 999 would round to 256 and 1000 in bfloat16), and master
  weights, gradients, optimizer states and moving statistics float32;
* a narrow ResNet, plain and fused: its forward (inference and training)
  against the JAX package's ``Module(compute_dtype=jnp.bfloat16)`` from
  the same parameters, and the same comparison in float32 for the
  algorithm; a two-batch ``fit`` at lr 0.01; ``mx.serve.serve`` against
  the JAX package's ``InferenceServer``;
* float16 is taken by every entry point, and a type with no mixed
  precision (or no kernel instance) raises, naming it.

Tolerances in bfloat16, each with its reason: the frameworks round at
other places. XLA on the CPU keeps float32 between the elementwise ops
it fuses (a bfloat16 BatchNorm is then one rounding, PyTorch's four),
and the two accumulate convolutions in other orders, so a ResNet's
bfloat16 outputs drift apart by a few bfloat16 ulps (2^-8 relative)
with depth: probabilities within 2e-2 (five ulps at 1), against 1e-5 in
float32. float16's ulp is eight times finer, and so is its limit:
2.5e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.nn import weak_scalar

from test_torch_fused_cbr import (IMAGE, NARROW, _init_params, _renamed,
                                  fused_resnet)

CPU = mxt.cpu()
BF16 = torch.bfloat16
# lr 0.01: a narrow ResNet fitted at 0.1 is chaotic (test_torch_fused_cbr)
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
PROB_TOL_BF16 = 2e-2       # ResNet probabilities, bfloat16 (see above)
PROB_TOL_F32 = 1e-5        # the same in float32: the algorithm
#: compute dtype -> (torch dtype, jax dtype, mantissa bits, smallest
#: normal exponent, ResNet probability limit: 2.56 ulps at 1)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 7, -126, PROB_TOL_BF16),
        "float16": (torch.float16, jnp.float16, 10, -14, 2.5e-3)}
HALVES = list(HALF)


def _bf16(a, dtype="bfloat16"):
    """numpy float32 -> (torch, jax) arrays of the 16-bit ``dtype``, both
    rounded to nearest even from the same values."""
    a = np.asarray(a, np.float32)
    tdt, jdt = HALF[dtype][:2]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(x):
    """A torch or jax array as numpy float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a, b, dtype="bfloat16"):
    """Largest |a - b| in ulps of ``dtype`` at the larger magnitude
    (values below the normal range count in ulps of the smallest
    normal)."""
    bits, emin = HALF[dtype][2:4]
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** emin)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - bits)
    return float((np.abs(a - b) / ulp).max())


# ------------------------------------------------------------ the kernels
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(8, 10), (4, 1000), (3, 1025)])
def test_softmax_plain_bf16_matches_pallas(shape, dtype):
    x = 4 * np.random.RandomState(0).randn(*shape)
    tx, jx = _bf16(x, dtype)
    got, want = ck.softmax_plain(tx), pk._pl_softmax(jx)
    assert got.dtype == tx.dtype and want.dtype == jx.dtype
    assert _ulps(got, want, dtype) <= 1


@pytest.mark.parametrize("attrs", [
    {}, {"normalization": "batch"},
    {"use_ignore": True, "ignore_label": 257, "normalization": "valid"}],
    ids=["null", "batch", "ignore_valid"])
@pytest.mark.parametrize("dtype", HALVES)
def test_softmax_ce_grad_plain_bf16_matches_pallas(attrs, dtype):
    rs = np.random.RandomState(1)
    n, c = 6, 1000
    tx, jx = _bf16(4 * rs.randn(n, c), dtype)
    # ids past 256 that bfloat16 would round away: 257 -> 256, 999 -> 1000
    label = np.asarray([257, 999, 300, 0, 1000, -1], np.float32)
    _, vjp = jax.vjp(lambda d: pk.fused_softmax_ce(
        d, jnp.asarray(label), **attrs), jx)
    want, = vjp(jnp.zeros((n, c), jx.dtype))
    top = mxt.ops.get_op("SoftmaxOutput")
    xx = tx.clone().requires_grad_(True)
    mxt.ops.loss.softmax_output(xx, torch.from_numpy(label),
                                top.normalize_attrs(attrs)).sum().backward()
    assert xx.grad.dtype == tx.dtype and want.dtype == jx.dtype
    assert _ulps(xx.grad, want, dtype) <= 1
    # the label rows' columns carry p - 1: the ids reached the kernel exact
    g = _np(xx.grad)
    assert g[1, 999] < 0 and g[2, 300] < 0 and g[1, 998] > 0
    assert (g[0, 257] < 0) != bool(attrs.get("use_ignore"))


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (3, 16, 7, 7),
                                   (2, 4, 14, 14), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", HALVES)
def test_bn_kernels_plain_bf16_match_pallas(shape, dtype):
    rs = np.random.RandomState(2)
    tx, jx = _bf16(3 * rs.randn(*shape) + 1, dtype)
    s, sq = pk._pl_channel_stats(jx)
    ts, tsq = ck.bn_stats_plain(tx)
    assert ts.dtype == torch.float32 and s.dtype == jnp.float32
    bound = 1e-5 * np.asarray(sq)
    assert (np.abs(np.asarray(s) - ts.numpy()) <= bound).all()
    assert (np.abs(np.asarray(sq) - tsq.numpy()) <= bound).all()
    c = shape[1]
    scale, shift = (rs.randn(c).astype(np.float32) for _ in range(2))
    want = pk._pl_apply_bn_relu(jx, jnp.asarray(scale), jnp.asarray(shift))
    got = ck.bn_apply_relu_plain(tx, torch.from_numpy(scale),
                                 torch.from_numpy(shift))
    assert got.dtype == tx.dtype and want.dtype == jx.dtype
    assert _ulps(got, want, dtype) <= 1


@pytest.mark.parametrize("dtype", HALVES)
def test_weak_scalar_is_jax_weak_typing(dtype):
    x = np.asarray([1.0, 3.0, 7.0, 0.3, -2.5], np.float32)
    tx, jx = _bf16(x, dtype)
    np.testing.assert_array_equal(_np(weak_scalar(0.9, tx) * tx),
                                  _np(0.9 * jx))
    np.testing.assert_array_equal(_np(tx + weak_scalar(1e-3, tx)),
                                  _np(jx + 1e-3))
    f32 = torch.from_numpy(x)
    assert weak_scalar(0.9, f32) == 0.9


# ------------------------------------------------------------ the executor
def _head_net(sym, classes=1000):
    data = sym.var("data")
    bn = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5, name="bn")
    fc = sym.FullyConnected(data=bn, num_hidden=classes, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


@pytest.mark.parametrize("dtype", HALVES)
def test_executor_casts_args_and_aux_not_labels(dtype):
    rs = np.random.RandomState(3)
    X = rs.randn(4, 16).astype(np.float32)
    y = np.asarray([257, 999, 300, 5], np.float32)
    half = HALF[dtype][0]
    mod = mxt.mod.Module(_head_net(mxt.sym), context=CPU,
                         compute_dtype=dtype)
    mod.bind([("data", X.shape)], [("softmax_label", y.shape)])
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    aux0 = {k: v.asnumpy().copy() for k, v in mod.get_params()[1].items()}
    mod.init_optimizer(optimizer_params=SGD)
    mod.forward_backward(mxt.io.DataBatch([X], [y]))
    exe = mod._exec_group.executor
    assert exe.outputs[0].astorch().dtype == half
    prob = exe.outputs[0].asnumpy()
    # asnumpy widens bfloat16, which numpy lacks; float16 stays float16
    assert prob.dtype == (np.float32 if half == BF16 else np.float16)
    assert exe.arg_dict["softmax_label"].astorch().dtype == torch.float32
    np.testing.assert_array_equal(exe.arg_dict["softmax_label"].asnumpy(), y)
    gb = exe.grad_dict["fc_bias"].asnumpy()
    for row, lab in enumerate(y.astype(int)):
        # the label column's gradient has p - 1 in it: only where the id
        # reached the head exact
        assert gb[lab] < 0, (row, lab)
    assert gb[256] > 0 and gb[1000 - 1] < 0
    mod.update()
    args, auxs = mod.get_params()
    for cells in (args, auxs, exe.grad_dict):
        assert {v.astorch().dtype for v in cells.values()} == \
            {torch.float32}
    states = mxt.convert.optimizer_states_to_numpy(mod)
    assert {v.dtype for v in states.values()} == {np.dtype(np.float32)}
    # the moving statistics moved, in float32: 16-bit momentum (0.9 is
    # 0.8984375 in bfloat16, 0.89990234375 in float16) times the statistic
    # read in 16 bits, plus 0.1 of the batch's float32 mean of 16-bit data
    m = weak_scalar(0.9, torch.zeros((), dtype=half))
    assert m == {BF16: 0.8984375, torch.float16: 0.89990234375}[half]
    mm0 = torch.from_numpy(aux0["bn_moving_mean"]).to(half).float()
    mean = torch.from_numpy(X).to(half).float().mean(0)
    prod = m * mm0
    if half == torch.float16:       # the compiled float16 step rounds it
        prod = prod.to(half).float()
    want = prod + (1 - 0.9) * mean
    np.testing.assert_allclose(auxs["bn_moving_mean"].asnumpy(),
                               want.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", HALVES)
def test_executor_matches_jax_cast_and_gradients(dtype):
    """The same head net bound in both packages under compute_dtype:
    probabilities, every gradient and the new moving statistics."""
    tdt, jdt, _, _, tol = HALF[dtype]
    rs = np.random.RandomState(4)
    X = rs.randn(4, 16).astype(np.float32)
    y = np.asarray([257, 999, 300, 5], np.float32)
    args = {"bn_gamma": (1 + 0.1 * rs.randn(16)).astype(np.float32),
            "bn_beta": (0.1 * rs.randn(16)).astype(np.float32),
            "fc_weight": (0.05 * rs.randn(1000, 16)).astype(np.float32),
            "fc_bias": (0.05 * rs.randn(1000)).astype(np.float32)}
    auxs = {"bn_moving_mean": (0.3 * rs.randn(16)).astype(np.float32),
            "bn_moving_var": (1 + rs.rand(16)).astype(np.float32)}
    shapes = ([("data", X.shape)], [("softmax_label", y.shape)])
    jm = mx.mod.Module(_head_net(mx.sym), context=mx.cpu(),
                       compute_dtype=jdt)
    jm.bind(*shapes)
    jm.init_params(arg_params={k: mx.nd.array(v) for k, v in args.items()},
                   aux_params={k: mx.nd.array(v) for k, v in auxs.items()})
    jm.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                        [mx.nd.array(y)]))
    jm._sync_params_from_devices()
    tm = mxt.mod.Module(_head_net(mxt.sym), context=CPU,
                        compute_dtype=tdt)
    tm.bind(*shapes)
    tm.init_params(arg_params=mxt.convert.params_from_numpy(args, CPU),
                   aux_params=mxt.convert.params_from_numpy(auxs, CPU))
    tm.forward_backward(mxt.io.DataBatch([X], [y]))
    np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                               _np(jm.get_outputs()[0].asjax()),
                               atol=tol)
    jg = dict(zip(jm._exec_group.param_names, jm._exec_group.grad_arrays))
    tg = tm._exec_group.executor.grad_dict
    for k, g in tg.items():
        want = np.asarray(jg[k].asnumpy(), np.float32)
        assert g.astorch().dtype == torch.float32
        # 16-bit products summed over 4 rows: a few ulps of the array's
        # largest magnitude
        np.testing.assert_allclose(g.asnumpy(), want,
                                   atol=tol * np.abs(want).max(), err_msg=k)
    # the moving statistics: the same bfloat16 reads and float32 update
    # (the batch statistics summed in another order)
    for k, v in jm.get_params()[1].items():
        np.testing.assert_allclose(tm.get_params()[1][k].asnumpy(),
                                   np.asarray(v.asnumpy(), np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def _stale_cast_check(ctx, dtype="bfloat16"):
    """An inference forward after ``update()`` reads the updated weights,
    not a cast kept from before it: the same outputs as a fresh Module
    bound on the updated parameters."""
    rs = np.random.RandomState(6)
    X = rs.randn(4, 16).astype(np.float32)
    y = np.asarray([257, 999, 300, 5], np.float32)
    shapes = ([("data", X.shape)], [("softmax_label", y.shape)])
    mod = mxt.mod.Module(_head_net(mxt.sym), context=ctx,
                         compute_dtype=dtype)
    mod.bind(*shapes)
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    batch = mxt.io.DataBatch([X], [y])
    mod.forward(batch, is_train=False)
    first = mod.get_outputs()[0].asnumpy()
    mod.forward(batch, is_train=False)             # the kept casts
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), first)
    mod.forward_backward(batch)
    mod.update()
    mod.forward(batch, is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    fresh = mxt.mod.Module(_head_net(mxt.sym), context=ctx,
                           compute_dtype=dtype)
    fresh.bind(*shapes, for_training=False)
    fresh.init_params(arg_params=mod.get_params()[0],
                      aux_params=mod.get_params()[1])
    fresh.forward(batch, is_train=False)
    np.testing.assert_array_equal(got, fresh.get_outputs()[0].asnumpy())
    assert np.abs(got - first).max() > 1e-3


@pytest.mark.parametrize("dtype", HALVES)
def test_kept_casts_follow_in_place_updates(dtype):
    _stale_cast_check(CPU, dtype)


# ------------------------------------------------------- the narrow ResNet
def _nets(fused):
    if fused:
        with mx.name.NameManager():
            return fused_resnet(mx.sym, **NARROW), \
                fused_resnet(mxt.sym, **NARROW)
    return (jresnet.resnet(bottle_neck=True, num_stages=4, **NARROW),
            tresnet.resnet(bottle_neck=True, num_stages=4, **NARROW))


def _start(fused, batch=4):
    """Numpy Xavier parameters (plain names, renamed for the fused net)
    with random BatchNorm statistics, images and labels."""
    rs = np.random.RandomState(5)
    X = rs.rand(batch, *IMAGE).astype(np.float32)
    y = rs.randint(0, 10, batch).astype(np.float32)
    plain = tresnet.resnet(bottle_neck=True, num_stages=4, **NARROW)
    args, auxs = _init_params(plain, ([("data", X.shape)],
                                      [("softmax_label", y.shape)]))
    auxs = {k: (0.2 * rs.randn(*v.shape) if k.endswith("_mean")
                else 1 + 0.5 * rs.rand(*v.shape)).astype(np.float32)
            for k, v in auxs.items()}
    if fused:
        args, auxs = (_renamed(d, NARROW["units"]) for d in (args, auxs))
    return args, auxs, X, y


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_resnet_forward_matches_jax(fused, dtype):
    cd = None if dtype == "float32" else dtype
    tol = PROB_TOL_F32 if cd is None else HALF[cd][4]
    args, auxs, X, y = _start(fused)
    jsym, tsym = _nets(fused)
    shapes = ([("data", X.shape)], [("softmax_label", y.shape)])
    for is_train in (False, True):
        jm = mx.mod.Module(jsym, context=mx.cpu(),
                           compute_dtype=cd and HALF[cd][1])
        jm.bind(*shapes, for_training=is_train)
        jm.init_params(
            arg_params={k: mx.nd.array(v) for k, v in args.items()},
            aux_params={k: mx.nd.array(v) for k, v in auxs.items()})
        tm = mxt.mod.Module(tsym, context=CPU, compute_dtype=cd)
        tm.bind(*shapes, for_training=is_train)
        tm.init_params(arg_params=mxt.convert.params_from_numpy(args, CPU),
                       aux_params=mxt.convert.params_from_numpy(auxs, CPU))
        jm.forward(mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(y)]),
                   is_train=is_train)
        tm.forward(mxt.io.DataBatch([X], [y]), is_train=is_train)
        want = _np(jm.get_outputs()[0].asjax())
        got = tm.get_outputs()[0]
        assert got.astorch().dtype == (HALF[cd][0] if cd else torch.float32)
        np.testing.assert_allclose(got.asnumpy(), want, atol=tol)
        assert got.asnumpy().argmax(1).tolist() == want.argmax(1).tolist()


def _fit(lib, sym, cd, args, auxs, X, y):
    """Two batches of 4 at lr 0.01 from the given numpy parameters:
    ({name: weight}, {name: moving statistic}) as float32 numpy, after
    checking that every cell stayed float32."""
    ctx = mx.cpu() if lib is mx else CPU
    m = lib.mod.Module(sym, context=ctx, compute_dtype=cd)
    m.fit(lib.io.NDArrayIter(X, y, batch_size=4), num_epoch=1,
          arg_params={k: lib.nd.array(v, ctx=ctx) for k, v in args.items()},
          aux_params={k: lib.nd.array(v, ctx=ctx) for k, v in auxs.items()},
          optimizer_params=SGD)
    out = []
    for cells in m.get_params():
        assert {str(v.dtype) for v in cells.values()} == {"float32"}
        out.append({k: np.asarray(v.asnumpy(), np.float32)
                    for k, v in cells.items()})
    return out


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def resnet_fit_matches_jax(fused, dtype):
    """Two batches of 4 at lr 0.01 in bfloat16, the JAX package's (its
    XLA tier and its Pallas tier in interpret mode, as the caller's
    ``jax_tier`` sets it) and the port's, and the JAX package's in
    float32 in the same tier. Each weight and moving statistic of the
    port lies within 3 times the distance between the JAX package's own
    bfloat16 and float32 fits (plus 1e-6): the two packages' bfloat16
    fits differ as much as bfloat16 rounding itself moves a fit (measured
    0.95-2.2 times it over these arrays; their float32 fits agree within
    3e-7). ``test_resnet_bf16_fit_matches_jax`` runs it, the plain net in
    ``tests/test_torch_bf16_fit_plain.py`` and the fused one in
    ``tests/test_torch_bf16_fit_fused.py``: two files, so that
    pytest-xdist's ``--dist loadfile`` runs them on two workers."""
    args, auxs, X, y = _start(fused, batch=8)
    jsym, tsym = _nets(fused)
    j32 = _fit(mx, jsym, None, args, auxs, X, y)
    jbf = _fit(mx, jsym, HALF[dtype][1], args, auxs, X, y)
    tbf = _fit(mxt, tsym, dtype, args, auxs, X, y)
    moved = 0.0
    for i in (0, 1):
        for k, want in jbf[i].items():
            spread = np.abs(want - j32[i][k]).max()
            moved = max(moved, float(np.abs(want - args.get(k, 0)).max()))
            np.testing.assert_allclose(tbf[i][k], want,
                                       atol=3 * spread + 1e-6, err_msg=k)
    assert moved > 1e-3


@pytest.mark.parametrize("dtype", HALVES)
def test_resnet_bf16_serves_as_jax(dtype):
    args, auxs, X, y = _start(False, batch=6)
    jsym, tsym = _nets(False)
    ladder, rows = [1, 2, 4], (1, 3, 2)
    outs = {}
    for lib, sym, ctx, cd in ((mx, jsym, mx.cpu(), HALF[dtype][1]),
                              (mxt, tsym, CPU, dtype)):
        params = {k: lib.nd.array(v, ctx=ctx) for k, v in args.items()}
        aux = {k: lib.nd.array(v, ctx=ctx) for k, v in auxs.items()}
        clock = lib.serve.FakeClock()
        server = lib.serve.InferenceServer(clock=clock,
                                           default_deadline_ms=5)
        server.register("r", symbol=sym, arg_params=params,
                        aux_params=aux, data_shapes={"data": IMAGE},
                        ladder=ladder, context=ctx, compute_dtype=cd)
        try:
            handles, at = [], 0
            for n in rows:
                handles.append(server.submit({"data": X[at:at + n]},
                                             model="r"))
                at += n
            clock.advance(0.01)
            while server.pump():
                pass
            outs[lib] = [np.asarray(h.result(timeout=0)[0].asnumpy(),
                                    np.float32) for h in handles]
            assert server.stats()["compiles_since_warmup"] == 0
        finally:
            server.stop()
    for got, want in zip(outs[mxt], outs[mx]):
        np.testing.assert_allclose(got, want, atol=HALF[dtype][4])
        assert got.argmax(1).tolist() == want.argmax(1).tolist()


# ------------------------------------------------------------ what raises
def test_float16_and_float32_only_kernels_raise():
    """float16 is taken everywhere bfloat16 is (Module, serve, the
    executor's parse; the fused op's CUDA variant on float16 data); a type
    with no mixed precision raises, naming the two ported ones; a CUDA
    tensor of a dtype no kernel instance takes raises, naming it; the
    float32-only updates name their later slice."""
    net = _head_net(mxt.sym, classes=10)
    for cd in ("float16", torch.float16, np.float16):
        assert mxt.executor.parse_compute_dtype(cd) is torch.float16
        mxt.mod.Module(net, context=CPU, compute_dtype=cd)
    with pytest.raises(MXNetError, match="bfloat16 or float16"):
        mxt.mod.Module(net, context=CPU, compute_dtype="int4")
    mod = mxt.mod.Module(net, context=CPU)
    mod.bind([("data", (2, 16))], [("softmax_label", (2,))],
             for_training=False)
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    server = mxt.serve.serve(mod, context=CPU, ladder=[1, 2], start=False,
                             compute_dtype="float16")
    x = np.random.RandomState(7).randn(2, 16).astype(np.float32)
    out = server.engine().forward(2, {"data": x})[0]
    assert out.astorch().dtype == torch.float16
    server.stop()
    with pytest.raises(MXNetError, match="float64"):
        ck._cbr_cuda({}, [torch.zeros(1, 1, 2, 2, dtype=torch.float64)] * 4,
                     [], False, None)
    with pytest.raises(MXNetError, match="torch.float64 data; it has "
                       "torch.bfloat16, torch.float16, torch.float32"):
        ck._instance("layernorm", torch.zeros(2, dtype=torch.float64))
    assert ck._instance("layernorm", torch.zeros(2, dtype=torch.float16)) \
        == "f16"
    assert "later slice" in ck._HALF_LATER
    assert mxt.executor.parse_compute_dtype("float32") is None
    assert mxt.executor.parse_compute_dtype(np.dtype(jnp.bfloat16)) is BF16


def test_float16_gradients_keep_subnormals_as_jax():
    """Neither package scales the loss, so a float16 weight gradient below
    float16's normal range (6.1e-5) is a subnormal: both keep it (no
    flush to zero), and the port's gradients equal the JAX package's
    within one float16 ulp of each value (the subnormal ulp, 2^-24,
    below 6.1e-5)."""
    rs = np.random.RandomState(8)
    X = (1e-3 * rs.randn(4, 16)).astype(np.float32)
    y = np.asarray([3, 999, 300, 5], np.float32)
    w = (0.05 * rs.randn(1000, 16)).astype(np.float32)
    grads = []
    for lib, ctx, cd in ((mx, mx.cpu(), jnp.float16),
                         (mxt, CPU, "float16")):
        data = lib.sym.var("data")
        net = lib.sym.SoftmaxOutput(lib.sym.FullyConnected(
            data, num_hidden=1000, no_bias=True, name="fc"), name="softmax")
        m = lib.mod.Module(net, context=ctx, compute_dtype=cd)
        m.bind([("data", X.shape)], [("softmax_label", y.shape)])
        m.init_params(arg_params={"fc_weight": lib.nd.array(w, ctx=ctx)})
        m.forward_backward(lib.io.DataBatch(
            [lib.nd.array(X, ctx=ctx)], [lib.nd.array(y, ctx=ctx)]))
        g = dict(zip(m._exec_group.param_names, m._exec_group.grad_arrays))
        grads.append(np.asarray(g["fc_weight"].asnumpy(), np.float32))
    jg, tg = grads
    for g in grads:
        tiny = (g != 0) & (np.abs(g) < 2.0 ** -14)
        assert tiny.sum() > 100          # float16 subnormals, kept
    assert np.array_equal(jg == 0, tg == 0)
    assert _ulps(tg, jg, "float16") <= 1


def test_float16_keeps_label_ids_past_2048():
    """float16 holds integers exactly only up to 2048: 2049 would round to
    2048 and 4097 to 4096. The labels of a loss head keep their float32
    cell under ``compute_dtype="float16"``, so the head's gradient has
    p - 1 at the exact class columns, as in the JAX package."""
    rs = np.random.RandomState(9)
    X = rs.randn(4, 16).astype(np.float32)
    y = np.asarray([2049, 4097, 3001, 5], np.float32)
    w = (0.05 * rs.randn(5000, 16)).astype(np.float32)
    grads = []
    for lib, ctx, cd in ((mx, mx.cpu(), jnp.float16),
                         (mxt, CPU, "float16")):
        m = lib.mod.Module(_head_net(lib.sym, classes=5000), context=ctx,
                           compute_dtype=cd)
        m.bind([("data", X.shape)], [("softmax_label", y.shape)])
        m.init_params(arg_params={
            "bn_gamma": lib.nd.array(np.ones(16, np.float32), ctx=ctx),
            "bn_beta": lib.nd.array(np.zeros(16, np.float32), ctx=ctx),
            "fc_weight": lib.nd.array(w, ctx=ctx),
            "fc_bias": lib.nd.array(np.zeros(5000, np.float32), ctx=ctx)},
            aux_params={"bn_moving_mean": lib.nd.array(
                np.zeros(16, np.float32), ctx=ctx),
                "bn_moving_var": lib.nd.array(np.ones(16, np.float32),
                                              ctx=ctx)})
        m.forward_backward(lib.io.DataBatch(
            [lib.nd.array(X, ctx=ctx)], [lib.nd.array(y, ctx=ctx)]))
        g = dict(zip(m._exec_group.param_names, m._exec_group.grad_arrays))
        grads.append(np.asarray(g["fc_bias"].asnumpy(), np.float32))
    for gb in grads:
        assert all(gb[int(lab)] < 0 for lab in y)
        assert gb[2048] > 0 and gb[4096] > 0
