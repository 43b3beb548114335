"""FusedConvBNReLU and ResNet's fused configuration: ``mxnet_tpu_torch``
against ``mxnet_tpu`` on the CPU at small sizes.

The fused configuration is ResNet (bottleneck units, the ImageNet stem)
with each Convolution -> BatchNorm -> ReLU triple as one
``FusedConvBNReLU`` named after the convolution: the stem's ``conv0`` +
``bn0`` + ``relu0`` and each unit's ``conv1`` + ``bn2`` + ``relu2`` and
``conv2`` + ``bn3`` + ``relu3`` — 33 of ResNet-50's 53 convolutions. No
builder in either package emits it: ``fused_resnet`` below takes either
package's symbol module (``chip_smoke.py`` keeps its own copy), and
``fused_names`` carries a plain ResNet's parameters into it.

Held here:

* the two kernels' plain versions against the JAX package's Pallas
  kernels (interpret mode) — the statistics within 1e-5 of each channel's
  sum of squares (float32 sums in another order; the sum of a channel is
  held to the same bound, since sum(x)^2 <= n sum(x^2)), the apply pass
  within 2e-6 (XLA on the CPU contracts ``x * scale + shift`` into one
  fused multiply-add, one rounding fewer than the port's);
* the op: the port's plain forward against the JAX package's XLA
  variant, and the port's CUDA variant (its ``autograd.Function``, whose
  kernels are their plain halves on CPU tensors) against its Pallas
  variant — outputs and new moving statistics within 2e-6, gradients
  within 1e-5 (float32 convolutions and reductions in another order);
* the fused builder's JSON byte-identical across packages, and on the CPU
  the fused net bit for bit the plain one (forward and gradients) from
  renamed parameters;
* a 4-step fit of a narrow one-unit-per-stage net in the fused
  configuration against the JAX package's, in both its tiers, within
  1e-4 (as ``test_torch_train_imagenet.py``: the frameworks sum in other
  orders and training carries it through the updates); and an
  ``InferenceServer`` over it against ``Module.forward``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.registry import get_op as torch_op

CPU = mxt.cpu()
# lr 0.01: at 0.1 the narrow net's fit is chaotic in float32 — the two
# packages' 1e-6 differences after one step grow ~100x a step (0.03 after
# four, the same at the JAX package's own plain and fused nets); at 0.01
# they stay below 1e-6
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
IMAGE = (3, 40, 40)
NARROW = dict(units=[1, 1, 1, 1], filter_list=[16, 32, 64, 128, 256],
              num_classes=10, image_shape=IMAGE)
BN = dict(fix_gamma=False, eps=2e-5, momentum=0.9)


def fused_resnet(sym, units, filter_list, num_classes, image_shape):
    """ResNet (bottleneck units, ImageNet stem) in its fused
    configuration, node for node ``models/resnet.py`` otherwise: the
    Convolution -> BatchNorm -> ReLU triples are ``FusedConvBNReLU`` nodes
    named after the convolution (the conv's attributes without
    ``no_bias``, plus the BatchNorm's), everything else is unchanged.
    ``sym`` is either package's symbol module."""
    def cbr(data, num_filter, kernel, stride, pad, name):
        return sym.FusedConvBNReLU(data=data, num_filter=num_filter,
                                   kernel=kernel, stride=stride, pad=pad,
                                   workspace=256, name=name, **BN)

    data = sym.BatchNorm(data=sym.var("data"), fix_gamma=True, eps=2e-5,
                         momentum=0.9, name="bn_data")
    body = cbr(data, filter_list[0], (7, 7), (2, 2), (3, 3), "conv0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="pool0")
    for i, n_units in enumerate(units):
        nf = filter_list[i + 1]
        for j in range(n_units):
            name = f"stage{i + 1}_unit{j + 1}"
            stride = (1, 1) if i == 0 or j > 0 else (2, 2)
            act1 = sym.Activation(
                data=sym.BatchNorm(data=body, name=name + "_bn1", **BN),
                act_type="relu", name=name + "_relu1")
            conv1 = cbr(act1, nf // 4, (1, 1), (1, 1), (0, 0),
                        name + "_conv1")
            conv2 = cbr(conv1, nf // 4, (3, 3), stride, (1, 1),
                        name + "_conv2")
            conv3 = sym.Convolution(data=conv2, num_filter=nf, kernel=(1, 1),
                                    stride=(1, 1), pad=(0, 0), no_bias=True,
                                    workspace=256, name=name + "_conv3")
            shortcut = body if j else sym.Convolution(
                data=act1, num_filter=nf, kernel=(1, 1), stride=stride,
                no_bias=True, workspace=256, name=name + "_sc")
            body = conv3 + shortcut
    relu1 = sym.Activation(data=sym.BatchNorm(data=body, name="bn1", **BN),
                           act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    fc1 = sym.FullyConnected(data=sym.Flatten(data=pool1),
                             num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def fused_names(units):
    """{plain ResNet parameter name: fused configuration's}: gamma, beta
    and the moving statistics of each fused triple move from the
    BatchNorm's name to the convolution's (4 x 33 = 132 for ResNet-50)."""
    pairs = [("bn0", "conv0")]
    for i, n_units in enumerate(units):
        for j in range(n_units):
            name = f"stage{i + 1}_unit{j + 1}"
            pairs += [(name + "_bn2", name + "_conv1"),
                      (name + "_bn3", name + "_conv2")]
    return {f"{src}_{k}": f"{dst}_{k}" for src, dst in pairs
            for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _renamed(params, units):
    names = fused_names(units)
    return {names.get(k, k): v for k, v in params.items()}


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------- the kernels
@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (3, 16, 7, 7),
                                   (1, 1, 1, 1)])
def test_kernels_plain_match_pallas(shape):
    rs = np.random.RandomState(0)
    x = (3 * rs.randn(*shape) + 1).astype(np.float32)
    s, sq = pk._pl_channel_stats(jnp.asarray(x))
    ts, tsq = ck.bn_stats_plain(_t(x))
    bound = 1e-5 * np.asarray(sq)
    assert (np.abs(np.asarray(s) - ts.numpy()) <= bound).all()
    assert (np.abs(np.asarray(sq) - tsq.numpy()) <= bound).all()
    c = shape[1]
    scale, shift = rs.randn(c).astype(np.float32), \
        rs.randn(c).astype(np.float32)
    y = pk._pl_apply_bn_relu(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(shift))
    np.testing.assert_allclose(
        ck.bn_apply_relu_plain(_t(x), _t(scale), _t(shift)).numpy(),
        np.asarray(y), atol=2e-6, rtol=2e-6)


# ------------------------------------------------------------------ the op
def _op_case(seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, 4, 9, 9).astype(np.float32),            # data
            (0.3 * rs.randn(6, 4, 3, 3)).astype(np.float32),    # weight
            (rs.rand(6) + 0.5).astype(np.float32),              # gamma
            rs.randn(6).astype(np.float32),                     # beta
            (0.1 * rs.randn(6)).astype(np.float32),             # moving mean
            (rs.rand(6) + 0.5).astype(np.float32)]              # moving var


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("extra", [{"fix_gamma": False},
                                   {"fix_gamma": True},
                                   {"fix_gamma": False,
                                    "use_global_stats": True}],
                         ids=["gamma", "fix_gamma", "global_stats"])
def test_op_matches_xla_and_pallas(is_train, extra):
    kw = dict(kernel=(3, 3), num_filter=6, pad=(1, 1), stride=(2, 2),
              eps=2e-5, **extra)
    jop, top = jax_op("FusedConvBNReLU"), torch_op("FusedConvBNReLU")
    ja, ta = jop.normalize_attrs(kw), top.normalize_attrs(kw)
    assert ja == ta
    arrays = _op_case()
    j_in = [jnp.asarray(a) for a in arrays]
    gy = np.random.RandomState(2).randn(2, 6, 5, 5).astype(np.float32)

    def jax_run(fn):
        def f(d, w, g, b):
            outs, _ = fn(ja, [d, w, g, b], j_in[4:], is_train, None)
            return outs[0]
        outs, aux = fn(ja, j_in[:4], j_in[4:], is_train, None)
        _, vjp = jax.vjp(f, *j_in[:4])
        return outs[0], aux, vjp(jnp.asarray(gy))

    def torch_run(fn):
        leaves = [_t(a).requires_grad_(True) for a in arrays[:4]]
        outs, aux = fn(ta, leaves, [_t(a) for a in arrays[4:]], is_train,
                       None)
        grads = torch.autograd.grad(outs[0], leaves, _t(gy),
                                    allow_unused=True)
        return outs[0].detach(), aux, [
            np.zeros(a.shape, np.float32) if g is None else g.numpy()
            for g, a in zip(grads, arrays)]

    for jfn, tfn in ((jop.forward, top.forward),
                     (jop.variant_fn("pallas"), top.variants["cuda"]["fn"])):
        jy, jaux, jgrads = jax_run(jfn)
        ty, taux, tgrads = torch_run(tfn)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6,
                                   rtol=2e-6)
        for a, b in zip(taux, jaux):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6,
                                       rtol=2e-6)
        for a, b in zip(tgrads, jgrads):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


def test_op_on_both_surfaces():
    arrays = _op_case()
    kw = dict(kernel=(3, 3), num_filter=6, pad=(1, 1), **BN)
    with CPU:
        out = mxt.nd.FusedConvBNReLU(*[mxt.nd.array(a) for a in arrays],
                                     **kw)
    ref, _ = torch_op("FusedConvBNReLU").forward(
        torch_op("FusedConvBNReLU").normalize_attrs(kw),
        [_t(a) for a in arrays[:4]], [_t(a) for a in arrays[4:]], False,
        None)
    np.testing.assert_array_equal(out.asnumpy(), ref[0].numpy())
    net = mxt.sym.FusedConvBNReLU(data=mxt.sym.var("data"), name="f", **kw)
    assert net.list_arguments() == ["data", "f_weight", "f_gamma", "f_beta"]
    assert net.list_auxiliary_states() == ["f_moving_mean", "f_moving_var"]
    args, outs, auxs = net.infer_shape(data=(2, 4, 9, 9))
    assert args[1:] == [(6, 4, 3, 3), (6,), (6,)]
    assert outs == [(2, 6, 9, 9)] and auxs == [(6,), (6,)]


# -------------------------------------------------------------- the network
def test_fused_resnet50_json_identical():
    units = [3, 4, 6, 3]
    spec = dict(units=units, filter_list=[64, 256, 512, 1024, 2048],
                num_classes=1000, image_shape=(3, 224, 224))
    with mx.name.NameManager():
        js = fused_resnet(mx.sym, **spec).tojson()
    with mxt.name.NameManager():
        ts = fused_resnet(mxt.sym, **spec)
    assert ts.tojson() == js
    ops = [n.op for n in ts._topo_nodes() if not n.is_variable]
    assert ops.count("FusedConvBNReLU") == 33
    assert ops.count("Convolution") == 20
    plain = tresnet.get_symbol(1000, 50, "3,224,224")
    names = fused_names(units)
    assert len(names) == 132
    assert sorted(names.get(k, k) for k in plain.list_arguments()) == \
        sorted(ts.list_arguments())
    assert sorted(names.get(k, k) for k in plain.list_auxiliary_states()) \
        == sorted(ts.list_auxiliary_states())


def _init_params(sym, shapes, seed=0):
    mod = mxt.mod.Module(sym, context=CPU)
    mod.bind(*shapes)
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(seed)))
    return ({k: v.asnumpy() for k, v in d.items()}
            for d in mod.get_params())


def test_fused_net_bit_for_bit_the_plain_net_on_cpu():
    rs = np.random.RandomState(0)
    X = rs.rand(2, *IMAGE).astype(np.float32)
    y = np.asarray([3, 7], np.float32)
    plain = tresnet.resnet(bottle_neck=True, num_stages=4, **NARROW)
    fused = fused_resnet(mxt.sym, **NARROW)
    shapes = ([("data", X.shape)], [("softmax_label", y.shape)])
    args, auxs = _init_params(plain, shapes)
    units = NARROW["units"]
    runs = []
    for sym, a, x in ((plain, args, auxs),
                      (fused, _renamed(args, units), _renamed(auxs, units))):
        mod = mxt.mod.Module(sym, context=CPU)
        mod.bind(*shapes)
        mod.init_params(arg_params=mxt.convert.params_from_numpy(a, CPU),
                        aux_params=mxt.convert.params_from_numpy(x, CPU))
        mod.forward_backward(mxt.io.DataBatch([X], [y]))
        exe = mod._exec_group.executor
        runs.append((mod.get_outputs()[0].asnumpy(),
                     {k: v.asnumpy() for k, v in exe.grad_dict.items()},
                     {k: v.asnumpy() for k, v in mod.get_params()[1].items()}))
    (p_out, p_grad, p_aux), (f_out, f_grad, f_aux) = runs
    np.testing.assert_array_equal(f_out, p_out)
    assert len(f_grad) == len(p_grad)
    for k, g in _renamed(p_grad, units).items():
        np.testing.assert_array_equal(f_grad[k], g, err_msg=k)
    for k, v in _renamed(p_aux, units).items():
        np.testing.assert_array_equal(f_aux[k], v, err_msg=k)


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def test_fused_fit_matches_jax(jax_tier):
    rs = np.random.RandomState(1)
    X = rs.rand(16, *IMAGE).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.float32)
    with mx.name.NameManager():
        jsym = fused_resnet(mx.sym, **NARROW)
    jit = mx.io.NDArrayIter(X, y, batch_size=4)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(mx.initializer.Xavier())
    args0, auxs0 = ({k: v.asnumpy() for k, v in d.items()}
                    for d in jmod.get_params())
    jmetric = mx.metric.Accuracy()
    jmod.fit(jit, num_epoch=1, eval_metric=jmetric, optimizer_params=SGD)
    assert jmod._fused_armed

    with mxt.name.NameManager():
        tsym = fused_resnet(mxt.sym, **NARROW)
    tmod = mxt.mod.Module(tsym, context=CPU)
    tmetric = mxt.metric.Accuracy()
    tmod.fit(mxt.io.NDArrayIter(X, y, batch_size=4), num_epoch=1,
             eval_metric=tmetric,
             arg_params=mxt.convert.params_from_numpy(args0, CPU),
             aux_params=mxt.convert.params_from_numpy(auxs0, CPU),
             optimizer_params=SGD)
    assert tmetric.num_inst == 16 and jmetric.get() == tmetric.get()
    for jd, td in zip(jmod.get_params(), tmod.get_params()):
        assert sorted(jd) == sorted(td)
        for k in jd:
            np.testing.assert_allclose(td[k].asnumpy(), jd[k].asnumpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    tstates = mxt.convert.optimizer_states_to_numpy(tmod)
    for k, mom in jmod._exec_group.export_fused_states().items():
        np.testing.assert_allclose(tstates[k], mom, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_fused_net_serves_as_module_forward():
    sym = fused_resnet(mxt.sym, **NARROW)
    mod = mxt.mod.Module(sym, context=CPU)
    mod.bind([("data", (4,) + IMAGE)], [("softmax_label", (4,))],
             for_training=False)
    mod.init_params(mxt.initializer.Xavier(
        rng=torch.Generator().manual_seed(0)))
    X = np.random.RandomState(3).rand(4, *IMAGE).astype(np.float32)
    mod.forward(mxt.io.DataBatch([X], None), is_train=False)
    ref = mod.get_outputs()[0].asnumpy()
    clock = mxt.serve.FakeClock()
    server = mxt.serve.serve(mod, name="fused", ladder=[1, 2, 4],
                             context=CPU, start=False, clock=clock,
                             default_deadline_ms=5)
    try:
        handles = [server.submit({"data": X[:n]}) for n in (1, 3)]
        clock.advance(0.01)
        while server.pump():
            pass
        for n, h in zip((1, 3), handles):
            np.testing.assert_allclose(h.result(timeout=0)[0].asnumpy(),
                                       ref[:n], atol=1e-6, rtol=1e-6)
        assert server.stats()["compiles_since_warmup"] == 0
    finally:
        server.stop()
