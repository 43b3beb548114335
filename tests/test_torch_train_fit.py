"""The training slice as a whole: ``Module.fit`` of ``mxnet_tpu_torch``
against ``mxnet_tpu`` on the CPU at a small size.

Both packages start from the same parameters: the JAX package initializes
them (Xavier), and they are carried across as numpy through
``mxnet_tpu_torch.convert``. Then:

* the cifar ResNet-8 (3x16x16, batch 8, 3 steps, SGD momentum 0.9, wd
  1e-4) fits alike — every argument, aux state and momentum, and the
  train metric — against the JAX package's fused fit, with its
  SoftmaxOutput both as the XLA composition and as the Pallas kernels
  (interpret mode, ``MXNET_KERNEL_TIER=pallas``);
* the MLP fits two Adam steps alike (weights, mean and var);
* ``tojson()`` of ResNet-50 at 224x224 is identical in both packages;
* a checkpoint the port saves loads in the JAX package, and the port
  resumes from its own checkpoint (optimizer states included) exactly
  where an uninterrupted run would be.

Tolerance: 1e-4 absolute and relative after 3 steps. Each framework sums
the convolutions and the BatchNorm statistics in its own order (float32
rounding, ~1e-7 per operation), and training carries those differences
through the updates; a wrong gradient, a wrong update or a missed aux
write shows as an error of order lr * grad, 1e-3 and up.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import mlp as jmlp
from mxnet_tpu.models import resnet as jresnet

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import mlp as tmlp
from mxnet_tpu_torch.models import resnet as tresnet

TOL = 1e-4
CPU = mxt.cpu()
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def _data(shape, n, classes, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *shape).astype(np.float32),
            rs.randint(0, classes, n).astype(np.float32))


def _jax_start(sym, X, y, batch):
    """A bound, Xavier-initialized JAX module and its parameters as
    numpy."""
    it = mx.io.NDArrayIter(X, y, batch_size=batch)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    args, auxs = mod.get_params()
    return mod, it, ({k: v.asnumpy() for k, v in args.items()},
                     {k: v.asnumpy() for k, v in auxs.items()})


def _torch_fit(sym, X, y, batch, params, optimizer="sgd", opt_params=SGD,
               num_epoch=1):
    it = mxt.io.NDArrayIter(X, y, batch_size=batch)
    mod = mxt.mod.Module(sym, context=CPU)
    metric = mxt.metric.Accuracy()
    mod.fit(it, num_epoch=num_epoch, eval_metric=metric,
            arg_params=mxt.convert.params_from_numpy(params[0], CPU),
            aux_params=mxt.convert.params_from_numpy(params[1], CPU),
            optimizer=optimizer, optimizer_params=opt_params)
    return mod, metric


def _assert_same_state(jmod, tmod):
    jargs, jauxs = jmod.get_params()
    targs, tauxs = tmod.get_params()
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        _close(jargs[k].asnumpy(), targs[k].asnumpy())
    assert sorted(jauxs) == sorted(tauxs)
    for k in jauxs:
        _close(jauxs[k].asnumpy(), tauxs[k].asnumpy())
    jstates = jmod._exec_group.export_fused_states()
    tstates = mxt.convert.optimizer_states_to_numpy(tmod)
    assert sorted(jstates) == sorted(tstates)
    for k, st in jstates.items():
        for a, b in zip(st if isinstance(st, (tuple, list)) else [st],
                        tstates[k] if isinstance(tstates[k], list)
                        else [tstates[k]]):
            _close(a, b)


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def test_resnet8_fit_matches_jax(jax_tier):
    X, y = _data((3, 16, 16), 24, 10)
    jmod, jit, params = _jax_start(jresnet.get_symbol(10, 8, "3,16,16"),
                                   X, y, 8)
    jmetric = mx.metric.Accuracy()
    jmod.fit(jit, num_epoch=1, eval_metric=jmetric, optimizer_params=SGD)
    assert jmod._fused_armed
    tmod, tmetric = _torch_fit(tresnet.get_symbol(10, 8, "3,16,16"), X, y,
                               8, params)
    _assert_same_state(jmod, tmod)
    assert jmetric.get() == tmetric.get()
    assert tmetric.num_inst == 24


def test_mlp_adam_two_steps_match_jax():
    X, y = _data((1, 4, 4), 16, 10, seed=1)
    jmod, jit, params = _jax_start(jmlp.get_symbol(10), X, y, 8)
    opt = {"learning_rate": 0.01, "wd": 1e-3}
    jmod.fit(jit, num_epoch=1, optimizer="adam", optimizer_params=opt)
    tmod, _ = _torch_fit(tmlp.get_symbol(10), X, y, 8, params,
                         optimizer="adam", opt_params=opt)
    _assert_same_state(jmod, tmod)
    assert tmod._optimizer._index_update_count[0] == 2


def test_resnet50_json_identical():
    with mx.name.NameManager():
        js = jresnet.get_symbol(1000, 50, "3,224,224").tojson()
    with mxt.name.NameManager():
        ts = tresnet.get_symbol(1000, 50, "3,224,224")
    assert ts.tojson() == js
    assert len(ts.list_arguments()) - 2 == 157     # parameter arrays


def test_checkpoint_round_trip(tmp_path):
    """The port's checkpoint loads in the JAX package; resuming the port
    from it (with optimizer states) continues the uninterrupted run."""
    X, y = _data((1, 4, 4), 32, 10, seed=2)
    _, _, params = _jax_start(jmlp.get_symbol(10), X, y, 8)
    sym = tmlp.get_symbol(10)
    whole, _ = _torch_fit(sym, X, y, 8, params, num_epoch=2)

    half, _ = _torch_fit(sym, X, y, 8, params, num_epoch=1)
    prefix = str(tmp_path / "mlp")
    half.save_checkpoint(prefix, 1, save_optimizer_states=True)
    jsym, jargs, jauxs = mx.model.load_checkpoint(prefix, 1)
    assert jsym.tojson() == sym.tojson()
    targs, _ = half.get_params()
    for k, v in targs.items():
        np.testing.assert_array_equal(jargs[k].asnumpy(), v.asnumpy())
    jmod = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    jmod.bind([("data", (8, 1, 4, 4))], [("softmax_label", (8,))],
              for_training=False)

    resumed = mxt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                  context=CPU)
    it = mxt.io.NDArrayIter(X, y, batch_size=8)
    resumed.fit(it, num_epoch=2, begin_epoch=1, optimizer_params=SGD)
    for (k, a), b in zip(whole.get_params()[0].items(),
                         resumed.get_params()[0].values()):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy(), err_msg=k)


def test_fit_refuses_what_is_not_ported():
    X, y = _data((1, 4, 4), 8, 10)
    it = mxt.io.NDArrayIter(X, y, batch_size=8)
    for kw in ({"spmd": True}, {"zero_stage": 1}, {"steps_per_dispatch": 4},
               {"remat": "all"}, {"health": True}, {"elastic": True},
               {"checkpoint": "/nonexistent"}, {"resume": True},
               {"monitor": object()}):
        mod = mxt.mod.Module(tmlp.get_symbol(10), context=CPU)
        with pytest.raises(MXNetError, match=next(iter(kw))):
            mod.fit(it, num_epoch=1, **kw)
    mod = mxt.mod.Module(tmlp.get_symbol(10), context=CPU)
    with pytest.raises(MXNetError, match="kvstore"):
        mod.fit(it, num_epoch=1, kvstore="dist_sync")
    with pytest.raises(MXNetError, match="one device"):
        mxt.mod.Module(tmlp.get_symbol(10), context=[CPU, CPU]).fit(
            it, num_epoch=1)


def test_ndarrayiter_matches_jax_batches():
    """pad / discard / roll_over and a seeded shuffle give the JAX
    iterator's batches (its shuffle draws from numpy's global state,
    seeded alike here)."""
    X = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    for kw in ({"last_batch_handle": "pad"},
               {"last_batch_handle": "discard"},
               {"last_batch_handle": "roll_over"}, {"shuffle": True}):
        np.random.seed(0)
        jit = mx.io.NDArrayIter(X, y, batch_size=4, **kw)
        tit = mxt.io.NDArrayIter(X, y, batch_size=4, **kw)
        for _epoch in range(2):
            jb, tb = list(jit), list(tit)
            assert len(jb) == len(tb)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a.data[0].asnumpy(),
                                              b.data[0].asnumpy())
                np.testing.assert_array_equal(a.label[0].asnumpy(),
                                              b.label[0].asnumpy())
                assert a.pad == b.pad
            jit.reset()
            tit.reset()


def test_lr_schedulers_and_multipliers_match_jax():
    from mxnet_tpu import lr_scheduler as jls
    for jsched, tsched in (
            (jls.FactorScheduler(3, 0.5),
             mxt.lr_scheduler.FactorScheduler(3, 0.5)),
            (jls.MultiFactorScheduler([2, 5], 0.1),
             mxt.lr_scheduler.MultiFactorScheduler([2, 5], 0.1))):
        jsched.base_lr = tsched.base_lr = 0.2
        assert [jsched(u) for u in range(1, 9)] == \
            [tsched(u) for u in range(1, 9)]
    names = dict(enumerate(["fc1_weight", "fc1_bias", "bn_gamma",
                            "bn_beta"]))
    jo = mx.optimizer.create("sgd", param_idx2name=names, wd=0.1,
                             learning_rate=0.3)
    to = mxt.optimizer.create("sgd", param_idx2name=names, wd=0.1,
                              learning_rate=0.3)
    assert [jo._get_wd(i) for i in names] == [to._get_wd(i) for i in names]
    assert [jo._get_lr(i) for i in names] == [to._get_lr(i) for i in names]


def test_metrics_match_jax():
    rs = np.random.RandomState(3)
    p = rs.rand(6, 5).astype(np.float32)
    p /= p.sum(axis=1, keepdims=True)
    lab = np.asarray([0, 1, 2, 3, 4, 0], np.float32)
    for name in ("acc", "ce", ["acc", "ce"]):
        jm, tm = mx.metric.create(name), mxt.metric.create(name)
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        with mxt.cpu():
            tm.update([mxt.nd.array(lab)], [mxt.nd.array(p)])
        for (jn, jv), (tn, tv) in zip(jm.get_name_value(),
                                      tm.get_name_value()):
            assert jn == tn
            _close(jv, tv, 1e-6)
    jm = mx.metric.TopKAccuracy(top_k=2)
    tm = mxt.metric.TopKAccuracy(top_k=2)
    jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
    with mxt.cpu():
        tm.update([mxt.nd.array(lab)], [mxt.nd.array(p)])
    assert jm.get() == tm.get()


def test_initializers_route_by_name():
    with mxt.cpu():
        cells = {n: mxt.nd.zeros((4, 3, 2, 2)) for n in (
            "c_weight", "c_bias", "b_gamma", "b_beta", "b_moving_mean",
            "b_moving_var")}
    init = mxt.initializer.Xavier(rng=__import__("torch").Generator()
                                  .manual_seed(3))
    for n, c in cells.items():
        init(n, c)
    w = cells["c_weight"].asnumpy()
    bound = np.sqrt(3 / ((3 * 4 + 4 * 4) / 2))
    assert 0 < np.abs(w).max() <= bound
    assert not cells["c_bias"].asnumpy().any()
    assert (cells["b_gamma"].asnumpy() == 1).all()
    assert (cells["b_moving_var"].asnumpy() == 1).all()
    assert not cells["b_moving_mean"].asnumpy().any()
    with pytest.raises(ValueError):
        init("mystery", cells["c_bias"])
    for cls, want in ((mxt.initializer.Zero, 0), (mxt.initializer.One, 1),
                      (lambda: mxt.initializer.Constant(2.5), 2.5)):
        cls()("c_weight", cells["c_weight"])
        assert (cells["c_weight"].asnumpy() == want).all()
    mxt.initializer.Normal(0.5)("c_weight", cells["c_weight"])
    assert cells["c_weight"].asnumpy().std() > 0.2
    mxt.initializer.MSRAPrelu()("c_weight", cells["c_weight"])
    mxt.initializer.Uniform(0.1)("c_weight", cells["c_weight"])
    assert np.abs(cells["c_weight"].asnumpy()).max() <= 0.1


def test_executor_grad_req_add_and_backward_heads():
    """``grad_req="add"`` accumulates; a loss head's backward ignores the
    head gradient given."""
    sym = tmlp.get_symbol(10)
    X, y = _data((1, 4, 4), 4, 10)
    exe = sym.simple_bind(CPU, grad_req="add", data=(4, 1, 4, 4),
                          softmax_label=(4,))
    init = mxt.initializer.Xavier()
    for name in ("fc1_weight", "fc2_weight", "fc3_weight"):
        init(name, exe.arg_dict[name])
    exe.forward(is_train=True, data=X, softmax_label=y)
    exe.backward()
    once = exe.grad_dict["fc1_weight"].asnumpy().copy()
    assert np.abs(once).max() > 0
    exe.forward(is_train=True, data=X, softmax_label=y)
    exe.backward([np.full((4, 10), 9.0, np.float32)])
    _close(2 * once, exe.grad_dict["fc1_weight"].asnumpy(), 1e-6)
    with pytest.raises(MXNetError, match="backward"):
        exe.backward()


def test_callbacks_fire_and_checkpoint(tmp_path, caplog):
    """Speedometer and log_train_metric at batch ends, do_checkpoint at
    epoch ends; the checkpoint loads back into a module that scores as
    the trained one."""
    import logging
    X, y = _data((1, 4, 4), 32, 10, seed=4)
    it = mxt.io.NDArrayIter(X, y, batch_size=8)
    mod = mxt.mod.Module(tmlp.get_symbol(10), context=CPU)
    speed = mxt.callback.Speedometer(8, frequent=2)
    prefix = str(tmp_path / "cb")
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2, optimizer_params=SGD,
                initializer=mxt.initializer.Xavier(),
                batch_end_callback=[speed,
                                    mxt.callback.log_train_metric(2)],
                epoch_end_callback=mxt.callback.do_checkpoint(prefix))
    assert speed.last_speed is not None and speed.last_speed > 0
    assert "train: accuracy=" in caplog.text
    loaded = mxt.mod.Module.load(prefix, 2, context=CPU)
    loaded.bind(it.provide_data, it.provide_label, for_training=False)
    assert loaded.score(it, "acc") == mod.score(it, "acc")


def test_input_grads_match_jax():
    """``inputs_need_grad``: the data gradient of one forward/backward,
    against the JAX package's staged (unfused) pass."""
    X, y = _data((1, 4, 4), 8, 10, seed=5)
    jmod, jit, params = _jax_start(jmlp.get_symbol(10), X, y, 8)
    jmod = mx.mod.Module(jmlp.get_symbol(10), context=mx.cpu())
    jmod.bind(jit.provide_data, jit.provide_label, inputs_need_grad=True)
    jmod.init_params(arg_params={k: mx.nd.array(v)
                                 for k, v in params[0].items()})
    batch = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(y)])
    jmod.forward_backward(batch)
    tmod = mxt.mod.Module(tmlp.get_symbol(10), context=CPU)
    tmod.bind([("data", X.shape)], [("softmax_label", y.shape)],
              inputs_need_grad=True)
    tmod.init_params(arg_params=mxt.convert.params_from_numpy(params[0],
                                                               CPU))
    tmod.forward_backward(mxt.io.DataBatch([X], [y]))
    _close(jmod.get_input_grads()[0].asnumpy(),
           tmod.get_input_grads()[0].asnumpy(), 1e-6)
    _close(jmod.get_outputs()[0].asnumpy(),
           tmod.get_outputs()[0].asnumpy(), 1e-6)


def test_training_continues_from_jax_state():
    """Parameters, BatchNorm statistics and momentum carried from a JAX
    fit after one epoch: the port's second epoch lands where the JAX
    package's own second epoch does."""
    X, y = _data((3, 16, 16), 16, 10, seed=6)
    sym_j = jresnet.get_symbol(10, 8, "3,16,16")
    jmod, jit, _ = _jax_start(sym_j, X, y, 8)
    jmod.fit(jit, num_epoch=1, optimizer_params=SGD)
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in jmod.get_params())
    momentum = jmod._exec_group.export_fused_states()
    jit.reset()
    jmod.fit(jit, num_epoch=2, begin_epoch=1, optimizer_params=SGD)

    it = mxt.io.NDArrayIter(X, y, batch_size=8)
    tmod = mxt.mod.Module(tresnet.get_symbol(10, 8, "3,16,16"), context=CPU)
    tmod.bind(it.provide_data, it.provide_label)
    tmod.init_params(arg_params=mxt.convert.params_from_numpy(args, CPU),
                     aux_params=mxt.convert.params_from_numpy(auxs, CPU))
    tmod.init_optimizer(optimizer_params=SGD)
    mxt.convert.set_optimizer_states(tmod, momentum)
    tmod.fit(it, num_epoch=2, begin_epoch=1, optimizer_params=SGD)
    _assert_same_state(jmod, tmod)
