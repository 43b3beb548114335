"""The multi-tensor optimizer update on the CPU, against the JAX package.

``cuda_kernels.sgd_mom_update_multi`` / ``adam_update_multi`` update a
whole step's arrays in one call (one launch on the card, for up to
``MULTI_CAP`` arrays). Here:

* their plain versions, array by array with each array's own lr and wd
  over a list of mixed shapes, clip on and off, against the JAX package's
  Pallas kernels (interpret mode) at the tolerance of
  ``test_torch_train_kernels.py`` (2e-5), and the in-place wrapper bit
  for bit against the per-array wrapper;
* the host-side launch planner (``_multi_plan`` / ``_multi_tables``):
  every element of every array in exactly one chunk, no chunk across
  two arrays, zero-length arrays left out, views at storage offsets 1-3
  flagged for 4-byte accesses, 2000 arrays split into launches in index
  order, and the table's layout (``csrc/multi_update.cuh``);
* ``Module.update``'s one-call path against the per-index ``Updater``
  loop over 4 batches of a small MLP — SGD momentum 0.9 with a
  ``FactorScheduler(step=2)`` boundary inside a step, an lr_mult and a
  wd_mult on one parameter and ``clip_gradient``; Adam — weights,
  states, ``_index_update_count`` and ``num_update`` bit for bit, and the
  weights within 1e-4 of the JAX package's ``Module.fit`` on the same
  data and parameters (``test_torch_train_fit.py``'s limit);
* a save of the optimizer states after 2 batches and a load into a fresh
  module, then 2 more batches: the weights and states of an
  uninterrupted 4-batch fit, bit for bit.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import ctypes

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck

TOL = 2e-5
FIT_TOL = 1e-4
SHAPES = [(7, 13), (64, 3, 3, 3), (1000,), (1,), (5,), (3, 4)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def _arrays(k, seed):
    """k float32 arrays a shape of SHAPES (the last non-negative, an Adam
    var), and a per-array lr and wd."""
    rs = np.random.RandomState(seed)
    arrs = [[rs.randn(*s).astype(np.float32) for _ in range(k)]
            for s in SHAPES]
    for a in arrs:
        a[-1] = np.abs(a[-1])
    lrs = list(rs.uniform(1e-3, 0.2, len(SHAPES)))
    wds = list(rs.uniform(0.0, 1e-2, len(SHAPES)))
    wds[0] = 0.0
    return arrs, lrs, wds


# ---------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("clip", [-1.0, 0.3])
def test_sgd_mom_multi_plain_matches_pallas_per_array(clip):
    arrs, lrs, wds = _arrays(3, 0)
    hp = dict(momentum=0.9, rescale=1 / 8, clip=clip)
    got = ck.sgd_mom_update_multi_plain(
        *([_t(a[j]) for a in arrs] for j in range(3)), lrs, wds, **hp)
    for (w, g, m), lr, wd, new in zip(arrs, lrs, wds, got):
        ref = pk.pallas_sgd_mom_update(
            jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), lr, 0.9, wd,
            1 / 8, clip if clip > 0 else None)
        for r, t in zip(ref, new):
            _close(r, t)
    ts = [[_t(a[j]) for a in arrs] for j in range(3)]
    ck.sgd_mom_update_multi(*ts, lrs, wds, **hp)
    for (w, g, m), lr, wd, nw, nm in zip(arrs, lrs, wds, ts[0], ts[2]):
        one = ck.sgd_mom_update(_t(w), _t(g), _t(m), lr, wd=wd, **hp)
        assert torch.equal(one[0], nw) and torch.equal(one[1], nm)


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_adam_multi_plain_matches_pallas_per_array(clip):
    arrs, lrs, wds = _arrays(4, 1)
    hp = dict(beta1=0.8, beta2=0.99, epsilon=1e-6, rescale=0.5, clip=clip)
    got = ck.adam_update_multi_plain(
        *([_t(a[j]) for a in arrs] for j in range(4)), lrs, wds, **hp)
    for (w, g, mean, var), lr, wd, new in zip(arrs, lrs, wds, got):
        ref = pk.pallas_adam_update(
            jnp.asarray(w), jnp.asarray(g), jnp.asarray(mean),
            jnp.asarray(var), lr, 0.8, 0.99, 1e-6, wd, 0.5,
            clip if clip > 0 else None)
        for r, t in zip(ref, new):
            _close(r, t)
    ts = [[_t(a[j]) for a in arrs] for j in range(4)]
    ck.adam_update_multi(*ts, lrs, wds, **hp)
    for a, lr, wd, *new in zip(arrs, lrs, wds, ts[0], ts[2], ts[3]):
        one = ck.adam_update(*(_t(x) for x in a), lr, wd=wd, **hp)
        assert all(torch.equal(x, y) for x, y in zip(one, new))


def test_multi_wrappers_on_cpu_count_nothing_and_refuse_bad_lists():
    ck.reset_launch_counts()
    w, g = [torch.ones(3), torch.ones(2)], [torch.ones(3), torch.ones(2)]
    ck.sgd_mom_update_multi(w, g, [torch.zeros(3), torch.zeros(2)],
                            [0.1, 0.1], [0.0, 0.0], 0.9)
    assert torch.equal(w[1], torch.full((2,), 0.9))
    ck.adam_update_multi([], [], [], [], [], [])
    assert ck.launch_counts() == {n: 0 for n in ck.COUNTERS}
    with pytest.raises(MXNetError, match="differ in length"):
        ck.sgd_mom_update_multi(w, w, w, [0.1], [0.0, 0.0])
    with pytest.raises(MXNetError, match=r"moms\[1\] is \(3,\)"):
        ck.sgd_mom_update_multi(w, w, [torch.zeros(3)] * 2, [0.1] * 2,
                                [0.0] * 2)
    meta = [torch.ones(3), torch.ones(2, device="meta")]
    with pytest.raises(MXNetError, match=r"grads\[1\] is on meta, "
                       r"weights\[0\] on cpu"):
        ck.sgd_mom_update_multi(w, meta, g, [0.1] * 2, [0.0] * 2)


# ------------------------------------------------------------ the planner
def _blocks(lens, plans):
    """(array, start, stop) of every block of every launch, found as the
    kernel finds it: the first array whose cumulative chunk count passes
    the block's index."""
    out = []
    for pos, ends in plans:
        for c in range(int(ends[-1])):
            a = int(np.searchsorted(ends, c, side="right"))
            start = (c - (int(ends[a - 1]) if a else 0)) * ck.MULTI_CHUNK
            stop = min(start + ck.MULTI_CHUNK, lens[pos[a]])
            assert start < stop
            out.append((int(pos[a]), start, stop))
    return out


def test_plan_covers_every_element_once_within_one_array():
    lens = [0, 1, 3, 4, 5, 8191, 8192, 8193, 3 * 8192 + 7, 0, 7, 2359296]
    plans = ck._multi_plan(lens)
    assert len(plans) == 1
    seen = [np.zeros(n, np.int64) for n in lens]
    for a, start, stop in _blocks(lens, plans):
        seen[a][start:stop] += 1
    assert all((s == 1).all() for s in seen)
    assert list(plans[0][0]) == [i for i, n in enumerate(lens) if n]
    assert int(plans[0][1][-1]) == sum(-(-n // ck.MULTI_CHUNK) for n in lens)


def test_plan_of_only_empty_arrays_launches_nothing():
    assert ck._multi_plan([0, 0, 0]) == []
    assert ck._multi_tables([[16, 32], [16, 32], [16, 32]], [0, 0],
                            [0.1, 0.1], [0.0, 0.0]) == []


def test_plan_splits_2000_arrays_into_launches_in_index_order():
    lens = [7] * 2000
    plans = ck._multi_plan(lens)
    assert [len(p) for p, _ in plans] == [ck.MULTI_CAP] * 3 + \
        [2000 - 3 * ck.MULTI_CAP]
    assert list(np.concatenate([p for p, _ in plans])) == list(range(2000))
    tables = ck._multi_tables(np.arange(3 * 2000).reshape(3, 2000) * 64,
                              lens, [0.5] * 2000, [0.0] * 2000)
    assert [b for _, b in tables] == [len(p) for p, _ in plans]
    f = tables[1][0]
    assert f["count"] == ck.MULTI_CAP
    assert f["ptr"][0, 0] == ck.MULTI_CAP * 64
    assert f["ptr"][2, 0] == (2 * 2000 + ck.MULTI_CAP) * 64


@pytest.mark.parametrize("ops", [3, 4])
def test_table_layout_is_the_kernels(ops):
    """The table is ``mxmulti::Table<ops>`` field by field (the offsets
    the C struct gives them) and fits a kernel's 32,764 bytes of
    parameters; lr and wd are the float32 a ``ctypes.c_float`` argument
    would carry."""
    cap = ck.MULTI_CAP
    offsets = {"ptr": 0, "n": 8 * ops * cap, "lr": (8 * ops + 8) * cap,
               "wd": (8 * ops + 12) * cap, "chunk_end": (8 * ops + 16) * cap,
               "vec": (8 * ops + 20) * cap, "count": (8 * ops + 24) * cap,
               "pad": (8 * ops + 24) * cap + 4}
    dt = ck._MULTI_TABLE[ops]
    assert {k: dt.fields[k][1] for k in dt.names} == offsets
    assert dt.itemsize == (8 * ops + 24) * cap + 8 <= 32764
    lens = [5, 0, 9000]
    ptrs = [[256 * (4 * j + i) for i in range(3)] for j in range(ops)]
    lrs, wds = [0.1, 0.2, 1 / 3], [1e-4, 0.0, 0.7]
    (f, blocks), = ck._multi_tables(ptrs, lens, lrs, wds)
    assert f.nbytes == dt.itemsize and blocks == 3
    assert f["count"] == 2
    assert list(f["n"][:3]) == [5, 9000, 0]
    assert list(f["chunk_end"][:2]) == [1, 3]
    assert list(f["ptr"][:, 1]) == [p[2] for p in ptrs]
    for k, i in enumerate((0, 2)):
        assert f["lr"][k] == np.float32(ctypes.c_float(lrs[i]).value)
        assert f["wd"][k] == np.float32(ctypes.c_float(wds[i]).value)


def test_views_at_offsets_1_to_3_take_4_byte_accesses():
    base = torch.zeros(4096)
    assert base.data_ptr() % 16 == 0
    views = [base[k:k + 100] for k in range(8)]
    ptrs = [[v.data_ptr() for v in views]] * 3
    (table, _), = ck._multi_tables(ptrs, [100] * 8, [0.1] * 8, [0.0] * 8)
    assert list(table["vec"][:8]) == [1, 0, 0, 0, 1, 0, 0, 0]
    aligned = [v.data_ptr() for v in views[::4]]
    (table, _), = ck._multi_tables(
        [aligned, [views[1].data_ptr(), aligned[1]], aligned], [100] * 2,
        [0.1] * 2, [0.0] * 2)
    assert list(table["vec"][:2]) == [0, 1]


# --------------------------------------------------- Module.update's path
def _mlp(sym):
    w1 = sym.var("fc1_weight", attr={"__lr_mult__": "2.0",
                                     "__wd_mult__": "0.5"})
    h = sym.Activation(sym.FullyConnected(sym.var("data"), weight=w1,
                                          num_hidden=16, name="fc1"),
                       act_type="relu", name="relu1")
    return sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=10,
                                                name="fc2"), name="softmax")


def _data():
    rs = np.random.RandomState(3)
    return (rs.rand(32, 20).astype(np.float32),
            rs.randint(0, 10, 32).astype(np.float32))


def _opt_params(pkg, optimizer):
    if optimizer == "sgd":
        return {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                "clip_gradient": 0.05,
                "lr_scheduler": pkg.lr_scheduler.FactorScheduler(
                    step=2, factor=0.5)}
    return {"learning_rate": 0.01, "wd": 1e-3}


def _jax_fit(optimizer):
    X, y = _data()
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(_mlp(mx.sym), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    args, _ = mod.get_params()
    params = {k: v.asnumpy() for k, v in args.items()}
    mod.fit(it, num_epoch=1, optimizer=optimizer,
            optimizer_params=_opt_params(mx, optimizer))
    return params, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _per_index(mod):
    """``mod.update`` as the per-index ``Updater`` loop."""
    def update():
        for i, (w, g) in enumerate(zip(mod._exec_group.param_arrays,
                                       mod._exec_group.grad_arrays)):
            if g is not None:
                mod._updater(i, g, w)
    mod.update = update


def _fit(params, optimizer, lo=0, hi=32, mod=None, per_index=False):
    X, y = _data()
    it = mxt.io.NDArrayIter(X[lo:hi], y[lo:hi], batch_size=8)
    if mod is None:
        mod = mxt.mod.Module(_mlp(mxt.sym), context=mxt.cpu())
    if per_index:
        _per_index(mod)
    kw = {} if params is None else dict(
        arg_params=mxt.convert.params_from_numpy(params, mxt.cpu()))
    mod.fit(it, num_epoch=1, optimizer=optimizer,
            optimizer_params=_opt_params(mxt, optimizer), **kw)
    return mod


def _state(mod):
    o = mod._optimizer
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            mxt.convert.optimizer_states_to_numpy(mod),
            dict(o._index_update_count), o.num_update)


def _assert_bits(a, b):
    """Weights, states, update counts and num_update alike, bit for
    bit."""
    assert a[2] == b[2] and a[3] == b[3]
    for x, y in ((a[0], b[0]), (a[1], b[1])):
        assert sorted(x) == sorted(y)
        for k in x:
            u, v = (z if isinstance(z, list) else [z] for z in (x[k], y[k]))
            assert len(u) == len(v), k
            for p, q in zip(u, v):
                np.testing.assert_array_equal(p, q, err_msg=k)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_module_update_one_call_matches_per_index_and_jax(optimizer):
    params, jax_after = _jax_fit(optimizer)
    multi = _fit(params, optimizer)
    per_index = _fit(params, optimizer, per_index=True)
    got, want = _state(multi), _state(per_index)
    _assert_bits(got, want)
    assert got[3] == 4 and set(got[2].values()) == {4}
    o = multi._optimizer
    if optimizer == "sgd":     # the schedule's boundary inside step 3
        assert o.lr_scheduler(2) == 0.1 and o.lr_scheduler(3) == 0.05
        assert o.lr_mult == {"fc1_weight": 2.0}
        assert o.wd_mult["fc1_weight"] == 0.5
    for k, v in jax_after.items():
        _close(v, got[0][k], FIT_TOL)
        assert np.abs(v - params[k]).max() > 0, k


def test_scheduler_boundary_inside_a_step_splits_the_lrs():
    """The lrs of the third step: index 0 read before the count that
    crosses the FactorScheduler's boundary, the others after it."""
    mod = mxt.mod.Module(_mlp(mxt.sym), context=mxt.cpu())
    X, y = _data()
    mod.bind([("data", (8, 20))], [("softmax_label", (8,))])
    mod.init_params(mxt.initializer.Xavier())
    mod.init_optimizer(optimizer_params=_opt_params(mxt, "sgd"))
    o = mod._optimizer
    seen = [o._lrs_wds(range(4)) for _ in range(3)]
    assert [lrs for lrs, _ in seen][2] == [0.2, 0.05, 0.05, 0.05]
    assert seen[0][0] == [0.2, 0.1, 0.1, 0.1]
    assert seen[0][1] == [5e-4, 0.0, 1e-3, 0.0]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_optimizer_states_saved_and_loaded_mid_fit_give_the_same_bits(
        optimizer, tmp_path):
    params, _ = _jax_fit(optimizer)
    whole = _state(_fit(params, optimizer))
    first = _fit(params, optimizer, hi=16)
    prefix = str(tmp_path / "mlp")
    first.save_checkpoint(prefix, 1, save_optimizer_states=True)
    fresh = mxt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=mxt.cpu())
    _assert_bits(_state(_fit(None, optimizer, lo=16, mod=fresh)), whole)
