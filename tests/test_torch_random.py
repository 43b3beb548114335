"""``mx.random`` and the ops that draw from it, against the JAX package on
the CPU.

* the key chain: ``seed``, ``next_key``, ``split``, ``fold_in`` and a
  ``get_state`` / ``set_state`` round trip give the JAX package's keys;
* ``bits``, ``uniform`` and ``bernoulli`` give ``jax.random``'s values bit
  for bit at odd shapes, in float32, float16 and bfloat16;
* ``normal`` within 1e-5 of max(1, |value|) (``erfinv`` is not XLA's
  polynomial: measured over 2e6 draws the largest relative difference is
  5.8e-6, at |value| 3.76, where erfinv's slope magnifies it), and
  ``exponential`` within 2 float32 ulps;
* the samplers (``mx.nd.*`` and in a graph): uniform bit for bit, normal
  and exponential as above, gamma, Poisson and the negative binomials by
  their mean and variance (PyTorch's samplers under a key-seeded
  generator: 20000 draws, within 5 standard errors);
* Dropout: the op's masks in the three types bit for bit (the kept
  value 1 / keep as the JAX package rounds it); a graph of three
  Dropouts after the same seed drops the JAX executor's elements, its
  outputs and gradients within 1e-6; inference is the identity;
* LRN and Concat forward within 1e-6 and gradients within 1e-5;
* the initializers, after the same seed, hold the JAX package's initial
  weights: uniform draws bit for bit, normal ones as above; and a
  ``Module.fit`` of a Dropout MLP from the same seed, reseeded between
  steps, ends within 1e-6 of the JAX package's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_get_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.nn import dropout_mask_value

CPU = mxt.cpu()
SHAPES = [(1,), (7,), (3, 5, 11), (4099,)]
TYPES = [(jnp.float32, torch.float32), (jnp.float16, torch.float16),
         (jnp.bfloat16, torch.bfloat16)]
NORMAL_TOL = 1e-5


def _key(seed=7, i=1):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed))[i])


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _near_normal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= NORMAL_TOL, err.max()


# ------------------------------------------------------------- key chain
@pytest.mark.parametrize("seed", [0, 7, 123456789, -3, 2 ** 40 + 5])
def test_seed_and_next_key_follow_the_jax_chain(seed):
    mx.random.seed(seed)
    mxt.random.seed(seed)
    assert (np.asarray(jax.random.PRNGKey(seed)) ==
            mxt.random.prng_key(seed)).all()
    for _ in range(5):
        assert (np.asarray(mx.random.next_key()) ==
                mxt.random.next_key()).all()
    assert mxt.random.generation() >= 1


def test_split_and_fold_in_match_jax():
    key = _key()
    assert (np.asarray(jax.random.split(key, 5)) ==
            mxt.random.split(key, 5)).all()
    for d in (0, 1, 17, 2 ** 31 + 3):
        assert (np.asarray(jax.random.fold_in(key, d)) ==
                mxt.random.fold_in(key, d)).all()


def test_get_state_set_state_round_trip_continues_the_chain():
    mx.random.seed(5)
    mxt.random.seed(5)
    mx.random.next_key()
    mxt.random.next_key()
    js, ts = mx.random.get_state(), mxt.random.get_state()
    assert (js["key"] == ts["key"]).all()
    gen = mxt.random.generation()
    want = [np.asarray(mx.random.next_key()) for _ in range(3)]
    mxt.random.set_state(js)            # the JAX package's snapshot
    assert mxt.random.generation() == gen + 1
    assert all((w == mxt.random.next_key()).all() for w in want)
    mxt.random.set_state({"key": None, "generation": 0})
    assert mxt.random.get_state()["key"] is None
    mxt.random.set_state(ts)
    assert all((w == mxt.random.next_key()).all() for w in want)


# ------------------------------------------------------------ plain draws
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_bernoulli_bit_for_bit(shape):
    key = _key()
    want = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    assert (mxt.random.bits(key, shape).numpy() == want).all()
    for p in (0.1, 0.5, 0.9):
        assert (np.asarray(jax.random.bernoulli(key, p, shape)) ==
                mxt.random.bernoulli(key, p, shape).numpy()).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("types", TYPES, ids=["f32", "f16", "bf16"])
def test_uniform_bit_for_bit(shape, types):
    jdt, tdt = types
    key = _key(3)
    for lo, hi in ((0.0, 1.0), (-0.07, 0.07), (-2.5, 3.3), (0.3, 0.9)):
        want = np.asarray(jax.random.uniform(key, shape, jdt, lo, hi))
        got = mxt.random.uniform(key, shape, lo, hi, tdt)
        assert got.dtype == tdt
        assert (_ulps(got.float().numpy(), want.astype(np.float32)) == 0
                ).all(), (lo, hi)
        # the card wrapper's plain version is the same function
        if tdt == torch.float32:
            assert torch.equal(ck.uniform(key, shape, lo, hi), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_and_exponential_within_ulps(shape):
    key = _key(11)
    _near_normal(mxt.random.normal(key, shape).numpy(),
                 jax.random.normal(key, shape))
    _near_normal(ck.uniform(key, shape, transform=mxt.random.NORMAL).numpy(),
                 jax.random.normal(key, shape))
    assert _ulps(mxt.random.exponential(key, shape).numpy(),
                 jax.random.exponential(key, shape)).max() <= 2
    for jdt, tdt in TYPES[1:] if len(shape) == 1 else ():
        got = mxt.random.normal(key, shape, tdt).float().numpy()
        want = np.asarray(jax.random.normal(key, shape, jdt), np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


# --------------------------------------------------------------- samplers
def test_nd_samplers_draw_one_key_a_call_and_match_jax():
    mx.random.seed(21)
    mxt.random.seed(21)
    with mxt.cpu():
        for _ in range(2):
            want = mx.nd.random_uniform(low=-1.5, high=2.0, shape=(5, 7))
            got = mxt.nd.random_uniform(low=-1.5, high=2.0, shape=(5, 7))
            assert (_ulps(got.asnumpy(), want.asnumpy()) == 0).all()
        _near_normal(mxt.nd.normal(loc=1.0, scale=2.0, shape=(3, 9))
                     .asnumpy(),
                     mx.nd.normal(loc=1.0, scale=2.0, shape=(3, 9))
                     .asnumpy())
        got = mxt.nd.random_exponential(lam=2.0, shape=(64,)).asnumpy()
        want = mx.nd.random_exponential(lam=2.0, shape=(64,)).asnumpy()
        assert _ulps(got, want).max() <= 2
    assert (np.asarray(mx.random.next_key()) ==
            mxt.random.next_key()).all()


@pytest.mark.parametrize("name,attrs,mean,var", [
    ("_random_gamma", {"alpha": 2.5, "beta": 1.5}, 2.5 * 1.5,
     2.5 * 1.5 ** 2),
    ("_random_poisson", {"lam": 3.0}, 3.0, 3.0),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, 3 * 0.6 / 0.4,
     3 * 0.6 / 0.16),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 2.0 + 0.5 * 4.0),
])
def test_moment_samplers_match_their_distribution(name, attrs, mean, var):
    n = 20000
    opdef = jax_get_op(name)
    want = np.asarray(opdef.forward(
        opdef.normalize_attrs(dict(attrs, shape=(n,))), [], [], False,
        _key(4))[0][0])
    with mxt.cpu():
        got = getattr(mxt.nd, name)(shape=(n,), **attrs).asnumpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    for draws in (got, want):
        se_mean = np.sqrt(var / n)
        assert abs(draws.mean() - mean) < 5 * se_mean
        assert abs(draws.var() - var) < 5 * var * np.sqrt(2.0 / n) * 2


def test_sampler_in_a_graph_folds_the_node_index():
    def net(pkg):
        a = pkg.sym.uniform(low=-1.0, high=1.0, shape=(3, 4), name="u")
        b = pkg.sym.var("x")
        return pkg.sym.Group([a + b, pkg.sym.normal(shape=(2, 2), name="n")])
    X = np.arange(12, dtype="f").reshape(3, 4)
    mx.random.seed(9)
    mxt.random.seed(9)
    je = net(mx).simple_bind(mx.cpu(), grad_req="null", x=(3, 4))
    te = net(mxt).simple_bind(CPU, grad_req="null", x=(3, 4))
    for _ in range(2):
        jo = je.forward(x=X)
        to = te.forward(x=X)
        assert (_ulps(to[0].asnumpy(), jo[0].asnumpy()) == 0).all()
        _near_normal(to[1].asnumpy(), jo[1].asnumpy())


# ---------------------------------------------------------------- Dropout
@pytest.mark.parametrize("types", TYPES, ids=["f32", "f16", "bf16"])
@pytest.mark.parametrize("p", [0.1, 0.3, 0.5, 0.7])
def test_dropout_op_masks_bit_for_bit(types, p):
    jdt, tdt = types
    x = np.random.RandomState(0).randn(5, 37).astype(np.float32)
    key = _key(2)
    opdef = jax_get_op("Dropout")
    (jy, jm), _ = opdef.forward({"p": p}, [jnp.asarray(x, jdt)], [], True,
                                key)
    ty, tm = ck.dropout(torch.tensor(x).to(tdt), key, 1.0 - p)
    for a, b in ((ty, jy), (tm, jm)):
        assert a.dtype == tdt
        assert (_ulps(a.float().numpy(),
                      np.asarray(b).astype(np.float32)) == 0).all()
    kept = float(np.asarray(jm).astype(np.float32).max())
    assert kept == dropout_mask_value(1.0 - p, tdt)


def test_dropout_mask_value_rounds_keep_first():
    # float16: keep 0.7 rounds to 0.7001953125 before 1 / keep
    assert dropout_mask_value(0.7, torch.float16) == 1.427734375
    assert dropout_mask_value(0.7, torch.float32) == \
        float(np.float32(1.0) / np.float32(0.7))


def _dropout_net(pkg, inner=False):
    """An MLP with three Dropouts; ``inner``: the Dropouts' outputs."""
    s = pkg.sym
    d0 = s.Dropout(s.var("data"), p=0.2, name="d0")
    net = s.FullyConnected(d0, num_hidden=24, name="fc1")
    d1 = s.Dropout(s.Activation(net, act_type="relu"), p=0.5, name="d1")
    net = s.FullyConnected(d1, num_hidden=16, name="fc2")
    d2 = s.Dropout(net, p=0.3, name="d2")
    if inner:
        return s.Group([d0, d1, d2])
    net = s.FullyConnected(d2, num_hidden=5, name="fc3")
    return s.SoftmaxOutput(net, name="softmax")


def _bind_both(shapes, params, grad_req="write"):
    je = _dropout_net(mx).simple_bind(mx.cpu(), grad_req=grad_req, **shapes)
    te = _dropout_net(mxt).simple_bind(CPU, grad_req=grad_req, **shapes)
    for k, v in params.items():
        je.arg_dict[k][:] = v
        te.arg_dict[k][:] = v
    return je, te


def test_dropout_graph_forward_and_backward_match_jax():
    rs = np.random.RandomState(1)
    shapes = {"data": (6, 10), "softmax_label": (6,)}
    sym = _dropout_net(mxt)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {n: (rs.randn(*s) * 0.3).astype("f")
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    X = rs.randn(6, 10).astype("f")
    y = rs.randint(0, 5, 6).astype("f")
    je, te = _bind_both(shapes, params)
    mx.random.seed(17)
    mxt.random.seed(17)
    for _ in range(2):          # the second forward draws the next key
        jo = je.forward(is_train=True, data=X, softmax_label=y)[0].asnumpy()
        to = te.forward(is_train=True, data=X, softmax_label=y)[0].asnumpy()
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        je.backward()
        te.backward()
        for name in params:
            np.testing.assert_allclose(te.grad_dict[name].asnumpy(),
                                       je.grad_dict[name].asnumpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    # each Dropout drops the JAX package's elements
    mx.random.seed(3)
    mxt.random.seed(3)
    inner = {}
    for pkg in (mx, mxt):
        e = _dropout_net(pkg, inner=True).simple_bind(
            pkg.cpu(), grad_req="null", data=(6, 10))
        for k in params:
            if k in e.arg_dict:
                e.arg_dict[k][:] = params[k]
        inner[pkg] = [o.asnumpy() for o in e.forward(is_train=True, data=X)]
    # the first reads the data: bit for bit; the later ones read matmuls,
    # which the two frameworks sum in other orders: the same zeros
    assert (_ulps(inner[mxt][0], inner[mx][0]) == 0).all()
    for a, b in zip(inner[mxt], inner[mx]):
        assert np.array_equal(a == 0, b == 0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert 0 < (a == 0).mean() < 0.9


def test_dropout_inference_is_the_identity():
    x = np.random.RandomState(2).randn(4, 9).astype("f")
    for p in (0.0, 0.5):
        e = mxt.sym.Dropout(mxt.sym.var("data"), p=p).simple_bind(
            CPU, grad_req="null", data=(4, 9))
        assert np.array_equal(e.forward(is_train=False, data=x)[0]
                              .asnumpy(), x)
    e = mxt.sym.Dropout(mxt.sym.var("data"), p=0.0).simple_bind(
        CPU, grad_req="null", data=(4, 9))
    assert np.array_equal(e.forward(is_train=True, data=x)[0].asnumpy(), x)


def test_dropout_variant_on_cpu_tensors_is_the_plain_op():
    """The card's autograd.Function run on CPU tensors: the plain
    version's outputs and a gradient of ct * mask."""
    key = _key(8)
    x = torch.randn(3, 50, requires_grad=True)
    y, mask = ck.dropout_fn(x, key, 0.6)
    py, pm = ck.dropout_plain(x.detach(), key, 0.6)
    assert torch.equal(y.detach(), py) and torch.equal(mask, pm)
    ct = torch.randn(3, 50)
    y.backward(ct)
    assert torch.equal(x.grad, ct * pm)


# ------------------------------------------------------------ LRN, Concat
def _op_pair(build, shapes, inputs):
    outs, grads = [], []
    for pkg in (mx, mxt):
        exe = build(pkg).simple_bind(pkg.cpu(), grad_req="write", **shapes)
        for k, v in inputs.items():
            exe.arg_dict[k][:] = v
        o = exe.forward(is_train=True)[0]
        ct = np.cos(np.arange(np.prod(o.shape), dtype="f")).reshape(o.shape)
        exe.backward([pkg.nd.array(ct, ctx=pkg.cpu())])
        outs.append(o.asnumpy())
        grads.append({k: exe.grad_dict[k].asnumpy() for k in inputs})
    return outs, grads


@pytest.mark.parametrize("nsize", [3, 5])
def test_lrn_forward_and_gradient_match_jax(nsize):
    x = np.random.RandomState(3).randn(2, 7, 5, 4).astype("f")
    (jo, to), (jg, tg) = _op_pair(
        lambda pkg: pkg.sym.LRN(pkg.sym.var("data"), alpha=1e-3, beta=0.75,
                                knorm=2.0, nsize=nsize),
        {"data": x.shape}, {"data": x})
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg["data"], jg["data"], rtol=1e-5, atol=1e-5)
    assert len(mxt.sym.LRN(mxt.sym.var("d")).list_outputs()) == 1


@pytest.mark.parametrize("dim", [0, 1, 3])
def test_concat_forward_and_gradient_match_jax(dim):
    rs = np.random.RandomState(4)
    shapes = [[2, 3, 4, 5] for _ in range(3)]
    for i, s in enumerate(shapes):
        s[dim] += i
    xs = {f"x{i}": rs.randn(*s).astype("f") for i, s in enumerate(shapes)}
    (jo, to), (jg, tg) = _op_pair(
        lambda pkg: pkg.sym.Concat(*[pkg.sym.var(k) for k in xs], dim=dim),
        {k: v.shape for k, v in xs.items()}, xs)
    assert np.array_equal(to, jo)
    for k in xs:
        assert np.array_equal(tg[k], jg[k])
    assert mxt.sym.concat(mxt.sym.var("a"), mxt.sym.var("b")).tojson() == \
        mx.sym.concat(mx.sym.var("a"), mx.sym.var("b")).tojson()


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("make", [
    lambda pkg: pkg.initializer.Uniform(0.07),
    lambda pkg: pkg.initializer.Xavier(),
    lambda pkg: pkg.initializer.Xavier(factor_type="in", magnitude=2.0),
    lambda pkg: pkg.initializer.Normal(0.05),
    lambda pkg: pkg.initializer.Xavier(rnd_type="gaussian"),
    lambda pkg: pkg.initializer.MSRAPrelu(),
], ids=["uniform", "xavier", "xavier_in", "normal", "xavier_gauss", "msra"])
def test_initializers_draw_the_jax_weights_after_the_same_seed(make):
    shapes = {"a_weight": (16, 3, 3, 3), "b_weight": (10, 33),
              "c_weight": (7,)}
    mx.random.seed(13)
    mxt.random.seed(13)
    ji, ti = make(mx), make(mxt)
    for name, shape in sorted(shapes.items()):
        ja = mx.nd.zeros(shape)
        with mxt.cpu():
            ta = mxt.nd.zeros(shape)
        ji(name, ja)
        ti(name, ta)
        if isinstance(ji, mx.initializer.Normal) or \
                getattr(ji, "rnd_type", "") == "gaussian":
            _near_normal(ta.asnumpy(), ja.asnumpy())
        else:
            assert (_ulps(ta.asnumpy(), ja.asnumpy()) == 0).all()
    assert (np.asarray(mx.random.next_key()) ==
            mxt.random.next_key()).all()


def test_initializer_with_a_generator_leaves_the_chain_alone():
    mxt.random.seed(2)
    want = mxt.random.get_state()["key"]
    with mxt.cpu():
        arr = mxt.nd.zeros((4, 4))
    mxt.initializer.Xavier(rng=torch.Generator().manual_seed(0))(
        "w_weight", arr)
    assert (mxt.random.get_state()["key"] == want).all()
    assert np.abs(arr.asnumpy()).max() > 0


def test_module_fit_with_dropout_and_reseeding_matches_jax():
    """init_params from the chain, two fitted batches, a reseed, two more
    steps by hand: the JAX package's fused step draws its key once, splits
    it a step and draws again after the reseed; the port's step keeps
    the same chain."""
    rs = np.random.RandomState(5)
    X = rs.randn(8, 10).astype("f")
    y = rs.randint(0, 5, 8).astype("f")
    got = {}
    for pkg in (mx, mxt):
        pkg.random.seed(31)
        mod = pkg.mod.Module(_dropout_net(pkg), context=pkg.cpu())
        it = pkg.io.NDArrayIter(X, y, batch_size=4)
        mod.fit(it, num_epoch=1, initializer=pkg.initializer.Xavier(),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-3})
        pkg.random.seed(32)
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        if pkg is mx:
            mod._sync_params_from_devices()
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k, v in got[mx].items():
        np.testing.assert_allclose(got[mxt][k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
