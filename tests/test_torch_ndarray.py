"""The NDArray operators and the ``sum`` / ``relu`` ops: the PyTorch port
against the JAX package on the same numpy-seeded inputs (CPU).

Every operator the port's NDArray carries — ``+ - * / % **`` with
arrays and scalars, reflected and in place, unary ``-`` and ``abs``, the
six comparisons (0/1 in the input's dtype), ``[]`` and ``[] =`` — and
the registry ops ``sum`` (``axis``, ``keepdims``, ``exclude``; alias
``sum_axis``) and ``relu``, one case each. Where the JAX package's
NDArray has no such operator (``%`` reflected, which Python then
refuses), numpy is the reference. Tolerance 1e-6: one float32 op each,
``sum`` over at most 24 terms in another order.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 1e-6
RS = np.random.RandomState(0)
A = RS.uniform(-2.0, 2.0, (4, 6)).astype(np.float32)
B = RS.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
P = RS.uniform(0.5, 1.5, (4, 6)).astype(np.float32)   # pow's base
X3 = RS.randn(2, 3, 4).astype(np.float32)


def _inplace(op):
    """``a <op>= b``; returns (the name's new value, the old handle)."""
    def run(a, b):
        alias = a
        if op == "+":
            a += b
        elif op == "-":
            a -= b
        elif op == "*":
            a *= b
        elif op == "/":
            a /= b
        elif op == "%":
            a %= b
        else:
            a **= b
        return a, alias
    return run


BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
}
SCALAR = {"add": 1.5, "sub": 0.75, "mul": -2.0, "div": 4.0, "mod": 0.75,
          "pow": 2.0}
REFLECTED = {
    "add": lambda a: 1.5 + a, "sub": lambda a: 0.75 - a,
    "mul": lambda a: -2.0 * a, "div": lambda a: 4.0 / a,
    "pow": lambda a: 2.0 ** a,
}
SYMBOL = {"add": "+", "sub": "-", "mul": "*", "div": "/", "mod": "%",
          "pow": "**"}
COMPARE = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
}


def _both(fn, *arrays):
    """``fn(package, *NDArrays)`` in the JAX package and in the port
    (CPU), as numpy."""
    return tuple(fn(pkg, *[pkg.nd.array(x, ctx=pkg.cpu())
                           for x in arrays]).asnumpy()
                 for pkg in (mxj, mxt))


def _same(want, got):
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (want.shape, got.shape, want.dtype, got.dtype)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _lhs(name):
    return P if name == "pow" else A


@pytest.mark.parametrize("name", list(BINARY))
@pytest.mark.parametrize("form", ["array", "scalar", "reflected",
                                  "inplace_array", "inplace_scalar"])
def test_binary_operator(name, form):
    fn = BINARY[name]
    lhs = _lhs(name)
    if form == "array":
        _same(*_both(lambda pkg, a, b: fn(a, b), lhs, B))
    elif form == "scalar":
        _same(*_both(lambda pkg, a: fn(a, SCALAR[name]), lhs))
    elif form == "reflected":
        if name == "mod":
            # the JAX package's NDArray has no __rmod__: numpy is the
            # reference
            got = (3.0 % mxt.nd.array(B, ctx=mxt.cpu())).asnumpy()
            _same(np.mod(np.float32(3.0), B), got)
        else:
            _same(*_both(lambda pkg, a: REFLECTED[name](a), lhs))
    else:
        run = _inplace(SYMBOL[name])
        other = SCALAR[name] if form == "inplace_scalar" else None
        j_a, t_a = mxj.nd.array(lhs, ctx=mxj.cpu()), \
            mxt.nd.array(lhs, ctx=mxt.cpu())
        j_out, _ = run(j_a, other if other is not None
                       else mxj.nd.array(B, ctx=mxj.cpu()))
        t_out, t_alias = run(t_a, other if other is not None
                             else mxt.nd.array(B, ctx=mxt.cpu()))
        _same(j_out.asnumpy(), t_out.asnumpy())
        # the port updates the cell itself: an alias sees the new value
        assert t_out is t_alias


@pytest.mark.parametrize("name", ["neg", "abs"])
def test_unary_operator(name):
    fn = (lambda a: -a) if name == "neg" else abs
    _same(*_both(lambda pkg, a: fn(a), A))


@pytest.mark.parametrize("name", list(COMPARE))
@pytest.mark.parametrize("other", ["array", "scalar"])
def test_comparison_returns_input_dtype(name, other):
    a = np.round(A)
    b = np.round(B) if other == "array" else 1.0
    if other == "array":
        want, got = _both(lambda pkg, x, y: COMPARE[name](x, y), a, b)
    else:
        want, got = _both(lambda pkg, x: COMPARE[name](x, b), a)
    assert got.dtype == np.float32
    _same(want, got)


@pytest.mark.parametrize("key", [1, -1, slice(1, 3), (2, slice(0, 4, 2)),
                                 (slice(None), 3)],
                         ids=["int", "negative", "slice", "tuple",
                              "column"])
def test_getitem(key):
    _same(*_both(lambda pkg, a: a[key], A))


@pytest.mark.parametrize("case", ["int_scalar", "slice_array",
                                  "full_scalar", "full_array",
                                  "full_ndarray"])
def test_setitem(case):
    row = RS.randn(6).astype(np.float32)

    def run(pkg, a):
        if case == "int_scalar":
            a[1] = 5.0
        elif case == "slice_array":
            a[1:3] = np.stack([row, row])
        elif case == "full_scalar":
            a[:] = -1.25
        elif case == "full_array":
            a[:] = B
        else:
            a[:] = pkg.nd.array(B, ctx=pkg.cpu())
        return a

    j = run(mxj, mxj.nd.array(A, ctx=mxj.cpu()))
    t = mxt.nd.array(A, ctx=mxt.cpu())
    alias = t
    t = run(mxt, t)
    _same(j.asnumpy(), t.asnumpy())
    assert alias is t


@pytest.mark.parametrize("kwargs", [{}, {"axis": 1}, {"axis": (0, 2)},
                                    {"axis": 1, "keepdims": True},
                                    {"axis": -1, "exclude": True},
                                    {"keepdims": True}],
                         ids=["all", "axis", "axes", "keepdims", "exclude",
                              "all_keepdims"])
def test_sum(kwargs):
    _same(*_both(lambda pkg, x: pkg.nd.sum(x, **kwargs), X3))


def test_sum_axis_alias():
    _same(*_both(lambda pkg, x: pkg.nd.sum_axis(x, axis=0), X3))


def test_relu():
    z = X3.copy()
    z[0, 0, :2] = 0.0
    _same(*_both(lambda pkg, x: pkg.nd.relu(x), z))


def test_int32_power_with_negative_exponent_truncates():
    """Integer ``**`` with a negative exponent: the port gives the
    truncated value, 0 for |base| > 1 and +-1 for a base of +-1 (C's
    integer division of 1 by base ** -e). The JAX package's ``jnp.power``
    on int32 overflows there (``5 ** -2`` is -558738647), an undefined
    value that is not copied; bases of +-1 and 0 results agree."""
    base = np.array([5, 7, 1, -1, 2, -1, -3, 1], np.int32)
    expo = np.array([-2, -1, -3, -3, -1, -2, -1, -1], np.int32)
    want = np.array([0, 0, 1, -1, 0, 1, 0, 1], np.int32)
    a, b = (mxt.nd.array(x, ctx=mxt.cpu()) for x in (base, expo))
    got = (a ** b).asnumpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    refl = (2 ** b).asnumpy()       # 2 ** negative: 0 everywhere
    np.testing.assert_array_equal(refl, np.zeros(8, np.int32))
    ref = (mxj.nd.array(base, ctx=mxj.cpu())
           ** mxj.nd.array(expo, ctx=mxj.cpu())).asnumpy()
    unit = np.abs(base) == 1
    np.testing.assert_array_equal(got[unit], ref[unit])


# --------------------------------------------------------------------------
# the rest of the NDArray surface: methods, factories, module helpers
# --------------------------------------------------------------------------
METHODS = {
    "copy": lambda pkg, a: a.copy(),
    "astype_int32": lambda pkg, a: a.astype("int32"),
    "astype_float16": lambda pkg, a: a.astype(np.float16),
    "reshape": lambda pkg, a: a.reshape((3, -1)),
    "reshape_codes": lambda pkg, a: a.reshape((0, 2, -1)),
    "reshape_int": lambda pkg, a: a.reshape(24),
    "T": lambda pkg, a: a.T,
    "as_in_context": lambda pkg, a: a.as_in_context(pkg.cpu()),
    "copyto_context": lambda pkg, a: a.copyto(pkg.cpu()),
    "iter": lambda pkg, a: pkg.nd.concatenate(list(a), axis=0),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method(name):
    _same(*_both(lambda pkg, a: METHODS[name](pkg, a), A))


def test_size_len_asscalar_wait():
    for pkg in (mxj, mxt):
        a = pkg.nd.array(X3, ctx=pkg.cpu())
        assert a.size == 24 and len(a) == 2 and a.ndim == 3
        assert [x.shape for x in a] == [(3, 4), (3, 4)]
        one = pkg.nd.array(np.array([2.5], np.float32), ctx=pkg.cpu())
        assert one.asscalar() == np.float32(2.5)
        assert isinstance(one.asscalar(), np.float32)
        with pytest.raises(ValueError):
            a.asscalar()
        a.wait_to_read()
        a.wait_to_write()
        pkg.nd.waitall()
        with pytest.raises(TypeError):
            len(pkg.nd.array(np.float32(1.0), ctx=pkg.cpu()))


def test_copy_and_astype_do_not_alias():
    a = mxt.nd.array(A, ctx=mxt.cpu())
    for b in (a.copy(), a.astype("float32"), a.copyto(mxt.cpu())):
        b[:] = 0.0
        assert b.asnumpy().max() == 0.0 and a.asnumpy().max() > 0.0
    assert a.as_in_context(mxt.cpu()) is a


def test_copyto_ndarray_takes_its_dtype():
    for pkg in (mxj, mxt):
        dst = pkg.nd.zeros((4, 6), ctx=pkg.cpu(), dtype="int32")
        out = pkg.nd.array(A * 3, ctx=pkg.cpu()).copyto(dst)
        assert out is dst
    _same(*_both(lambda pkg, a: a.copyto(pkg.nd.zeros(
        (4, 6), ctx=pkg.cpu(), dtype="int32")), A * 3))
    with pytest.raises(ValueError):
        mxt.nd.array(A, ctx=mxt.cpu()).copyto(mxt.nd.zeros((2, 2),
                                                           ctx=mxt.cpu()))


FACTORIES = {
    "ones": lambda pkg: pkg.nd.ones((2, 3), ctx=pkg.cpu()),
    "ones_int": lambda pkg: pkg.nd.ones(4, ctx=pkg.cpu(), dtype="int32"),
    "full": lambda pkg: pkg.nd.full((3, 2), 2.5, ctx=pkg.cpu()),
    "full_f16": lambda pkg: pkg.nd.full((3,), -1.5, ctx=pkg.cpu(),
                                        dtype="float16"),
    "empty": lambda pkg: pkg.nd.empty((2, 2), ctx=pkg.cpu()),
    "zeros": lambda pkg: pkg.nd.zeros((1, 4), ctx=pkg.cpu(), dtype="int32"),
    "arange": lambda pkg: pkg.nd.arange(2, 11, 3, ctx=pkg.cpu()),
    "arange_stop_none": lambda pkg: pkg.nd.arange(5, ctx=pkg.cpu()),
    "arange_repeat": lambda pkg: pkg.nd.arange(0, 3, repeat=2,
                                               ctx=pkg.cpu(), dtype="int32"),
    "concatenate": lambda pkg: pkg.nd.concatenate(
        [pkg.nd.array(A, ctx=pkg.cpu()), pkg.nd.array(B, ctx=pkg.cpu())],
        axis=1),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory(name):
    want, got = FACTORIES[name](mxj).asnumpy(), FACTORIES[name](mxt).asnumpy()
    _same(want, got)


def test_empty_is_zeros_and_factories_land_on_the_context():
    """``empty`` is zeros in the JAX package, unlike ``torch.empty``; every
    factory makes its tensor on its context's device."""
    with mxt.cpu():
        for name in ("ones", "full", "empty", "arange"):
            out = getattr(mxt.nd, name)(*((3,) if name != "full"
                                          else ((3,), 7.0)))
            assert out.astorch().device.type == "cpu"
            assert out.context == mxt.cpu()
    assert mxt.nd.empty((64,), ctx=mxt.cpu()).asnumpy().tolist() == [0.0] * 64


HELPERS = ["add", "subtract", "multiply", "divide", "true_divide", "power",
           "maximum", "minimum", "equal", "not_equal", "greater",
           "greater_equal", "lesser", "lesser_equal"]


@pytest.mark.parametrize("name", HELPERS)
@pytest.mark.parametrize("form", ["arrays", "scalar_right", "scalar_left",
                                  "int_array_float_scalar"])
def test_module_helper(name, form):
    a = np.round(P * 2)
    b = np.round(B * 2)

    def run(pkg, x, y):
        fn = getattr(pkg.nd, name)
        if form == "arrays":
            return fn(x, y)
        if form == "scalar_right":
            return fn(x, 2.0)
        if form == "scalar_left":
            return fn(2.0, x)
        return fn(pkg.nd.array(a.astype(np.int32), ctx=pkg.cpu()), 1.5)
    want, got = _both(run, a, b)
    _same(want, got)


def test_moveaxis_and_onehot_encode():
    _same(*_both(lambda pkg, x: pkg.nd.moveaxis(x, 0, -1), X3))
    idx = np.array([0, 3, 5, -1, 2.7], np.float32)
    for pkg in (mxj, mxt):
        out = pkg.nd.zeros((5, 4), ctx=pkg.cpu())
        res = pkg.nd.onehot_encode(pkg.nd.array(idx, ctx=pkg.cpu()), out)
        assert res is out
        if pkg is mxj:
            want = out.asnumpy()
    _same(want, out.asnumpy())
    assert out.asnumpy().sum(1).tolist() == [1, 1, 0, 0, 1]
