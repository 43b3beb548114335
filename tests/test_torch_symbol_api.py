"""The Symbol API of the port against the JAX package's (CPU).

Graphs built with the operators (``+ - * / **`` with symbols and with
numbers on either side, unary ``-``), ``[]`` by position and by output
name, ``get_internals`` / ``get_output``, ``Group``, the ops ``mx.sym``
gains from the registry, and the module functions ``zeros``, ``ones``,
``arange``, ``pow``, ``maximum``, ``minimum`` and ``hypot`` serialize
with ``tojson()`` to the JAX package's JSON node for node (each built
inside a fresh ``NameManager``: unnamed nodes count globally), and a
JSON from either package loads in the other and evaluates to the same
values (``Symbol.eval``, within 2e-5).
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 2e-5

EXPRESSIONS = {
    "add": lambda s, a, b: a + b, "sub": lambda s, a, b: a - b,
    "mul": lambda s, a, b: a * b, "div": lambda s, a, b: a / b,
    "pow": lambda s, a, b: a ** b, "neg": lambda s, a, b: -a,
    "add_scalar": lambda s, a, b: a + 2, "radd_scalar": lambda s, a, b: 2 + a,
    "sub_scalar": lambda s, a, b: a - 0.5,
    "rsub_scalar": lambda s, a, b: 3 - a,
    "mul_scalar": lambda s, a, b: a * 1.5,
    "rmul_scalar": lambda s, a, b: 1.5 * a,
    "div_scalar": lambda s, a, b: a / 4, "rdiv_scalar": lambda s, a, b: 2 / a,
    "pow_scalar": lambda s, a, b: a ** 2,
    "chain": lambda s, a, b: (a - b) * 2.0 / (b ** 2 + 1) - (-a),
    "sym_pow": lambda s, a, b: s.pow(a, b),
    "sym_pow_scalar": lambda s, a, b: s.pow(a, 3) + s.pow(2, b),
    "sym_max": lambda s, a, b: s.maximum(a, b) + s.maximum(a, 0.5) +
    s.maximum(0.25, b),
    "sym_min": lambda s, a, b: s.minimum(a, b) - s.minimum(a, 0.5) +
    s.minimum(0.25, b),
    "sym_hypot": lambda s, a, b: s.hypot(a, b) * s.hypot(a, 2) +
    s.hypot(3, b),
    "ops": lambda s, a, b: s.sum(s.log_softmax(s.sqrt(s.abs(a)) + b),
                                 axis=1),
    "group": lambda s, a, b: s.Group([a * b, s.BlockGrad(a), s.MakeLoss(
        s.mean(s.square(a - b)), grad_scale=0.5)]),
    "split": lambda s, a, b: s.SliceChannel(a * b, num_outputs=2, axis=1)[1],
    "internals": lambda s, a, b: s.softmax(
        (s.exp(a) * b).get_internals()["exp0_output"], axis=0),
    "get_output": lambda s, a, b: s.Group([s.sin(a), s.cos(b)]).get_output(1),
    "topk": lambda s, a, b: s.topk(a + b, k=2, ret_typ="both")[0],
    "pick": lambda s, a, b: s.pick(a, s.argmax(b, axis=1), axis=1),
}


def _build(pkg, name):
    with pkg.name.NameManager():
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        return EXPRESSIONS[name](pkg.sym, a, b)


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_operator_graph_serializes_as_jax(name):
    js, ts = _build(mxj, name).tojson(), _build(mxt, name).tojson()
    assert ts == js
    assert mxt.symbol.load_json(js).tojson() == js
    assert mxj.symbol.load_json(ts).tojson() == js


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_operator_graph_evaluates_as_jax(name):
    rs = np.random.RandomState(0)
    a = rs.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    b = rs.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    jsym = _build(mxj, name)
    feed = {k: v for k, v in (("a", a), ("b", b))
            if k in jsym.list_arguments()}
    want = jsym.eval(ctx=mxj.cpu(), **{
        k: mxj.nd.array(v) for k, v in feed.items()})
    tsym = mxt.symbol.load_json(jsym.tojson())
    got = tsym.eval(ctx=mxt.cpu(), **{
        k: mxt.nd.array(v, ctx=mxt.cpu()) for k, v in feed.items()})
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("factory", ["zeros", "ones", "arange"])
def test_module_factories_serialize_and_run_as_jax(factory):
    def build(pkg):
        with pkg.name.NameManager():
            if factory == "arange":
                return pkg.sym.arange(2, 11, 3, repeat=2, name="r")
            return getattr(pkg.sym, factory)((2, 3), dtype="int32",
                                             name="z")
    js = build(mxj).tojson()
    assert build(mxt).tojson() == js
    want = build(mxj).eval(ctx=mxj.cpu())[0].asnumpy()
    got = build(mxt).eval(ctx=mxt.cpu())[0].asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_module_functions_on_two_numbers():
    for name in ("pow", "maximum", "minimum", "hypot"):
        assert getattr(mxt.sym, name)(3, 4) == getattr(mxj.sym, name)(3, 4)


def _internals(pkg):
    with pkg.name.NameManager():
        parts = pkg.sym.SliceChannel(pkg.sym.var("a"), num_outputs=3,
                                     name="sc")
        assert len(parts) == 3
        assert [p.list_outputs() for p in parts] == [
            ["sc_output0"], ["sc_output1"], ["sc_output2"]]
        assert parts["sc_output2"].list_outputs() == ["sc_output2"]
        assert parts.get_output(1).list_outputs() == ["sc_output1"]
        with pytest.raises(ValueError):
            parts["nope"]
        return pkg.sym.exp(parts[0] * 2.0, name="e").get_internals()


def test_indexing_len_iter_and_internals():
    want = _internals(mxj).list_outputs()
    assert _internals(mxt).list_outputs() == want == [
        "a", "sc_output0", "sc_output1", "sc_output2", "mul_scalar0_output",
        "e_output"]


def test_attr_reads_user_attrs_then_op_params():
    for pkg in (mxj, mxt):
        with pkg.name.NameManager():
            v = pkg.sym.var("w", attr={"__lr_mult__": "0.5"})
            s = pkg.sym.clip(v, a_min=-1, a_max=2.5, name="c")
        assert v.attr("__lr_mult__") == "0.5"
        assert s.attr("a_max") == "2.5" and s.attr("nope") is None


def test_copy_keeps_the_outputs_and_a_string_operand_raises():
    import copy
    a = mxt.sym.var("a")
    neg = -a
    assert copy.copy(neg).tojson() == neg.tojson()
    with pytest.raises(TypeError):
        a + "x"
