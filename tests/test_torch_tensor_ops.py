"""The tensor surface: every op name of the port's ``ops/tensor.py`` that
the JAX package registers, and ``softmax``, ``log_softmax``,
``SliceChannel`` / ``split`` and ``MakeLoss``, against the JAX package's
registry on the same numpy-seeded inputs (CPU).

* Forward, op by op through both registries: the inputs and attributes
  of the JAX package's sweep table (``tests/test_op_sweep.py``'s
  ``CASES``, domain-safe), an alias through its canonical op's cases.
  Exact for ops that only move, select, order or compare values; within
  2e-5 for arithmetic.
* Gradients: one graph a family, built with the JAX package's
  ``mx.sym``, carried to the port through ``tojson()`` / ``load_json``;
  both Executors run ``backward`` with the same random head gradients.
  Every array's gradient within 1e-5 of its largest magnitude.
* The traps where PyTorch's nearest call differs from the JAX function:
  ties in ``sort`` / ``argsort`` / ``topk``, integer arrays with float
  scalars, indices out of range, ``clip`` at its bounds, ``abs`` and
  ``norm`` at 0, ``max`` / ``min`` over ties, ``mod``'s sign, a 1-D
  ``where`` condition; and the pinned faults (``round`` half to even,
  ``gamma`` as |Γ|, integer powers with negative exponents).
* The registry's coverage: the JAX package's op names less the port's
  are exactly the 3 left for later slices.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mxj
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.registry import get_op as torch_op

from test_op_sweep import CASES, Case, U, int_valued, well_separated

TOL = 2e-5
GRAD_RTOL = 1e-5

UNARY = ["abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
         "arctanh", "ceil", "cos", "cosh", "degrees", "exp", "expm1", "fix",
         "floor", "gamma", "gammaln", "log", "log10", "log1p", "log2",
         "negative", "radians", "rint", "round", "rsqrt", "sigmoid", "sign",
         "sin", "sinh", "sqrt", "square", "tan", "tanh", "_copy",
         "identity"]
UNARY_MORE = ["BlockGrad", "stop_gradient", "make_loss", "smooth_l1", "Cast",
              "cast"]
BINARY = ["add", "sub", "mul", "div", "power", "hypot", "maximum", "minimum",
          "equal", "not_equal", "greater", "greater_equal", "lesser",
          "lesser_equal", "mod"]
BINARY_OPS = (
    [f"elemwise_{b}" for b in ("sub", "mul", "div")] +
    [f"_{b}" for b in BINARY[4:]] +
    [f"broadcast_{b}" for b in BINARY[1:]] +
    [f"_{b}_scalar" for b in BINARY] +
    ["_rsub_scalar", "_rdiv_scalar", "_rpower_scalar", "_rmod_scalar",
     "_minus", "_mul", "_div", "_grad_add", "_plus_scalar", "_minus_scalar",
     "_rminus_scalar"])
SUMS = ["add_n", "ElementWiseSum", "_sum", "broadcast_axis", "broadcast_to"]
REDUCTIONS = ["mean", "prod", "nansum", "nanprod", "max", "min", "max_axis",
              "min_axis", "argmax", "argmin", "argmax_channel", "norm",
              "softmax_cross_entropy"]
INIT = ["_zeros", "_ones", "_full", "zeros_like", "ones_like",
        "_identity_with_attr_like_rhs"]
MATRIX = ["batch_dot", "slice", "crop", "_slice_assign",
          "_crop_assign_scalar", "clip", "repeat", "tile", "reverse", "flip",
          "SwapAxis", "swapaxes", "Pad", "pad"]
INDEXING = ["take", "batch_take", "one_hot", "pick", "where"]
ORDERING = ["sort", "argsort", "topk"]
#: the 142 names of the JAX package's ``ops/tensor.py`` this slice ports
TENSOR_OPS = (UNARY + UNARY_MORE + BINARY_OPS + SUMS + REDUCTIONS + INIT +
              MATRIX + INDEXING + ORDERING)
#: and the five from ``ops/nn.py`` and ``ops/loss.py``
SLICE_OPS = TENSOR_OPS + ["softmax", "log_softmax", "SliceChannel", "split",
                          "MakeLoss"]

#: the remaining nn layers and losses (``tests/test_torch_nn_layers.py``
#: holds them to the JAX package)
LAYER_OPS = ["BilinearSampler", "Correlation", "Crop", "Deconvolution",
             "GridGenerator", "InstanceNorm", "L2Normalization", "LeakyReLU",
             "ROIPooling", "SequenceLast", "SequenceMask", "SequenceReverse",
             "SoftmaxActivation", "SpatialTransformer", "UpSampling",
             "SVMOutput", "IdentityAttachKLSparseReg",
             "LinearRegressionOutput", "LogisticRegressionOutput",
             "MAERegressionOutput"]

#: the contrib ops (``tests/test_torch_contrib.py`` holds them to the JAX
#: package), every name
CONTRIB_OPS = ["CTCLoss", "ctc_loss", "MultiBoxDetection", "MultiBoxPrior",
               "MultiBoxTarget", "MultiProposal", "Proposal",
               "count_sketch", "dequantize", "fft", "ifft", "quantize",
               "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
               "_contrib_MultiBoxTarget", "_contrib_MultiProposal",
               "_contrib_Proposal", "_contrib_count_sketch",
               "_contrib_ctc_loss", "_contrib_dequantize", "_contrib_fft",
               "_contrib_ifft", "_contrib_quantize"]

#: the JAX package's op names the port leaves to later slices (ROADMAP.md
#: A5-A6): RNN, RMSProp's updates
LATER = {
    "rnn": ["RNN"],
    "optimizer": ["rmsprop_update", "rmspropalex_update"],
}

#: ops that only move, select, order or compare values: held exactly
EXACT = set(
    ["_copy", "identity", "BlockGrad", "stop_gradient", "make_loss", "Cast",
     "cast", "negative", "abs", "sign", "ceil", "floor", "fix", "rint",
     "round"] +
    [n for n in BINARY_OPS if any(c in n for c in (
        "equal", "greater", "lesser", "maximum", "minimum"))] +
    ["broadcast_axis", "broadcast_to", "max", "min", "max_axis", "min_axis",
     "argmax", "argmin", "argmax_channel"] + INIT +
    [n for n in MATRIX if n != "batch_dot"] + INDEXING + ORDERING +
    ["SliceChannel", "split", "MakeLoss"])

#: an alias (or a name the sweep table has no case for) -> the sweep's
#: name whose cases it takes
SWEEP_NAME = {"_copy": "identity", "cast": "Cast", "_minus": "elemwise_sub",
              "_mul": "elemwise_mul", "_div": "elemwise_div",
              "_grad_add": "elemwise_add", "_add_scalar": "_plus_scalar",
              "_sub_scalar": "_minus_scalar", "_rsub_scalar":
              "_rminus_scalar", "max_axis": "max", "min_axis": "min",
              "crop": "slice", "reverse": "flip", "swapaxes": "SwapAxis",
              "pad": "Pad", "split": "SliceChannel"}

SQ = {"data": (3, 4)}
#: cases of names the sweep table has none for, or builds its own graph
OWN = {
    "add_n": [Case({"arg0": (2, 3), "arg1": (2, 3), "arg2": (2, 3)},
                   attrs={"num_args": 3})],
    "SliceChannel": [Case({"data": (2, 6)}, attrs={"num_outputs": 2,
                                                   "axis": 1}),
                     Case({"data": (3, 2, 4)}, attrs={
                         "num_outputs": 3, "axis": 0, "squeeze_axis": True})],
    "_zeros": [Case({}, attrs={"shape": (2, 3)})],
    "_ones": [Case({}, attrs={"shape": (2, 3), "dtype": "int32"})],
    "_full": [Case({}, attrs={"shape": (2, 3), "value": 2.5})],
    "_identity_with_attr_like_rhs": [Case({"lhs": (2, 3), "rhs": (2, 3)})],
    "_slice_assign": [Case({"lhs": (4, 5), "rhs": (2, 4)},
                           attrs={"begin": (1, 0), "end": (3, 4)})],
    "_crop_assign_scalar": [Case({"data": (4, 5)}, attrs={
        "begin": (1, 1), "end": (3, 4), "scalar": 1.5})],
    "max": [Case({"data": (2, 3, 4)}, attrs={"axis": 1},
                 gen={"data": well_separated()}),
            Case({"data": (2, 3, 4)}, attrs={"axis": (0, 2), "keepdims": True,
                                            "exclude": True},
                 gen={"data": well_separated()})],
    "mean": [Case({"data": (2, 3, 4)}, attrs={"axis": 2}),
             Case({"data": (2, 3, 4)})],
    "prod": [Case({"data": (2, 3, 4)}, attrs={"axis": (0, 2)},
                  gen={"data": U(0.5, 1.5)})],
    "argmax": [Case({"data": (2, 3, 4)}, attrs={"axis": 1, "keepdims": True},
                    gen={"data": well_separated()}),
               Case({"data": (2, 3, 4)}, gen={"data": well_separated()})],
    "norm": [Case(SQ), Case({"data": (2, 3, 4)}, attrs={
        "axis": 1, "keepdims": True})],
    "topk": [Case({"data": (3, 5)}, attrs={"axis": 1, "k": 2, "ret_typ": r,
                                          "is_ascend": asc},
                  gen={"data": well_separated()})
             for r in ("indices", "value", "both", "mask")
             for asc in (False, True)],
    "sort": [Case(SQ, attrs={"axis": 1, "is_ascend": asc},
                  gen={"data": well_separated()}) for asc in (True, False)],
    "softmax": [Case(SQ, attrs={"axis": 1}),
                Case({"data": (2, 3, 4)}, attrs={"axis": 1,
                                                 "temperature": 2.0})],
}


def _cases(name):
    if name in OWN:
        return OWN[name]
    if name in ("ElementWiseSum", "_sum"):
        return OWN["add_n"]
    return CASES[SWEEP_NAME.get(name, name)]


def _inputs(name, case, seed):
    """The case's arrays in the op's input order, numpy-seeded."""
    rs = np.random.RandomState(seed)
    attrs = torch_op(name).normalize_attrs(case.attrs)
    names = torch_op(name).input_names(attrs)
    return [case.gen.get(n, U(-1.0, 1.0))(case.shapes[n], rs)
            for n in names]


def _forward_both(name, attrs, inputs):
    jop, top = jax_op(name), torch_op(name)
    j_out, _ = jop.forward(jop.normalize_attrs(attrs),
                           [jnp.asarray(x) for x in inputs], [], False, None)
    t_out, _ = top.forward(top.normalize_attrs(attrs),
                           [torch.tensor(x) for x in inputs], [], False, None)
    return ([np.asarray(o) for o in j_out],
            [o.detach().numpy() for o in t_out])


def _same(name, want, got, exact):
    assert len(want) == len(got), name
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (name, a.shape, b.shape, a.dtype, b.dtype)
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=name)


def _param_cases():
    for name in SLICE_OPS:
        for i, case in enumerate(_cases(name)):
            yield pytest.param(name, i, id=f"{name}-{i}")


@pytest.mark.parametrize("name,i", list(_param_cases()))
def test_forward_matches_jax(name, i):
    case = _cases(name)[i]
    inputs = _inputs(name, case, 1000 + i)
    want, got = _forward_both(name, case.attrs, inputs)
    _same(name, want, got, name in EXACT)


def test_registry_difference_is_the_later_slices():
    """Counted in a fresh interpreter: tests register user ops (``mx.rtc``,
    ``mx.operator``) into this process's registries."""
    code = ("import json, mxnet_tpu, mxnet_tpu_torch\n"
            "from mxnet_tpu.ops.registry import OP_REGISTRY as J\n"
            "from mxnet_tpu_torch.ops.registry import OP_REGISTRY as T\n"
            "print(json.dumps([sorted(J), sorted(T)]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    jax_ops, torch_ops = (set(x) for x in json.loads(out.splitlines()[-1]))
    later = {n for names in LATER.values() for n in names}
    assert len(later) == 3 and len(SLICE_OPS) == 147 == len(set(SLICE_OPS))
    assert len(LAYER_OPS) == 20 == len(set(LAYER_OPS) - set(SLICE_OPS))
    assert len(CONTRIB_OPS) == 23 == len(
        set(CONTRIB_OPS) - set(SLICE_OPS + LAYER_OPS))
    missing = jax_ops - torch_ops
    assert missing == later, (sorted(missing - later), sorted(later - missing))
    assert torch_ops <= jax_ops and \
        set(SLICE_OPS + LAYER_OPS + CONTRIB_OPS) <= torch_ops
    assert len(torch_ops) == 250 and len(jax_ops) == 253


def test_every_slice_op_keeps_the_jax_attrs():
    """The same attribute names and defaults (what ``tojson`` writes), the
    same loss flag, and for the nn layers and losses and the contrib ops
    also the same need for a key and the same outputs (their number,
    visible number and names) under their attribute defaults; an alias of
    a contrib op names the same op in both packages, and ``MultiProposal``
    with ``output_score`` has two outputs in both."""
    for name in SLICE_OPS + LAYER_OPS + CONTRIB_OPS:
        j, t = jax_op(name).attr_spec, torch_op(name).attr_spec
        assert sorted(j) == sorted(t), name
        assert {k: v[1] for k, v in j.items()} == \
            {k: v[1] for k, v in t.items()}, name
        assert jax_op(name).is_loss == torch_op(name).is_loss, name
    for name in CONTRIB_OPS:
        assert jax_op(name).name == torch_op(name).name, name
    for attrs in ({"output_score": True}, {"use_data_lengths": True,
                                           "use_label_lengths": True}):
        for name in ("MultiProposal", "CTCLoss"):
            jo, to = jax_op(name), torch_op(name)
            ja, ta = jo.normalize_attrs(attrs), to.normalize_attrs(attrs)
            assert (jo.num_outputs(ja), jo.input_names(ja)) == \
                (to.num_outputs(ta), to.input_names(ta)), (name, attrs)
    for name in LAYER_OPS + CONTRIB_OPS:
        jo, to = jax_op(name), torch_op(name)
        assert jo.need_rng == to.need_rng, name
        ja, ta = jo.normalize_attrs({}), to.normalize_attrs({})
        assert (jo.num_outputs(ja), jo.num_visible_outputs(ja),
                jo.output_names(ja), jo.aux_names(ja)) == \
            (to.num_outputs(ta), to.num_visible_outputs(ta),
             to.output_names(ta), to.aux_names(ta)), name


# --------------------------------------------------------------------------
# gradients: a graph a family through both Executors
# --------------------------------------------------------------------------
NO_GRAD_INPUTS = {"indices", "index", "condition", "label"}
#: the differentiable ops of the slice, by family (one graph each)
GRAD_FAMILIES = {
    "unary": [n for n in UNARY if n not in (
        "ceil", "floor", "fix", "rint", "round", "sign")] + [
        "BlockGrad", "make_loss", "smooth_l1", "Cast"],
    "binary": ["elemwise_sub", "elemwise_mul", "elemwise_div", "_power",
               "_hypot", "_maximum", "_minimum", "_mod", "_minus", "_mul",
               "_div", "_grad_add", "add_n"] +
              [f"broadcast_{b}" for b in BINARY[1:9] + ["mod"]],
    "scalar": [f"_{b}_scalar" for b in BINARY[:9] + ["mod"]] + [
        "_rsub_scalar", "_rdiv_scalar", "_rpower_scalar", "_rmod_scalar",
        "_plus_scalar", "_minus_scalar", "_rminus_scalar"],
    "reduce": ["mean", "prod", "nansum", "nanprod", "max", "min", "norm",
               "softmax_cross_entropy", "broadcast_axis", "broadcast_to",
               "softmax", "log_softmax", "MakeLoss"],
    "move": ["batch_dot", "slice", "crop", "_slice_assign",
             "_crop_assign_scalar", "clip", "repeat", "tile", "reverse",
             "SwapAxis", "Pad", "take", "batch_take", "pick", "where",
             "sort", "topk", "SliceChannel", "split"],
}
#: the gradient graph's case of an op where its first case is not
#: differentiable or takes no gradient in the sweep
GRAD_CASE = {"sort": Case(SQ, attrs={"axis": 1, "is_ascend": False},
                          gen={"data": well_separated()}),
             "topk": Case({"data": (3, 5)}, attrs={
                 "axis": 1, "k": 2, "ret_typ": "value"},
                 gen={"data": well_separated()}),
             "_mod": Case({"lhs": (2, 3), "rhs": (2, 3)},
                          gen={"lhs": U(0.55, 0.95), "rhs": U(1.1, 2.0)}),
             "MakeLoss": Case(SQ, attrs={"grad_scale": 0.5,
                                         "normalization": "batch"})}


def _family_graph(family):
    """The family's graph in the JAX package's ``mx.sym`` (each op on
    variables of its own), the arrays, and the names not differentiated."""
    outs, arrays, frozen = [], {}, []
    for k, name in enumerate(GRAD_FAMILIES[family]):
        case = GRAD_CASE.get(name) or _cases(name)[0]
        attrs = dict(case.attrs)
        names = torch_op(name).input_names(
            torch_op(name).normalize_attrs(attrs))
        values = _inputs(name, case, 2000 + k)
        syms = {}
        for inp, val in zip(names, values):
            var = f"g{k}_{inp}"
            syms[inp] = mxj.sym.var(var)
            arrays[var] = val
            if inp in NO_GRAD_INPUTS:
                frozen.append(var)
        op = getattr(mxj.sym, name)
        if name in ("add_n", "ElementWiseSum", "_sum"):
            node = op(*[syms[n] for n in names], name=f"g{k}", **attrs)
        else:
            node = op(name=f"g{k}", **syms, **attrs)
        outs.extend(node[i] for i in range(len(node)))
    return mxj.sym.Group(outs), arrays, frozen


@pytest.mark.parametrize("family", sorted(GRAD_FAMILIES))
def test_gradients_match_jax_through_tojson(family):
    with mxj.name.NameManager():
        jsym, arrays, frozen = _family_graph(family)
    tsym = mxt.symbol.load_json(jsym.tojson())
    assert tsym.tojson() == jsym.tojson()
    shapes = {k: v.shape for k, v in arrays.items()}
    req = {k: "null" if k in frozen else "write" for k in arrays}
    jex = jsym.simple_bind(ctx=mxj.cpu(), grad_req=req, **shapes)
    tex = tsym.simple_bind(ctx=mxt.cpu(), grad_req=req, **shapes)
    j_outs = jex.forward(is_train=True, **{
        k: mxj.nd.array(v) for k, v in arrays.items()})
    t_outs = tex.forward(is_train=True, **{
        k: mxt.nd.array(v, ctx=mxt.cpu()) for k, v in arrays.items()})
    rs = np.random.RandomState(7)
    heads = [np.asarray(rs.randn(*o.shape), np.float32) for o in j_outs]
    jex.backward([mxj.nd.array(h) for h in heads])
    tex.backward([mxt.nd.array(h, ctx=mxt.cpu()) for h in heads])
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=TOL,
                                   atol=TOL)
    checked = 0
    for k in arrays:
        if k in frozen:
            continue
        want = jex.grad_dict[k].asnumpy()
        got = tex.grad_dict[k].asnumpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, \
            (k, np.abs(got - want).max(), scale)
        checked += 1
    assert checked >= len(GRAD_FAMILIES[family])


# --------------------------------------------------------------------------
# the traps
# --------------------------------------------------------------------------
TIES = np.array([[3., 1., 3., 2., 1., 3.],
                 [0., 0., 0., 0., 0., 0.],
                 [2., -1., 2., -1., 5., 2.]], np.float32)


@pytest.mark.parametrize("name,attrs", [
    ("sort", {"is_ascend": True}), ("sort", {"is_ascend": False}),
    ("argsort", {"is_ascend": True}), ("argsort", {"is_ascend": False}),
    ("argsort", {"axis": 0, "is_ascend": False}),
    ("argsort", {"axis": None})] + [
    ("topk", {"k": k, "ret_typ": r, "is_ascend": a})
    for k in (1, 4) for r in ("indices", "value", "both", "mask")
    for a in (False, True)] + [("topk", {"axis": 0, "k": 2, "ret_typ": "both"}),
                               ("topk", {"axis": None, "k": 5})])
def test_ordering_with_ties_matches_jax(name, attrs):
    want, got = _forward_both(name, attrs, [TIES])
    _same(name, want, got, exact=True)


def test_descending_argsort_flips_the_stable_order():
    """is_ascend=False reverses tied indices (last first), which a
    stable descending sort would not."""
    _, got = _forward_both("argsort", {"is_ascend": False}, [TIES[1:2]])
    assert got[0].tolist() == [[5, 4, 3, 2, 1, 0]]
    _, got = _forward_both("topk", {"k": 3}, [TIES[1:2]])
    assert got[0].tolist() == [[0, 1, 2]]


INT = np.array([[3, -3, 7], [0, 5, -8]], np.int32)


@pytest.mark.parametrize("name,scalar", [
    (n, s) for n in ("_mul_scalar", "_add_scalar", "_sub_scalar",
                     "_rsub_scalar", "_div_scalar", "_rdiv_scalar",
                     "_mod_scalar", "_rmod_scalar", "_maximum_scalar",
                     "_minimum_scalar", "_equal_scalar", "_greater_scalar",
                     "_lesser_equal_scalar", "_hypot_scalar")
    for s in (2.5, -2.5)] + [("_power_scalar", 2.5), ("_rpower_scalar", 2.5)])
def test_scalar_op_on_int_casts_the_scalar_to_the_dtype(name, scalar):
    x = np.where(INT == 0, 1, INT).astype(np.int32) if "div" in name or \
        "mod" in name else INT
    want, got = _forward_both(name, {"scalar": scalar}, [x])
    _same(name, want, got, exact=True)


def test_int_times_float_scalar_stays_int():
    _, got = _forward_both("_mul_scalar", {"scalar": 2.5}, [INT])
    assert got[0].dtype == np.int32 and got[0].tolist() == [[6, -6, 14],
                                                           [0, 10, -16]]


def test_integer_power_with_negative_exponent_truncates():
    """The pinned divergence (ROADMAP.md §C): MXNet's integer power
    truncates; the JAX package overflows (arrays) or raises (a scalar)."""
    base = np.array([5, 2, 1, -1], np.int32)
    exp = np.array([-2, -2, -2, -3], np.int32)
    for name in ("_power", "broadcast_power"):
        want, got = _forward_both(name, {}, [base, exp])
        assert got[0].tolist() == [0, 0, 1, -1]
        assert want[0].tolist() == [-558738647, 0, 1, -1]
    top = torch_op("_power_scalar")
    got = top.forward(top.normalize_attrs({"scalar": -2}),
                      [torch.tensor(base)], [], False, None)[0]
    assert got[0].tolist() == [0, 0, 1, 1]
    with pytest.raises(TypeError):
        _forward_both("_power_scalar", {"scalar": -2}, [base])
    _, got = _forward_both("_rpower_scalar", {"scalar": 2}, [-base])
    assert got[0].tolist() == [0, 0, 0, 2]
    got = mxt.nd.power(mxt.nd.array(base, ctx=mxt.cpu()),
                       mxt.nd.array(exp, ctx=mxt.cpu())).asnumpy()
    assert got.tolist() == [0, 0, 1, -1]


def test_mod_takes_the_divisor_sign():
    a = np.array([-3.5, 3.5, -3.5, 3.5, 4.0], np.float32)
    b = np.array([2.0, -2.0, -2.0, 2.0, -2.0], np.float32)
    for name in ("_mod", "broadcast_mod"):
        want, got = _forward_both(name, {}, [a, b])
        _same(name, want, got, exact=False)
        assert got[0].tolist() == [0.5, -0.5, -1.5, 1.5, -0.0]
    want, got = _forward_both("_rmod_scalar", {"scalar": -3.5}, [b])
    _same("_rmod_scalar", want, got, exact=False)
    want, got = _forward_both("_mod", {}, [INT, np.full_like(INT, -3)])
    _same("_mod", want, got, exact=True)


def test_round_is_half_to_even_and_gamma_is_abs_gamma():
    """Faults of the reference the port copies (ROADMAP.md §C): jnp.round
    rounds half to even (MXNet: away from zero); gamma is exp(gammaln),
    |Γ(x)| for a negative non-integer x."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    for name in ("round", "rint"):
        want, got = _forward_both(name, {}, [x])
        _same(name, want, got, exact=True)
        assert got[0].tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0]
    g = np.array([-0.5, -1.5, 0.5, 3.0], np.float32)
    want, got = _forward_both("gamma", {}, [g])
    _same("gamma", want, got, exact=False)
    np.testing.assert_allclose(got[0], [3.5449077, 2.3632718, 1.7724539, 2.0],
                               rtol=1e-6)


def _grads(name, attrs, inputs, head=None):
    """d(sum(head * op(inputs))) / d(inputs) through JAX and through the
    port's plain op."""
    jop, top = jax_op(name), torch_op(name)
    ja, ta = jop.normalize_attrs(attrs), top.normalize_attrs(attrs)

    def jf(*xs):
        out = jop.forward(ja, list(xs), [], False, None)[0][0]
        return jnp.sum(out * (1.0 if head is None else head))
    want = jax.grad(jf, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = top.forward(ta, ts, [], False, None)[0][0]
    (out * (1.0 if head is None else torch.tensor(head))).sum().backward()
    return [np.asarray(w) for w in want], [
        np.zeros_like(x) if t.grad is None else t.grad.numpy()
        for x, t in zip(inputs, ts)]


@pytest.mark.parametrize("name,attrs,inputs", [
    ("abs", {}, [np.array([0.0, -0.0, 1.5, -1.5], np.float32)]),
    ("clip", {"a_min": -0.5, "a_max": 0.5},
     [np.array([-0.5, 0.5, 0.0, 1.0, -1.0], np.float32)]),
    ("clip", {"a_min": 0.0, "a_max": 0.0},
     [np.array([0.0, 1.0, -1.0], np.float32)]),
    ("norm", {}, [np.zeros((2, 3), np.float32)]),
    ("norm", {"axis": 1}, [np.array([[0, 0, 0], [3, 4, 0]], np.float32)]),
    ("max", {}, [np.array([1.0, 3.0, 3.0, 0.0], np.float32)]),
    ("min", {"axis": 1}, [np.array([[1, -2, -2], [4, 4, 4]], np.float32)]),
    ("max_axis", {"axis": 0, "keepdims": True},
     [np.array([[1, 2], [1, 0]], np.float32)]),
    ("_maximum", {}, [np.array([1.0, 2.0], np.float32),
                      np.array([1.0, 1.0], np.float32)]),
    ("_minimum_scalar", {"scalar": 1.0}, [np.array([1.0, 2.0, 0.0],
                                                   np.float32)]),
    ("_hypot", {}, [np.array([0.0, 3.0], np.float32),
                    np.array([0.0, -4.0], np.float32)]),
    ("smooth_l1", {"scalar": 1.0}, [np.array([1.0, -1.0, 0.0, 0.5],
                                             np.float32)]),
    ("relu", {}, [np.array([0.0, -1.0, 2.0], np.float32)]),
    ("sign", {}, [np.array([np.nan, -2.0, 0.0], np.float32)]),
], ids=["abs0", "clip_bounds", "clip_point", "norm0", "norm0_row",
        "max_ties", "min_ties", "max_axis_ties", "maximum_tie",
        "minimum_scalar_tie", "hypot0", "smooth_l1_kink", "relu0",
        "sign_nan"])
def test_kinks_match_jax(name, attrs, inputs):
    want, got = _forward_both(name, attrs, inputs)
    _same(name, want, got, exact=False)
    if name == "sign":
        return
    gw, gg = _grads(name, attrs, inputs)
    for a, b in zip(gw, gg):
        np.testing.assert_array_equal(b, a)


def test_norm_gradient_at_zero_is_nan_not_zero():
    _, gg = _grads("norm", {}, [np.zeros((2, 3), np.float32)])
    assert np.isnan(gg[0]).all()
    _, gg = _grads("abs", {}, [np.zeros(2, np.float32)])
    assert gg[0].tolist() == [1.0, 1.0]


A = np.arange(12, dtype=np.float32).reshape(3, 4)


@pytest.mark.parametrize("name,attrs,inputs", [
    ("take", {}, [A, np.array([-1.0, 7.0, 2.7, -0.5], np.float32)]),
    ("take", {"mode": "clip", "axis": 1},
     [A, np.array([[-3, 5], [1, 2]], np.float32)]),
    ("take", {"mode": "wrap"}, [A, np.array([-1.0, 7.0, 2.7, -4.0],
                                            np.float32)]),
    ("take", {"mode": "raise", "axis": -1},
     [A, np.array([-1.0, 9.0], np.float32)]),
    ("pick", {}, [A, np.array([-1, 4, -5], np.float32)]),
    ("pick", {"axis": 0, "keepdims": True},
     [A, np.array([0, -3, 2, 3], np.float32)]),
    ("batch_take", {}, [A, np.array([-1, 5, 2], np.float32)]),
    ("one_hot", {"depth": 4}, [np.array([-1.0, 3.0, 5.0, 2.9], np.float32)]),
    ("one_hot", {"depth": 3, "on_value": 2.0, "off_value": -1.0,
                 "dtype": "int32"}, [np.array([[0, 4], [2, -2]], np.float32)]),
    ("softmax_cross_entropy", {}, [A, np.array([1, 3, 0], np.float32)]),
    ("softmax_cross_entropy", {}, [A, np.array([1, 4, -1], np.float32)]),
    ("where", {}, [np.array([1, 0, 2], np.float32), A[:, :2],
                   -A[:, :2]]),
    ("where", {}, [np.array([[1, 0], [0, 1], [1, 1]], np.float32), A[:, :2],
                   -A[:, :2]]),
], ids=["take_clip", "take_clip_axis1", "take_wrap", "take_other_mode",
        "pick_oob", "pick_axis0", "batch_take_oob", "one_hot_oob",
        "one_hot_values", "xent", "xent_oob", "where_1d", "where_nd"])
def test_indexing_out_of_range_matches_jax(name, attrs, inputs):
    want, got = _forward_both(name, attrs, inputs)
    _same(name, want, got, exact=True)


def test_indexing_gradients_skip_filled_positions():
    gw, gg = _grads("pick", {}, [A, np.array([-1, 4, 1], np.float32)])
    np.testing.assert_array_equal(gg[0], gw[0])
    assert gg[0].sum() == 2.0
    gw, gg = _grads("take", {"mode": "wrap"},
                    [A, np.array([2, -1, 5, 2], np.float32)])
    np.testing.assert_array_equal(gg[0], gw[0])


def test_pad_reflect_and_edge_past_the_axis_match_jax():
    x = np.random.RandomState(3).randn(1, 2, 3, 2).astype(np.float32)
    for mode in ("edge", "reflect", "constant"):
        attrs = {"mode": mode, "pad_width": (0, 0, 1, 0, 4, 3, 2, 5),
                 "constant_value": 0.25}
        want, got = _forward_both("Pad", attrs, [x])
        _same("Pad", want, got, exact=True)
        gw, gg = _grads("Pad", attrs, [x], head=np.random.RandomState(
            4).randn(*want[0].shape).astype(np.float32))
        np.testing.assert_allclose(gg[0], gw[0], rtol=1e-6, atol=1e-6)


def test_clip_on_int_gives_float32_as_jax():
    want, got = _forward_both("clip", {"a_min": -0.8, "a_max": 2.5}, [INT])
    _same("clip", want, got, exact=True)
    assert got[0].dtype == np.float32


def test_reductions_on_int_keep_the_jax_dtypes():
    for name, attrs in (("mean", {}), ("prod", {"axis": 1}),
                        ("max", {"axis": 0}), ("nansum", {}),
                        ("nanprod", {"axis": 1}), ("argmax", {"axis": 1}),
                        ("norm", {"axis": 1})):
        want, got = _forward_both(name, attrs, [INT])
        _same(name, want, got, exact=name != "norm")


def test_sum_exclude_without_axis_sums_everything():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    want, got = _forward_both("sum", {"exclude": True}, [x])
    _same("sum", want, got, exact=True)
    assert got[0] == 15.0


def test_init_ops_land_on_the_context_device():
    with mxt.cpu():
        z = mxt.nd._zeros(shape=(2, 3))
        f = mxt.nd._full(shape=(2,), value=1.5, dtype="float16")
    assert z.astorch().device.type == "cpu" and z.shape == (2, 3)
    assert f.asnumpy().dtype == np.float16 and f.asnumpy().tolist() == \
        [1.5, 1.5]
    # the plain forward of an op with no input runs under the device
    # dispatch is given: its tensor is made there
    out, _ = mxt.ops.registry.dispatch(
        torch_op("_ones"), torch_op("_ones").normalize_attrs(
            {"shape": (4,)}), [], [], False, None, torch.device("meta"))
    assert out[0].device.type == "meta"
