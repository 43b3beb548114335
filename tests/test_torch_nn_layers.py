"""The remaining nn layers and losses (``LeakyReLU``, ``Deconvolution``,
``UpSampling``, ``InstanceNorm``, ``L2Normalization``,
``SoftmaxActivation``, ``Crop``, the three sequence ops, ``ROIPooling``,
``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``,
``Correlation``; the three regression outputs, ``SVMOutput``,
``IdentityAttachKLSparseReg``), the regression metrics, ``CustomMetric``
and the initializers' name rules, against the JAX package on the CPU.

* Each case is a graph built with the JAX package's ``mx.sym``, carried to
  the port through ``tojson()`` / ``load_json`` (the JSON byte for byte);
  the parameters cross as the bytes of a ``.params`` file the JAX package
  saves and the port loads; both Executors run a training forward and a
  backward from the same numpy-seeded inputs and random head gradients.
  Outputs within 2e-5 (rtol and atol), every argument's gradient within
  1e-5 of its largest magnitude; ``rrelu``'s training slopes bit for bit.
* Every ``Case`` the JAX sweep (``tests/test_op_sweep.py``) defines for
  these names, and the cases below that the sweep has not: every
  ``act_type``, grouped / 1-D / biased deconvolutions, ``adj`` at or past
  the stride and padding past ``k - 1`` (PyTorch refuses both),
  multi-input and bilinear upsampling, ``Crop``'s ``crop_like``,
  ``center_crop`` and clamped offsets, sequence lengths, ROIs over zeros
  (the ties after a ReLU), past the image and with empty bins.
* The reference's faults the port copies are pinned: ``Correlation``'s
  wrap-around, unread ``kernel_size`` / ``stride1`` / ``is_multiply`` and
  channel mean, ``Deconvolution``'s unread ``target_shape`` / ``dilate``,
  ``IdentityAttachKLSparseReg``'s unread ``momentum``, and the one place
  ``ROIPooling``'s separable max splits a tie otherwise than the joint max.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as mxj

import mxnet_tpu_torch as mxt

from test_op_sweep import (CASES, Case, U, _build, signed_away_from_zero,
                           well_separated)

TOL = 2e-5
GRAD_RTOL = 1e-5

LAYERS = ["LeakyReLU", "Deconvolution", "UpSampling", "InstanceNorm",
          "L2Normalization", "SoftmaxActivation", "Crop", "SequenceLast",
          "SequenceMask", "SequenceReverse", "ROIPooling", "BilinearSampler",
          "GridGenerator", "SpatialTransformer", "Correlation"]
LOSSES = ["LinearRegressionOutput", "LogisticRegressionOutput",
          "MAERegressionOutput", "SVMOutput", "IdentityAttachKLSparseReg"]


def _sym(fn):
    """A builder over ``mx.sym`` of the JAX package: fn(vars, sym)."""
    return lambda v, a: fn(v, mxj.sym)


def _consts(*rows):
    arr = np.array(rows, np.float32)
    return lambda shape, rs: arr.reshape(shape)


def relu_like(shape, rs):
    """Half the values exact zeros: the ties a ReLU leaves."""
    return np.maximum(rs.uniform(-1.0, 1.0, shape), 0.0).astype(np.float32)


#: the cases the JAX sweep has not, by op
MORE = {
    "LeakyReLU": [
        Case({"data": (2, 3, 4), "gamma": (3,)}, attrs={"act_type": "prelu"},
             gen={"data": signed_away_from_zero()}),
        Case({"data": (3, 5)}, attrs={"act_type": "gelu"}),
        Case({"data": (3, 5)}, attrs={"act_type": "leaky"},
             gen={"data": _consts(*[[-1, 0, 1, 0, -2]] * 3)}),
    ],
    "Deconvolution": [
        Case({"data": (2, 3, 4, 4)}, attrs={
            "kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
            "num_filter": 2, "no_bias": False}),
        Case({"data": (1, 4, 3, 3)}, attrs={
            "kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
            "num_group": 2, "no_bias": True}),
        Case({"data": (2, 3, 5)}, attrs={
            "kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,),
            "num_filter": 4, "no_bias": False}),
        # adj at the stride and past it: PyTorch's output_padding refuses
        Case({"data": (1, 2, 3, 4)}, attrs={
            "kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
            "adj": (2, 3), "num_filter": 3}),
        Case({"data": (1, 2, 3, 3)}, attrs={
            "kernel": (2, 3), "stride": (1, 2), "pad": (0, 1),
            "adj": (1, 1), "num_filter": 2}),
        # padding past k - 1: the output is cropped
        Case({"data": (1, 2, 4, 4)}, attrs={
            "kernel": (2, 2), "stride": (3, 3), "pad": (2, 2),
            "num_filter": 2}),
    ],
    "UpSampling": [
        Case({"a": (1, 2, 2, 2), "b": (1, 3, 4, 4)}, builder=_sym(
            lambda v, s: s.UpSampling(v["a"], v["b"], scale=2, num_args=2,
                                      sample_type="nearest"))),
        Case({"a": (1, 2, 2, 2), "b": (1, 2, 1, 1)}, builder=_sym(
            lambda v, s: s.UpSampling(v["a"], v["b"], scale=2, num_args=2,
                                      sample_type="nearest",
                                      multi_input_mode="sum"))),
        Case({"data": (1, 2, 3, 3), "w": (2, 1, 4, 4)}, builder=_sym(
            lambda v, s: s.UpSampling(v["data"], v["w"], scale=2,
                                      num_filter=2, sample_type="bilinear"))),
        Case({"data": (2, 3, 2, 3), "w": (3, 1, 5, 5)}, builder=_sym(
            lambda v, s: s.UpSampling(v["data"], v["w"], scale=3,
                                      num_filter=3, sample_type="bilinear"))),
    ],
    "InstanceNorm": [Case({"data": (2, 3, 4, 5)}, attrs={"eps": 1e-5})],
    "L2Normalization": [Case({"data": (2, 3, 2, 2)}, attrs={
        "mode": "instance"})],
    "SoftmaxActivation": [Case({"data": (2, 3, 2, 2)})],
    "Crop": [
        Case({"data": (1, 2, 6, 7), "like": (1, 1, 3, 4)}, builder=_sym(
            lambda v, s: s.Crop(v["data"], v["like"], num_args=2,
                                offset=(1, 2)))),
        Case({"data": (1, 2, 6, 7)}, builder=_sym(
            lambda v, s: s.Crop(v["data"], num_args=1, h_w=(3, 3),
                                center_crop=True))),
        # lax.dynamic_slice clamps the start so the window fits
        Case({"data": (2, 2, 5, 5)}, builder=_sym(
            lambda v, s: s.Crop(v["data"], num_args=1, offset=(4, 3),
                                h_w=(3, 3)))),
        Case({"data": (1, 2, 5, 6), "like": (1, 2, 4, 2)}, builder=_sym(
            lambda v, s: s.Crop(v["data"], v["like"], num_args=2,
                                offset=(-1, 9)))),
    ],
    "SequenceLast": [
        Case({"data": (3, 2, 4), "length": (2,)}, builder=_sym(
            lambda v, s: s.SequenceLast(v["data"], v["length"],
                                        use_sequence_length=True)),
             gen={"length": _consts(2, 3)}),
        # a length of 0 reads the last step (take_along_axis wraps -1)
        Case({"data": (4, 3, 2), "length": (3,)}, builder=_sym(
            lambda v, s: s.SequenceLast(v["data"], v["length"],
                                        use_sequence_length=True)),
             gen={"length": _consts(0, 4, 1.7)}),
    ],
    "SequenceMask": [
        Case({"data": (4, 3, 2), "length": (3,)}, builder=_sym(
            lambda v, s: s.SequenceMask(v["data"], v["length"],
                                        use_sequence_length=True,
                                        value=-1.5)),
             gen={"length": _consts(1, 4, 0)}),
        Case({"data": (3, 2, 4)}, builder=_sym(
            lambda v, s: s.SequenceMask(v["data"]))),
    ],
    "SequenceReverse": [
        Case({"data": (4, 3, 2), "length": (3,)}, builder=_sym(
            lambda v, s: s.SequenceReverse(v["data"], v["length"],
                                           use_sequence_length=True)),
             gen={"length": _consts(2, 4, 1)}),
    ],
    "ROIPooling": [
        Case({"data": (2, 3, 8, 9), "rois": (5, 5)},
             attrs={"pooled_size": (3, 2), "spatial_scale": 0.5},
             gen={"data": relu_like, "rois": _consts(
                 [0, 0, 0, 15, 11], [1, 3, 2, 9, 14], [1, -4, -2, 30, 40],
                 [0, 6, 6, 6, 6], [1, 40, 2, 50, 8])}),
        Case({"data": (1, 2, 6, 6), "rois": (3, 5)},
             attrs={"pooled_size": (4, 4), "spatial_scale": 1.0},
             gen={"data": well_separated(), "rois": _consts(
                 [0, 0, 0, 2, 2], [0, 1, 0, 5, 3], [0, 2.5, 1.5, 3.5, 5])}),
    ],
    "BilinearSampler": [
        Case({"data": (2, 3, 5, 4), "grid": (2, 2, 3, 4)},
             gen={"grid": U(-1.3, 1.3)}),
    ],
    "GridGenerator": [
        Case({"data": (2, 6)}, attrs={"transform_type": "affine",
                                      "target_shape": (1, 5)}),
        Case({"data": (2, 6)}, attrs={"transform_type": "affine",
                                      "target_shape": (7, 3)}),
    ],
    "SpatialTransformer": [
        Case({"data": (2, 3, 6, 6), "loc": (2, 6)},
             attrs={"transform_type": "affine", "sampler_type": "bilinear",
                    "target_shape": (4, 5)},
             gen={"loc": U(-0.8, 0.8)}),
    ],
    "Correlation": [
        Case({"data1": (1, 3, 5, 6), "data2": (1, 3, 5, 6)},
             attrs={"max_displacement": 2, "stride2": 2, "pad_size": 2}),
        Case({"data1": (2, 2, 4, 5), "data2": (2, 2, 4, 5)},
             attrs={"max_displacement": 1, "pad_size": 0}),
    ],
    "LinearRegressionOutput": [
        Case({"data": (4,), "label": (4,)}, attrs={"grad_scale": 2.0}),
    ],
    "LogisticRegressionOutput": [
        Case({"data": (4, 1), "label": (4, 1)}, attrs={"grad_scale": 0.5},
             gen={"label": _consts(0, 1, 1, 0)}),
    ],
    "MAERegressionOutput": [
        Case({"data": (2, 3, 2), "label": (2, 3, 2)},
             gen={"label": U(-1.0, 1.0)}),
    ],
    "SVMOutput": [
        Case({"data": (5, 4), "label": (5,)}, attrs={
            "margin": 0.5, "regularization_coefficient": 2.0,
            "use_linear": True},
            gen={"label": _consts(0, 3, 1, 2, 7)}),
        Case({"data": (5, 4), "label": (5,)}, attrs={"margin": 2.0},
             gen={"label": _consts(1, 1, 0, 3, -1)}),
    ],
    "IdentityAttachKLSparseReg": [
        Case({"data": (6, 3)}, attrs={"sparseness_target": 0.2,
                                      "penalty": 0.1, "momentum": 0.5},
             gen={"data": U(0.05, 0.95)}),
    ],
}


def _arguments(jsym, case, rs):
    """The numpy arrays of every argument of ``jsym``: the case's inputs
    from their generators, the inferred parameters U(-1, 1)."""
    arrays = {k: case.gen.get(k, U(-1.0, 1.0))(shape, rs)
              for k, shape in case.shapes.items()}
    shapes, _, _ = jsym.infer_shape(**{k: v.shape for k, v in
                                       arrays.items()})
    for name, shape in zip(jsym.list_arguments(), shapes):
        if name not in arrays:
            arrays[name] = rs.uniform(-1.0, 1.0, shape).astype(np.float32)
    return arrays


def _params_through_file(arrays, tmp_path):
    """The port's copy of ``arrays``: the bytes of a ``.params`` file the
    JAX package saves, loaded by the port and carried onto its CPU
    context by ``mx.convert``."""
    path = str(tmp_path / "case.params")
    mxj.nd.save(path, {f"arg:{k}": mxj.nd.array(v) for k, v in
                       arrays.items()})
    loaded = mxt.nd.load(path)
    return mxt.convert.params_from_numpy(
        {k.split(":", 1)[1]: v.asnumpy() for k, v in loaded.items()},
        mxt.cpu())


def run_both(jsym, arrays, tmp_path, is_train=True, seed=0, heads=True):
    """Both Executors over the same JSON and arrays: (JAX outputs, port
    outputs, JAX gradients, port gradients) as numpy, the gradients of
    every argument (None when ``is_train`` is off)."""
    tsym = mxt.symbol.load_json(jsym.tojson())
    assert tsym.tojson() == jsym.tojson()
    targs = _params_through_file(arrays, tmp_path)
    shapes = {k: v.shape for k, v in arrays.items()}
    req = "write" if is_train else "null"
    jex = jsym.simple_bind(ctx=mxj.cpu(), grad_req=req, **shapes)
    tex = tsym.simple_bind(ctx=mxt.cpu(), grad_req=req, **shapes)
    mxj.random.seed(seed)
    mxt.random.seed(seed)
    jex.forward(is_train=is_train, **{k: mxj.nd.array(v)
                                      for k, v in arrays.items()})
    t_out = [o.asnumpy() for o in tex.forward(is_train=is_train, **targs)]
    if not is_train:
        return [o.asnumpy() for o in jex.outputs], t_out, None, None
    rs = np.random.RandomState(seed + 7)
    hs = [rs.uniform(0.5, 1.5, o.shape).astype(np.float32) for o in t_out]
    # the JAX Executor's training forward is lazy: a backward before any
    # output is read runs forward and backward as one compiled program
    jex.backward([mxj.nd.array(h) for h in hs])
    tex.backward([mxt.nd.array(h, ctx=mxt.cpu()) for h in hs])
    return ([o.asnumpy() for o in jex.outputs], t_out,
            {k: jex.grad_dict[k].asnumpy() for k in arrays},
            {k: tex.grad_dict[k].asnumpy() for k in arrays})


def assert_agree(j_out, t_out, j_grad=None, t_grad=None, label=""):
    assert len(j_out) == len(t_out), label
    for a, b in zip(j_out, t_out):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (label, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=label)
    for k, want in (j_grad or {}).items():
        got = t_grad[k]
        assert got.shape == want.shape, (label, k)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, \
            (label, k, float(np.abs(got - want).max()), scale)


def _params():
    for name in LAYERS + LOSSES:
        for i in range(len(CASES[name])):
            yield pytest.param("sweep", name, i, id=f"{name}-sweep{i}")
        for i in range(len(MORE.get(name, []))):
            yield pytest.param("more", name, i, id=f"{name}-{i}")


@pytest.mark.parametrize("table,name,i", list(_params()))
def test_case_matches_jax_through_both_executors(table, name, i, tmp_path):
    case = (CASES if table == "sweep" else MORE)[name][i]
    with mxj.name.NameManager():
        jsym = _build(name, case)
    arrays = _arguments(jsym, case, np.random.RandomState(100 + i))
    assert_agree(*run_both(jsym, arrays, tmp_path, seed=i), label=name)


# --------------------------------------------------------------------------
# rrelu: the slopes are mx.random's draws under the node's key
# --------------------------------------------------------------------------
def _rrelu_graph(sym):
    return sym.LeakyReLU(sym.var("x"), act_type="rrelu", lower_bound=0.1,
                         upper_bound=0.6, name="act")


@pytest.mark.parametrize("seed", [0, 11])
def test_rrelu_training_slopes_are_bit_for_bit(seed, tmp_path):
    """The forward's key (one ``next_key()`` after the same seed), folded
    with the node's index, draws the same slopes in both packages."""
    with mxj.name.NameManager():
        jsym = mxj.sym.Group([_rrelu_graph(mxj.sym),
                              mxj.sym.Dropout(mxj.sym.var("y"), p=0.5)])
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (5, 16)).astype(np.float32)
    arrays = {"x": x, "y": np.ones((3, 4), np.float32)}
    j_out, t_out, j_grad, t_grad = run_both(jsym, arrays, tmp_path,
                                            seed=seed)
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(b, a)
    assert_agree(j_out, t_out, j_grad, t_grad, "rrelu")
    neg = x < 0
    slopes = t_out[0][neg] / x[neg]
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() < 0.6 + 1e-6
    assert np.unique(np.round(slopes, 5)).size > 10
    np.testing.assert_array_equal(t_out[0][~neg], x[~neg])


def test_rrelu_inference_uses_the_mean_slope(tmp_path):
    with mxj.name.NameManager():
        jsym = _rrelu_graph(mxj.sym)
    x = np.random.RandomState(3).uniform(-1, 1, (4, 7)).astype(np.float32)
    j_out, t_out, _, _ = run_both(jsym, {"x": x}, tmp_path, is_train=False)
    np.testing.assert_array_equal(t_out[0], j_out[0])
    np.testing.assert_array_equal(t_out[0], np.where(
        x > 0, x, np.float32(0.35) * x))


def test_every_act_type_draws_a_key():
    """``need_rng`` for every act_type, as the JAX package registers it:
    the key chain moves alike whatever the node computes."""
    for pkg in (mxj, mxt):
        assert pkg.ops.get_op("LeakyReLU").need_rng


# --------------------------------------------------------------------------
# ROIPooling at a detector's shape, and its tie split
# --------------------------------------------------------------------------
def test_roi_pooling_chunks_agree_with_one_pass(monkeypatch):
    """The chunked forward and the recomputing backward equal one pass of
    the separable composition under autograd."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    rs = np.random.RandomState(5)
    data = torch.tensor(relu_like((2, 4, 12, 10), rs), requires_grad=True)
    rois = torch.tensor(np.concatenate([
        rs.randint(0, 2, (9, 1)), rs.uniform(-8, 40, (9, 4))], 1)
        .astype(np.float32))
    attrs = {"pooled_size": (3, 4), "spatial_scale": 0.25}
    g = torch.tensor(rs.uniform(0.5, 1.5, (9, 4, 3, 4)).astype(np.float32))
    monkeypatch.setattr(tnn, "ROI_CHUNK_ELEMS", 1)      # a ROI a chunk
    out = tnn._roi_pooling(attrs, data, rois)
    got, = torch.autograd.grad(out, data, g)
    b, ym, xm = tnn.roi_bins(rois, 0.25, (3, 4), (12, 10), 2)
    ref = tnn._roi_pool_chunk(data[b], ym, xm)
    want, = torch.autograd.grad(ref, data, g)
    assert torch.equal(out, ref.detach())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_roi_pooling_tie_split_differs_from_the_joint_max(tmp_path):
    """Pinned (ROADMAP.md §C): a cell whose tied rows hold unequal numbers
    of tied maxima. The JAX package's joint max splits the cell's gradient
    evenly among the three 1s; the port's separable max splits it between
    the two rows first, then within each row. Equal ties per row (a cell
    of zeros after a ReLU) split alike in both."""
    with mxj.name.NameManager():
        jsym = mxj.sym.ROIPooling(mxj.sym.var("data"), mxj.sym.var("rois"),
                                  pooled_size=(1, 1), spatial_scale=1.0)
    arrays = {"data": np.array([[[[1, 1], [1, 0]]]], np.float32),
              "rois": np.array([[0, 0, 0, 1, 1]], np.float32)}
    j_out, t_out, j_grad, t_grad = run_both(jsym, arrays, tmp_path)
    np.testing.assert_array_equal(t_out[0], j_out[0])
    # run_both's head gradient: one value
    h = float(np.random.RandomState(7).uniform(0.5, 1.5))
    np.testing.assert_allclose(j_grad["data"][0, 0], [[h / 3, h / 3],
                                                      [h / 3, 0]], rtol=1e-6)
    np.testing.assert_allclose(t_grad["data"][0, 0], [[h / 4, h / 4],
                                                      [h / 2, 0]], rtol=1e-6)


# --------------------------------------------------------------------------
# pinned faults of the reference that the port copies
# --------------------------------------------------------------------------
def _correlation(data1, data2, **attrs):
    with mxt.cpu():
        return mxt.nd.Correlation(mxt.nd.array(data1), mxt.nd.array(data2),
                                  **attrs)[0].asnumpy()


def test_correlation_copies_the_reference_faults():
    """The JAX package's Correlation (and the port's): the shift wraps
    around (MXNet reads zeros past the edge), ``kernel_size``,
    ``stride1`` and ``is_multiply`` change nothing, and the product is
    averaged over channels (MXNet sums it over the kernel window and
    divides by its size times the channels: the same for a 1 x 1 kernel)."""
    rs = np.random.RandomState(0)
    a = rs.uniform(-1, 1, (1, 3, 4, 5)).astype(np.float32)
    b = rs.uniform(-1, 1, (1, 3, 4, 5)).astype(np.float32)
    base = _correlation(a, b, max_displacement=1)
    # wrap-around: displacement (dy, dx) = (0, 1) at the last column reads
    # column 0 of data2
    np.testing.assert_allclose(base[0, 5, :, 4],
                               (a[0, :, :, 4] * b[0, :, :, 0]).mean(0),
                               rtol=1e-6)
    for attrs in ({"kernel_size": 3}, {"stride1": 2},
                  {"is_multiply": False}):
        np.testing.assert_array_equal(
            _correlation(a, b, max_displacement=1, **attrs), base)
    np.testing.assert_allclose(base[0, 4], (a[0] * b[0]).mean(0), rtol=1e-6)
    jax_out = np.asarray(mxj.nd.Correlation(
        mxj.nd.array(a), mxj.nd.array(b), max_displacement=1,
        kernel_size=3, is_multiply=False)[0].asnumpy())
    np.testing.assert_allclose(jax_out, base, rtol=1e-6, atol=1e-7)


def test_deconvolution_ignores_target_shape_and_dilate(tmp_path):
    """Both packages parse ``target_shape`` and ``dilate`` and read
    neither: the output keeps the stride's shape (MXNet would size it to
    ``target_shape`` and dilate the kernel)."""
    rs = np.random.RandomState(2)
    arrays = {"data": rs.uniform(-1, 1, (1, 2, 3, 3)).astype(np.float32),
              "d_weight": rs.uniform(-1, 1, (2, 3, 3, 3)).astype(np.float32)}
    outs = []
    for extra in ({}, {"target_shape": (9, 9)}, {"dilate": (2, 2)}):
        with mxj.name.NameManager():
            jsym = mxj.sym.Deconvolution(mxj.sym.var("data"), name="d",
                                         kernel=(3, 3), stride=(2, 2),
                                         num_filter=3, **extra)
        j_out, t_out, j_grad, t_grad = run_both(jsym, arrays, tmp_path)
        assert_agree(j_out, t_out, j_grad, t_grad, str(extra))
        outs.append(t_out[0])
    assert outs[0].shape == (1, 3, 7, 7)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_kl_sparse_reg_ignores_momentum(tmp_path):
    """The penalty's gradient comes from this batch's mean activation in
    both packages; ``momentum`` (MXNet's moving average of it) is read by
    neither. The scalar penalty is added to every output element, so its
    gradient is scaled by the sum of the head gradient (MXNet adds
    penalty * dKL/drho / N whatever the head): the gradient is ``head +
    sum(head) * penalty * dKL/drho / N``."""
    rs = np.random.RandomState(4)
    arrays = {"data": rs.uniform(0.05, 0.95, (6, 3)).astype(np.float32)}
    grads = []
    for momentum in (0.0, 0.9):
        with mxj.name.NameManager():
            jsym = mxj.sym.IdentityAttachKLSparseReg(
                mxj.sym.var("data"), sparseness_target=0.2, penalty=0.1,
                momentum=momentum)
        j_out, t_out, j_grad, t_grad = run_both(jsym, arrays, tmp_path)
        assert_agree(j_out, t_out, j_grad, t_grad, f"momentum {momentum}")
        np.testing.assert_array_equal(t_out[0], arrays["data"])
        grads.append(t_grad["data"])
    np.testing.assert_array_equal(grads[0], grads[1])
    head = np.random.RandomState(7).uniform(0.5, 1.5, (6, 3))
    rho = arrays["data"].astype(np.float64).mean(0)
    dkl = 0.1 * (-0.2 / rho + 0.8 / (1 - rho)) / 6
    np.testing.assert_allclose(grads[0], head + head.sum() * dkl, rtol=1e-5)


# --------------------------------------------------------------------------
# the initializers' name rules and Bilinear
# --------------------------------------------------------------------------
NAME_RULES = ["upsampling0_weight", "up1_weight", "fc_bias", "bn_gamma",
              "bn_beta", "bn_moving_mean", "bn_moving_var",
              "bn_moving_inv_var", "reg_moving_avg", "upsampling2_bias"]


@pytest.mark.parametrize("init", ["uniform", "xavier", "bilinear"])
def test_initializers_fill_every_name_rule_as_jax(init):
    shape = (3, 1, 4, 4)
    make = {"uniform": lambda m: m.initializer.Uniform(0.3),
            "xavier": lambda m: m.initializer.Xavier(),
            "bilinear": lambda m: m.initializer.Bilinear()}[init]
    mxj.random.seed(9)
    mxt.random.seed(9)
    ji, ti = make(mxj), make(mxt)
    for name in NAME_RULES:
        a = mxj.nd.zeros(shape)
        b = mxt.nd.zeros(shape, ctx=mxt.cpu())
        ji(name, a)
        ti(name, b)
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy(),
                                      err_msg=f"{init} {name}")
    for m, i, z in ((mxj, ji, mxj.nd.zeros(shape)),
                    (mxt, ti, mxt.nd.zeros(shape, ctx=mxt.cpu()))):
        with pytest.raises(ValueError):
            i("fc_scale", z)


def test_bilinear_fill_is_the_upsampling_kernel():
    w = mxt.nd.zeros((2, 1, 4, 4), ctx=mxt.cpu())
    mxt.initializer.Zero()("upsampling_w_weight", w)
    row = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
    np.testing.assert_array_equal(w.asnumpy()[1, 0], np.outer(row, row))


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
def _batches(rs):
    return [(rs.uniform(-1, 1, (4,)).astype(np.float32),
             rs.uniform(-1, 1, (4, 1)).astype(np.float32)),
            (rs.uniform(-1, 1, (3, 2)).astype(np.float32),
             rs.uniform(-1, 1, (3, 2)).astype(np.float32))]


@pytest.mark.parametrize("name", ["mae", "mse", "rmse"])
def test_regression_metrics_match_jax(name):
    jm, tm = mxj.metric.create(name), mxt.metric.create(name)
    for lab, pred in _batches(np.random.RandomState(1)):
        jm.update([mxj.nd.array(lab)], [mxj.nd.array(pred)])
        tm.update([mxt.nd.array(lab, ctx=mxt.cpu())],
                  [mxt.nd.array(pred, ctx=mxt.cpu())])
    assert tm.get()[0] == jm.get()[0] == name
    assert math.isclose(tm.get()[1], jm.get()[1], rel_tol=1e-6)


def test_custom_metric_and_np_match_jax():
    def dacc(lab, pred):
        return ((pred > 0.5) == (lab > 0.5)).mean()

    def total(lab, pred):
        return float(np.abs(lab - pred).sum()), lab.size

    for make in (lambda m: m.metric.CustomMetric(dacc),
                 lambda m: m.metric.CustomMetric(
                     lambda l, p: float((l == p.round()).mean())),
                 lambda m: m.metric.np(total, name="l1"),
                 lambda m: m.metric.create(dacc),
                 lambda m: m.metric.CustomMetric(dacc, name="d",
                                                 allow_extra_outputs=True)):
        jm, tm = make(mxj), make(mxt)
        rs = np.random.RandomState(2)
        for _ in range(3):
            lab = rs.randint(0, 2, (5, 1)).astype(np.float32)
            pred = rs.uniform(0, 1, (5, 1)).astype(np.float32)
            extra = [rs.uniform(0, 1, (5, 1)).astype(np.float32)] \
                if jm._allow_extra_outputs else []
            jm.update([mxj.nd.array(lab)],
                      [mxj.nd.array(p) for p in [pred] + extra])
            tm.update([mxt.nd.array(lab, ctx=mxt.cpu())],
                      [mxt.nd.array(p, ctx=mxt.cpu())
                       for p in [pred] + extra])
        assert tm.get()[0] == jm.get()[0]
        assert math.isclose(tm.get()[1], jm.get()[1], rel_tol=1e-12)
        assert tm.num_inst == jm.num_inst
