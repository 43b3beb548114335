"""The contrib ops (``quantize`` / ``dequantize``, ``fft`` / ``ifft``,
``count_sketch``, the CTC loss, the MultiBox trio, ``MultiProposal``) and
the detection half of ``image.py``, against the JAX package on the CPU.

* Each case is a graph built with the JAX package's ``mx.sym``, carried to
  the port through ``tojson()`` / ``load_json``, its inputs crossing as the
  bytes of a ``.params`` file the JAX package saves and the port loads
  (``tests/test_torch_nn_layers.py``'s harness), every input in its own
  dtype. Outputs within 2e-5 (rtol and atol); exactly for what only
  counts, orders or compares: ``quantize``, the anchors,
  ``MultiBoxTarget``'s ``loc_mask`` and ``cls_target`` and
  ``MultiBoxDetection``'s ids. Gradients (CTC, ``fft``, ``ifft``,
  ``count_sketch``; ``MultiBoxTarget``'s into ``cls_pred``, zero in both)
  within 1e-5 of each one's largest magnitude, from the same random head
  gradients.
* Every case the JAX sweep (``tests/test_op_sweep.py``) defines for these
  names, its ``_check_multi_proposal``, and the traps: ties in every sort
  (equal scores, equal hardness, ``-inf``-masked proposals), the forced
  match's repeated anchor (pinned: a padding row clears it, as XLA's last
  write does on the CPU), anchors under the score threshold suppressing
  others and ``nms_topk`` read by neither (pinned), the MultiBox ops run
  detached (pinned: no gradient into ``anchor`` or ``label``, where the
  JAX package has one no graph reads), CTC with label length 0, with
  both lengths, and with the label lengths alone, which both packages
  bind by position as data lengths (pinned), ``quantize`` to int8 and
  uint8 at half-way points and past the range, negative
  ``count_sketch`` hashes, proposals padded past the survivors.
* The detection augmenters and ``ImageDetIter`` give the JAX package's
  images, labels and pads bit for bit under the same ``random`` /
  ``np.random`` seeds.
"""
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import jax.numpy as jnp

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.contrib import ops as tops

from test_op_sweep import CASES, Case, U, _build
from test_torch_nn_layers import TOL, GRAD_RTOL

F32 = np.float32

#: the sweep's names of the contrib ops
SWEPT = ["quantize", "dequantize", "fft", "ifft", "count_sketch", "CTCLoss",
         "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection"]
#: inputs each op differentiates (the rest bind with grad_req "null")
GRADS = {"CTCLoss": ["data"], "fft": ["data"], "ifft": ["data"],
         "count_sketch": ["data", "s"], "MultiBoxTarget": ["cls_pred"]}
#: outputs held exactly: op -> output indices
EXACT = {"quantize": (0, 1, 2), "MultiBoxPrior": (0,),
         "MultiBoxTarget": (1, 2)}
#: inputs of an integer dtype: op -> {input: dtype}
DTYPES = {"dequantize": {"data": np.uint8}}


def _consts(*rows, dtype=F32):
    arr = np.array(rows, dtype)
    return lambda shape, rs: arr.reshape(shape)


def _grid_anchors(shape, rs):
    """A (1, 2 n^2, 4) grid of 0.3-wide anchors, overlapping."""
    n = int(round((shape[1] // 2) ** 0.5))
    c = (np.arange(n) + 0.5) / n
    cy, cx = np.meshgrid(c, c, indexing="ij")
    boxes = []
    for half in (0.15, 0.25):
        boxes.append(np.stack([cx - half, cy - half, cx + half, cy + half],
                              -1).reshape(-1, 4))
    return np.concatenate(boxes)[None].astype(F32)


def _dirichlet(shape, rs):
    n, c, a = shape
    return rs.dirichlet(np.ones(c), (n, a)).transpose(0, 2, 1).astype(F32)


def _hashes(shape, rs):
    return rs.randint(-9, 9, shape).astype(F32)


def _signs(shape, rs):
    return np.where(rs.rand(*shape) < 0.5, -1, 1).astype(F32)


#: the cases the JAX sweep has not, by op
MORE = {
    "quantize": [
        # half-way points round to even; past the range clips
        Case({"data": (2, 4), "min_range": (1,), "max_range": (1,)},
             attrs={"out_type": "uint8"},
             gen={"data": _consts([0.5, 1.5, 2.5, 254.5],
                                  [-3.0, 255.5, 300.0, 127.5]),
                  "min_range": _consts([0.0]),
                  "max_range": _consts([255.0])}),
        Case({"data": (2, 4), "min_range": (1,), "max_range": (1,)},
             attrs={"out_type": "int8"},
             gen={"data": _consts([0.5, 1.5, 2.5, 254.5],
                                  [-3.0, 255.5, 300.0, 127.5]),
                  "min_range": _consts([0.0]),
                  "max_range": _consts([255.0])}),
        Case({"data": (3, 5), "min_range": (1,), "max_range": (1,)},
             attrs={"out_type": "int8"},
             gen={"data": U(-1.3, 1.3), "min_range": _consts([-1.0]),
                  "max_range": _consts([1.0])}),
    ],
    "dequantize": [
        Case({"data": (2, 5), "min_range": (1,), "max_range": (1,)},
             gen={"data": lambda s, r: r.randint(-128, 128, s).astype(
                 np.int8), "min_range": _consts([-2.0]),
                 "max_range": _consts([3.0])}),
    ],
    "fft": [Case({"data": (2, 3, 8)})],
    "ifft": [Case({"data": (3, 2, 6)})],
    "count_sketch": [
        Case({"data": (3, 9), "h": (1, 9), "s": (1, 9)},
             attrs={"out_dim": 5}, gen={"h": _hashes, "s": _signs}),
    ],
    "CTCLoss": [
        # a label of zeros (length 0, only blanks), and repeated labels,
        # which need a blank between them
        Case({"data": (6, 5, 5), "label": (5, 3)},
             gen={"label": _consts([0, 0, 0], [3, 0, 0], [1, 4, 0],
                                   [1, 1, 2], [3, 3, 3])}),
        Case({"data": (6, 3, 5), "label": (3, 3), "data_lengths": (3,),
              "label_lengths": (3,)},
             attrs={"use_data_lengths": True, "use_label_lengths": True},
             gen={"label": _consts([1, 1, 2], [2, 0, 0], [4, 3, 2]),
                  "data_lengths": _consts(6, 4, 5),
                  "label_lengths": _consts(3, 0, 2)}),
    ],
    "MultiBoxPrior": [
        Case({"data": (2, 3, 5, 7)}, attrs={
            "sizes": (0.3, 0.6, 0.9), "ratios": (1.0, 2.0, 0.5, 3.0),
            "clip": True}),
        Case({"data": (1, 1, 4, 6)}, attrs={
            "sizes": (0.25,), "ratios": (1.0,), "steps": (0.2, 0.1),
            "offsets": (0.25, 0.75)}),
    ],
    "MultiBoxTarget": [
        # hard-negative mining over a grid, random scores
        Case({"anchor": (1, 32, 4), "label": (2, 3, 5), "cls_pred": (2, 3,
                                                                     32)},
             attrs={"negative_mining_ratio": 3},
             gen={"anchor": _grid_anchors,
                  "label": _consts([[0, 0.1, 0.1, 0.5, 0.45],
                                    [1, 0.55, 0.5, 0.95, 0.9],
                                    [-1, 0, 0, 0, 0]],
                                   [[1, 0.3, 0.2, 0.7, 0.6],
                                    [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]]),
                  "cls_pred": U(-1.0, 1.0)}),
        # equal hardness everywhere: the ranks fall back on the index
        Case({"anchor": (1, 32, 4), "label": (2, 2, 5), "cls_pred": (2, 3,
                                                                     32)},
             attrs={"negative_mining_ratio": 2,
                    "minimum_negative_samples": 3,
                    "negative_mining_thresh": 0.4,
                    "variances": (0.1, 0.1, 0.2, 0.2)},
             gen={"anchor": _grid_anchors,
                  "label": _consts([[1, 0.2, 0.2, 0.5, 0.6],
                                    [0, 0.6, 0.1, 0.9, 0.3]],
                                   [[-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]]),
                  "cls_pred": lambda s, r: np.zeros(s, F32)}),
    ],
    "MultiBoxDetection": [
        Case({"cls_prob": (2, 3, 32), "loc_pred": (2, 128),
              "anchor": (1, 32, 4)},
             attrs={"nms_threshold": 0.3, "threshold": 0.2},
             gen={"cls_prob": _dirichlet, "loc_pred": U(-0.2, 0.2),
                  "anchor": _grid_anchors}),
        # every score tied: the order is the anchors'
        Case({"cls_prob": (2, 3, 32), "loc_pred": (2, 128),
              "anchor": (1, 32, 4)}, attrs={"threshold": 0.2},
             gen={"cls_prob": lambda s, r: np.full(s, 1 / 3, F32),
                  "loc_pred": lambda s, r: np.zeros(s, F32),
                  "anchor": _grid_anchors}),
        Case({"cls_prob": (1, 4, 32), "loc_pred": (1, 128),
              "anchor": (1, 32, 4)},
             attrs={"force_suppress": True, "background_id": 2,
                    "clip": False, "variances": (0.2, 0.2, 0.3, 0.3)},
             gen={"cls_prob": _dirichlet, "loc_pred": U(-0.5, 0.5),
                  "anchor": _grid_anchors}),
    ],
    "MultiProposal": [
        # the sweep's _check_multi_proposal
        Case({"cls_prob": (1, 2, 4, 4), "bbox_pred": (1, 4, 4, 4),
              "im_info": (1, 3)},
             attrs={"feature_stride": 4, "scales": (2.0,), "ratios": (1.0,),
                    "rpn_pre_nms_top_n": 8, "rpn_post_nms_top_n": 4,
                    "rpn_min_size": 2, "threshold": 0.7},
             gen={"cls_prob": U(0.0, 1.0), "bbox_pred": U(-0.2, 0.2),
                  "im_info": _consts([16.0, 16.0, 1.0])}),
        Case({"cls_prob": (2, 6, 4, 5), "bbox_pred": (2, 12, 4, 5),
              "im_info": (2, 3)},
             attrs={"feature_stride": 16, "scales": (1.0, 2.0, 4.0),
                    "ratios": (1.0,), "rpn_pre_nms_top_n": 40,
                    "rpn_post_nms_top_n": 12, "rpn_min_size": 4,
                    "threshold": 0.5, "output_score": True},
             gen={"cls_prob": U(0.0, 1.0), "bbox_pred": U(-0.3, 0.3),
                  "im_info": _consts([60, 70, 1.0], [50, 64, 0.5])}),
        # tied scores, a minimum size that drops boxes (-inf scores), and
        # more slots than proposals: padded with the first box
        Case({"cls_prob": (1, 6, 3, 3), "bbox_pred": (1, 12, 3, 3),
              "im_info": (1, 3)},
             attrs={"feature_stride": 8, "scales": (1.0, 2.0, 4.0),
                    "ratios": (1.0,), "rpn_pre_nms_top_n": 20,
                    "rpn_post_nms_top_n": 30, "rpn_min_size": 12,
                    "threshold": 0.6, "output_score": True},
             gen={"cls_prob": lambda s, r: np.round(
                 r.uniform(0, 1, s) * 4).astype(F32) / 4,
                  "bbox_pred": U(-0.2, 0.2),
                  "im_info": _consts([24.0, 24.0, 1.0])}),
        Case({"cls_prob": (1, 8, 3, 4), "bbox_pred": (1, 16, 3, 4),
              "im_info": (1, 3)},
             attrs={"feature_stride": 8, "scales": (1.0, 2.0),
                    "ratios": (0.5, 2.0), "rpn_pre_nms_top_n": 30,
                    "rpn_post_nms_top_n": 10, "rpn_min_size": 2,
                    "iou_loss": True},
             gen={"cls_prob": U(0.0, 1.0), "bbox_pred": U(-2.0, 2.0),
                  "im_info": _consts([30.0, 40.0, 1.0])}),
    ],
}


def _arrays(case, rs, dtypes):
    arrays = {k: case.gen.get(k, U(-1.0, 1.0))(shape, rs)
              for k, shape in case.shapes.items()}
    for k, dt in dtypes.items():
        arrays[k] = arrays[k].astype(dt)
    return arrays


def run_both(jsym, arrays, tmp_path, grads=(), seed=0):
    """Both Executors over the same JSON and ``.params`` bytes, each input
    bound in its own dtype: an inference forward, or with ``grads`` a
    training forward and a backward (those inputs' ``grad_req`` "write")
    from the same random head gradients. (JAX outputs, port outputs, JAX
    gradients, port gradients) as numpy."""
    tsym = mxt.symbol.load_json(jsym.tojson())
    assert tsym.tojson() == jsym.tojson()
    path = str(tmp_path / "case.params")
    mxj.nd.save(path, {f"arg:{k}": mxj.nd.array(v, dtype=v.dtype)
                       for k, v in arrays.items()})
    targs = {k.split(":", 1)[1]: v.as_in_context(mxt.cpu())
             for k, v in mxt.nd.load(path).items()}
    for k, v in arrays.items():
        assert targs[k].asnumpy().dtype == v.dtype, k
    kw = {k: v.shape for k, v in arrays.items()}
    types = {k: v.dtype for k, v in arrays.items()}
    req = {k: "write" if k in grads else "null" for k in arrays}
    jex = jsym.simple_bind(ctx=mxj.cpu(), grad_req=req, type_dict=types,
                           **kw)
    tex = tsym.simple_bind(ctx=mxt.cpu(), grad_req=req, type_dict=types,
                           **kw)
    train = bool(grads)
    jex.forward(is_train=train, **{k: mxj.nd.array(v, dtype=v.dtype)
                                   for k, v in arrays.items()})
    t_out = [o.asnumpy() for o in tex.forward(is_train=train, **targs)]
    if not train:
        return [o.asnumpy() for o in jex.outputs], t_out, None, None
    rs = np.random.RandomState(seed + 7)
    hs = [rs.uniform(0.5, 1.5, o.shape).astype(F32) for o in t_out]
    # the JAX Executor's training forward is lazy: a backward before any
    # output is read runs forward and backward as one compiled program
    jex.backward([mxj.nd.array(h) for h in hs])
    tex.backward([mxt.nd.array(h, ctx=mxt.cpu()) for h in hs])
    return ([o.asnumpy() for o in jex.outputs], t_out,
            {k: jex.grad_dict[k].asnumpy() for k in grads},
            {k: tex.grad_dict[k].asnumpy() for k in grads})


def assert_agree(name, j_out, t_out, j_grad=None, t_grad=None):
    assert len(j_out) == len(t_out), name
    for i, (a, b) in enumerate(zip(j_out, t_out)):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (name, i, a.shape, b.shape, a.dtype, b.dtype)
        if i in EXACT.get(name, ()):
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{i}]")
        else:
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f"{name}[{i}]")
        if name == "MultiBoxDetection":
            np.testing.assert_array_equal(b[..., 0], a[..., 0], err_msg=name)
    for k, want in (j_grad or {}).items():
        got = t_grad[k]
        assert got.shape == want.shape, (name, k)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, \
            (name, k, float(np.abs(got - want).max()), scale)


def _params():
    for name in SWEPT:
        for i in range(len(CASES[name])):
            yield pytest.param("sweep", name, i, id=f"{name}-sweep{i}")
    for name in MORE:
        for i in range(len(MORE[name])):
            yield pytest.param("more", name, i, id=f"{name}-{i}")


def check_case(name, case, seed, tmp_path):
    with mxj.name.NameManager():
        jsym = _build(name, case)
    rs = np.random.RandomState(100 + seed)
    arrays = _arrays(case, rs, DTYPES.get(name, {}))
    grads = [k for k in GRADS.get(name, []) if k in arrays]
    out = run_both(jsym, arrays, tmp_path, grads, seed)
    assert_agree(name, *out)
    return out


@pytest.mark.parametrize("table,name,i", list(_params()))
def test_case_matches_jax_through_both_executors(table, name, i, tmp_path):
    case = (CASES if table == "sweep" else MORE)[name][i]
    check_case(name, case, i, tmp_path)


# --------------------------------------------------------------------------
# the traps
# --------------------------------------------------------------------------
def test_forced_match_keeps_xla_last_write(tmp_path):
    """``forced.at[best_anchor].set(valid)`` with anchor 0 picked twice: the
    JAX package on the CPU keeps the last write, and so does the port's
    scatter-free rule."""
    best = np.array([[0, 2, 0]])
    valid = np.array([[True, True, False]])
    want = np.zeros(4, bool)
    want = np.asarray(jnp.asarray(want).at[best[0]].set(valid[0]))
    got = tops.forced_matches(torch.tensor(best), torch.tensor(valid), 4)
    assert want.tolist() == [False, False, True, False]
    assert got[0].tolist() == want.tolist()


def test_padding_row_clears_a_forced_match_and_the_op_runs_detached(
        tmp_path):
    """Two pins, one graph (two ``MultiBoxTarget`` nodes over one anchor set
    and two label sets). A fault of the reference the port copies: a valid
    box whose best anchor is anchor 0 at IoU < overlap_threshold is forced
    positive (MXNet forces a match for every valid box), unless a padding
    row (cls -1, an all-zero IoU column, so its best anchor is 0 too)
    comes after it: then the last write clears anchor 0 in both packages.
    A divergence of the port: the op runs detached. Its gradient into
    ``cls_pred`` is zero in both packages (the op only ranks by it); the
    JAX package also differentiates ``loc_target`` with respect to
    ``anchor`` and ``label``, which the port leaves at zero: no graph
    reads them (``MultiBoxPrior``'s anchors depend on the data's shape
    alone, and a label takes no gradient)."""
    box = [1, 0.0, 0.0, 0.2, 0.2]            # IoU 0.25 with anchor 0

    def build(v, a):
        return mxj.sym.Group([mxj.sym.MultiBoxTarget(
            v["anchor"], v[lab], v["cls_pred"], name=f"t{i}")
            for i, lab in enumerate(("valid", "padded"))])

    case = Case({"anchor": (1, 2, 4), "valid": (1, 2, 5), "padded": (1, 2, 5),
                 "cls_pred": (1, 2, 2)}, builder=build,
                gen={"anchor": _consts([[0.0, 0.0, 0.4, 0.4],
                                        [0.6, 0.6, 1.0, 1.0]]),
                     "valid": _consts([[box, [0, 0.6, 0.6, 1.0, 1.0]]]),
                     "padded": _consts([[box, [-1, 0, 0, 0, 0]]])})
    with mxj.name.NameManager():
        jsym = _build("MultiBoxTarget", case)
    arrays = _arrays(case, np.random.RandomState(100), {})
    grads = ["anchor", "valid", "padded", "cls_pred"]
    j_out, t_out, j_grad, t_grad = run_both(jsym, arrays, tmp_path, grads)
    assert_agree("MultiBoxTarget", j_out[:3], t_out[:3])
    assert_agree("MultiBoxTarget", j_out[3:], t_out[3:])
    assert t_out[1][0, :4].tolist() == [1.0] * 4   # anchor 0 forced
    assert t_out[4][0, :4].tolist() == [0.0] * 4   # the padding row cleared it
    assert not j_grad["cls_pred"].any() and not t_grad["cls_pred"].any()
    for k in ("anchor", "valid"):       # the padded set matches nothing
        assert np.abs(j_grad[k]).max() > 0.1, k
    for k in ("anchor", "valid", "padded"):
        assert not t_grad[k].any(), k


def test_below_threshold_anchors_suppress_and_nms_topk_is_unread(tmp_path):
    """Pinned, copied from the JAX package: NMS runs over every anchor and
    ``keep`` (score > threshold) is applied after it, so an anchor under
    the threshold suppresses the later ones it overlaps (MXNet drops it
    first; the outputs agree, since every later anchor is under the
    threshold too); ``nms_topk`` is parsed and read by neither package
    (one graph: the op at ``nms_topk`` -1 and 1)."""
    anchor = _consts([[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9],
                      [0.62, 0.6, 0.92, 0.9]])

    def build(v, a):
        return mxj.sym.Group([mxj.sym.MultiBoxDetection(
            v["cls_prob"], v["loc_pred"], v["anchor"], threshold=0.005,
            nms_topk=k, name=f"d{i}") for i, k in enumerate((-1, 1))])

    case = Case({"cls_prob": (1, 2, 3), "loc_pred": (1, 12),
                 "anchor": (1, 3, 4)}, builder=build,
                gen={"cls_prob": _consts([[0.991, 0.996, 0.997],
                                          [0.009, 0.004, 0.003]]),
                     "loc_pred": lambda s, r: np.zeros(s, F32),
                     "anchor": anchor})
    _, t_out, _, _ = check_case("MultiBoxDetection", case, 0, tmp_path)
    np.testing.assert_array_equal(t_out[0], t_out[1])
    assert t_out[0][0, :, 0].tolist() == [0.0, -1.0, -1.0]
    # anchor 1 (0.004, under the threshold) suppressed anchor 2 (0.003)
    boxes = torch.tensor(anchor(None, None)[0])[None]
    supp = (tops._iou(boxes, boxes) > 0.5) & torch.ones(
        3, 3, dtype=torch.bool).triu(1)
    assert tops.greedy_nms(supp).tolist() == [[True, True, False]]


def test_ctc_label_lengths_alone_are_read_as_data_lengths(tmp_path):
    """Pinned, a fault of the reference the port copies: with
    ``use_label_lengths`` and without ``use_data_lengths`` the op's third
    input binds to ``data_lengths`` by position, so the label lengths cut
    the input at those frames and the label lengths become the count of
    non-zero labels. Both packages give the loss of those readings."""
    case = Case({"data": (5, 2, 4), "label": (2, 3), "label_lengths": (2,)},
                attrs={"use_label_lengths": True},
                gen={"label": _consts([1, 2, 3], [2, 3, 1]),
                     "label_lengths": _consts(2, 4)})
    _, t_out, _, _ = check_case("CTCLoss", case, 0, tmp_path)
    data = U(-1.0, 1.0)((5, 2, 4), np.random.RandomState(100))
    want = tops.ctc_loss_batch(
        torch.tensor(data), torch.tensor([[1, 2, 3], [2, 3, 1]]),
        torch.tensor([2, 4]), torch.tensor([3, 3]))
    np.testing.assert_allclose(t_out[0], want.numpy(), rtol=1e-6)
    assert t_out[0][0] >= 1e10 - 1      # 3 labels cannot fit in 2 frames


def test_count_sketch_hashes_take_the_divisors_sign():
    """A negative hash lands at ``h mod out_dim`` in [0, out_dim), as
    ``jnp``'s ``%`` puts it; a fractional one is truncated first."""
    op = mxt.ops.get_op("count_sketch")
    data, h, s = (np.ones((1, 4), F32),
                  np.array([[-1.0, -5.0, -2.7, 6.0]], F32),
                  np.array([[1.0, 2.0, 4.0, 8.0]], F32))
    out = op.forward(op.normalize_attrs({"out_dim": 4}),
                     [torch.tensor(a) for a in (data, h, s)], [], False,
                     None)[0][0]
    jop = mxj.ops.get_op("count_sketch")
    want = jop.forward(jop.normalize_attrs({"out_dim": 4}),
                       [jnp.asarray(a) for a in (data, h, s)], [], False,
                       None)[0][0]
    assert out.tolist() == np.asarray(want).tolist() == \
        [[0.0, 0.0, 12.0, 3.0]]


# --------------------------------------------------------------------------
# the detection augmenters and ImageDetIter
# --------------------------------------------------------------------------
def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    images = [rs.randint(0, 255, (size + 3 * i, size, 3)).astype(np.uint8)
              for i in range(n)]
    labels = [np.array([[i % 2, 0.1, 0.2, 0.6, 0.7],
                        [1, 0.4, 0.3, 0.9, 0.95]][: 1 + i % 2], F32)
              for i in range(n)]
    return images, labels


def _seeded(seed):
    random.seed(seed)
    np.random.seed(seed)


AUGS = {
    "flip": lambda im: im.DetHorizontalFlipAug(1.0),
    "crop": lambda im: im.DetRandomCropAug(min_object_covered=0.5,
                                           area_range=(0.3, 0.9)),
    "pad": lambda im: im.DetRandomPadAug(area_range=(1.5, 2.5)),
    "resize": lambda im: im.DetResizeAug((20, 14)),
}


@pytest.mark.parametrize("aug", list(AUGS))
def test_det_augmenter_matches_jax(aug):
    images, labels = _images(6, 24, 3)
    outs = []
    for im in (mxj.image, mxt.image):
        _seeded(5)
        fn = AUGS[aug](im)
        outs.append([fn(img, lab.copy()) for img, lab in zip(images,
                                                             labels)])
    for (ji, jl), (ti, tl) in zip(*outs):
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
        assert np.asarray(ti).dtype == np.asarray(ji).dtype
        np.testing.assert_array_equal(tl, jl)


def _iters(im, images, labels, **kw):
    shape = (3, 16, 20)
    aug = im.CreateDetAugmenter(shape, rand_crop=0.5, rand_pad=0.5,
                                rand_mirror=True, brightness=0.2,
                                contrast=0.2, saturation=0.2, pca_noise=0.1,
                                mean=True, std=True, **kw)
    return im.ImageDetIter(3, shape, images, labels, shuffle=True,
                           aug_list=aug, max_objects=3)


def test_det_iter_matches_jax():
    """Two epochs of shuffled, augmented batches (crop, pad, mirror, colour
    jitter, PCA lighting, normalization; the last batch padded) from the
    same seeds: the same data, labels and pads bit for bit, on the CPU."""
    images, labels = _images(7, 24, 4)
    runs = []
    for im in (mxj.image, mxt.image):
        _seeded(11)
        it = _iters(im, images, labels)
        batches = []
        for _ in range(2):
            it.reset()
            batches += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it]
        runs.append((batches, [tuple(d) for d in it.provide_data],
                     [tuple(d) for d in it.provide_label]))
    it.reset()
    assert next(it).data[0].context == mxt.cpu()
    (jb, jd, jl), (tb, td, tl) = runs
    assert (jd, jl) == (td, tl) and len(jb) == len(tb) == 6
    for (jx, jy, jp), (tx, ty, tp) in zip(jb, tb):
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype and jp == tp
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert tb[-1][2] == 2


def test_det_iter_refuses_record_io_and_resize_needs_cv2_or_pil(
        monkeypatch):
    """RecordIO packs come with the record-IO slice, named in the error;
    the shorter-edge resize without cv2 and PIL raises PIL's ImportError
    in both packages."""
    with pytest.raises(mxt.base.MXNetError, match="A7"):
        mxt.image.ImageDetIter(2, (3, 8, 8), path_imgrec="x.rec")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((10, 12, 3), np.uint8)
    lab = np.array([[0, 0.1, 0.1, 0.5, 0.5]], F32)
    for im in (mxj.image, mxt.image):
        aug = im.CreateDetAugmenter((3, 8, 8), resize=8)[0]
        with pytest.raises(ImportError):
            aug(img, lab)
