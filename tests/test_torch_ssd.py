"""SSD's detection training (``examples/ssd``) through ``Module``, the port
against the JAX package on the CPU.

* ``chip_smoke.py`` keeps its own copies of the example's pieces (it may
  not import the example, which imports the JAX package): the train and
  detect symbols (their ``tojson()`` equals the example's at widths 8, 16
  and 32), ``make_shapes_dataset`` (the same arrays from the same
  ``RandomState``), ``MultiBoxMetric`` (the same readings of the same
  outputs) and ``build_iters`` (the port's iterators give the example's
  batches bit for bit under the same seeds).
* Two ``Module`` steps (``forward_backward``, ``update``) of the training
  graph at 32 pixels, width 8, batch 4, SGD lr 0.01, momentum 0.9, wd
  5e-4, from the same parameters and batches: each step's three outputs
  within 2e-5 (the class targets exactly), every parameter and moving
  statistic after each step within 1e-6 (``tests/test_torch_dcgan.py``'s
  parameter bound; SGD has no sign flip to allow for). Before it holds
  the steps, the test checks that the hardness at the hard-negative cutoff
  is more than 8 float32 ulps from the next one: the two packages'
  softmaxes differ in ulps, and a nearer tie would move an anchor between
  ignored and negative. This seed's two steps have gaps of 1.6e-3 and
  1.1e-2.
"""
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.contrib import ops as tops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from examples.ssd import data as ex_data  # noqa: E402
from examples.ssd import symbol as ex_symbol  # noqa: E402
from examples.ssd import train as ex_train  # noqa: E402

OUT_TOL, PARAM_ATOL = 2e-5, 1e-6
ARGS = types.SimpleNamespace(epochs=1, batch_size=4, num_images=8,
                             data_size=32, width=8, lr=0.01, log_every=1)
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}
#: the least relative gap at the hard-negative cutoff a step may have: 8
#: float32 ulps (the two packages' hardness of the same scores differ by a
#: few)
GAP = 8 * 2.0 ** -23


@pytest.mark.parametrize("width", [8, 16, 32])
def test_chip_smoke_builders_are_the_examples(width):
    with mxj.name.NameManager():
        want = (ex_symbol.get_train_symbol(2, width).tojson(),
                ex_symbol.get_detect_symbol(2, width).tojson())
    with mxt.name.NameManager():
        got = (cs.ssd_train_symbol(mxt.sym, 2, width).tojson(),
               cs.ssd_detect_symbol(mxt.sym, 2, width).tojson())
    assert got == want


def test_dataset_and_metric_are_the_examples():
    want = ex_data.make_shapes_dataset(9, size=40,
                                       rng=np.random.RandomState(3))
    got = cs.shapes_dataset(9, size=40, rng=np.random.RandomState(3))
    for w, g in zip(want, got):
        assert len(w) == len(g) == 9
        for a, b in zip(w, g):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    rs = np.random.RandomState(4)
    prob = rs.dirichlet(np.ones(3), (2, 7)).transpose(0, 2, 1).astype(
        np.float32)
    loss = rs.uniform(0, 1, (2, 28)).astype(np.float32)
    label = rs.randint(-1, 3, (2, 7)).astype(np.float32)
    jm, tm = ex_train.MultiBoxMetric(), cs.ssd_metric(mxt)
    for _ in range(2):
        jm.update([], [mxj.nd.array(a) for a in (prob, loss, label)])
        tm.update([], [mxt.nd.array(a, ctx=mxt.cpu())
                       for a in (prob, loss, label)])
    assert tm.get() == jm.get()
    tm.reset()
    assert tm.get() == (["cross_entropy", "smooth_l1"], [0.0, 0.0])


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def test_iterators_are_the_examples():
    """The example's ``build_iters`` on the JAX package against the copy on
    the port: every batch of two epochs of each, bit for bit."""
    runs = []
    for build in (lambda: ex_train.build_iters(
            ARGS, rng=np.random.RandomState(5)),
            lambda: cs.ssd_iters(mxt, ARGS, rng=np.random.RandomState(5))):
        _seed(6)
        train, val = build()
        epochs = []
        for _ in range(2):
            train.reset()
            epochs += _batches(train)
        runs.append(epochs + _batches(val))
    assert len(runs[0]) == len(runs[1]) == 5
    for (jx, jy, jp), (tx, ty, tp) in zip(*runs):
        assert jp == tp and tx.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def _hardness_gap(anchors, prob, label):
    """The smallest relative gap between the hardness of the last anchor
    the hard-negative mining keeps and the first it leaves, over the
    batch (inf where it keeps every candidate or none), from the class
    probabilities ``prob`` (N, C + 1, A) of the step (the class head's
    output: ``MultiBoxTarget``'s softmax of the same scores)."""
    a = torch.tensor(anchors).reshape(-1, 4)
    lab = torch.tensor(label)
    valid = lab[..., 0] >= 0
    ious = tops._iou(a[None], lab[..., 1:5]) * valid[:, None, :].float()
    best_iou, _ = tops._first_argmax(ious, 2)
    _, best_anchor = tops._first_argmax(ious, 1)
    pos = (best_iou >= 0.5) | tops.forced_matches(best_anchor, valid,
                                                  a.shape[0])
    cand = (~pos) & (best_iou < 0.5)
    hard = -torch.log(torch.tensor(prob)[:, 0] + 1e-12)
    gap = float("inf")
    for n in range(lab.shape[0]):
        h = torch.sort(hard[n][cand[n]], descending=True).values
        k = int(3 * int(pos[n].sum()))
        if 0 < k < len(h):
            gap = min(gap, float((h[k - 1] - h[k]) / h[k - 1].abs()))
    return gap


def _anchors(shape):
    """The train symbol's anchors at data ``shape`` (they depend on the
    shape alone, and are the same bits in both packages)."""
    sym = cs.ssd_train_symbol(mxt.sym, 2, ARGS.width)
    ex = sym.get_internals()["anchors_output"].simple_bind(
        ctx=mxt.cpu(), grad_req="null", data=shape)
    return ex.forward(is_train=False)[0].asnumpy()


def _steps(lib, ctx, params, batches):
    """Two steps of the train symbol on ``lib`` from ``params`` (arg, aux
    numpy dicts) over ``batches``: per step the three outputs and the
    parameters after it, as numpy."""
    sym = cs.ssd_train_symbol(lib.sym, 2, ARGS.width)
    mod = lib.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=ctx)
    mod.bind([("data", batches[0][0].shape)],
             [("label", batches[0][1].shape)], for_training=True)
    mod.init_params(arg_params={k: lib.nd.array(v, ctx=ctx)
                                for k, v in params[0].items()},
                    aux_params={k: lib.nd.array(v, ctx=ctx)
                                for k, v in params[1].items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    out = []
    for x, y, _ in batches:
        mod.forward_backward(lib.io.DataBatch([lib.nd.array(x, ctx=ctx)],
                                              [lib.nd.array(y, ctx=ctx)]))
        mod.update()
        args, auxs = mod.get_params()
        out.append(([o.asnumpy() for o in mod.get_outputs()],
                    {k: v.asnumpy() for k, v in list(args.items()) +
                     list(auxs.items())}))
    return out


def test_two_module_steps_match_jax():
    _seed(7)
    train, _ = cs.ssd_iters(mxt, ARGS, rng=np.random.RandomState(8))
    batches = _batches(train)[:2]
    mxt.random.seed(1)
    init = mxt.mod.Module(cs.ssd_train_symbol(mxt.sym, 2, ARGS.width),
                          data_names=("data",), label_names=("label",),
                          context=mxt.cpu())
    init.bind([("data", batches[0][0].shape)],
              [("label", batches[0][1].shape)])
    init.init_params(mxt.initializer.Xavier())
    params = tuple({k: v.asnumpy() for k, v in d.items()}
                   for d in init.get_params())
    want = _steps(mxj, mxj.cpu(), params, batches)
    anchors = _anchors(batches[0][0].shape)
    gaps = [_hardness_gap(anchors, outs[0], y)
            for (outs, _), (_, y, _) in zip(want, batches)]
    assert min(gaps) > GAP, ("a near-tie at the cutoff", gaps)
    got = _steps(mxt, mxt.cpu(), params, batches)
    for step, ((w_out, w_par), (g_out, g_par)) in enumerate(
            zip(want, got)):
        for i, (a, b) in enumerate(zip(w_out, g_out)):
            assert a.shape == b.shape, (step, i)
            if i == 2:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=OUT_TOL, atol=OUT_TOL,
                                           err_msg=f"step {step} out {i}")
        assert sorted(g_par) == sorted(w_par)
        for k, a in w_par.items():
            np.testing.assert_allclose(g_par[k], a, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"step {step} {k}")
    moved = max(float(np.abs(got[-1][1][k] - v).max())
                for k, v in params[0].items())
    assert moved > 1e-3
