"""DCGAN's adversarial training (``examples/dcgan.py``) through two Modules,
the port against the JAX package on the CPU.

* ``chip_smoke.py`` keeps its own copy of the example's two graph builders
  (it may not import the example, which imports the JAX package); their
  ``tojson()`` equals the example's.
* Two iterations of the example's loop (``chip_smoke.dcgan_iteration``,
  run with either package as ``mx``) at ngf = ndf = 8, batch 4, from the
  same parameters, noise and real images: the fakes and the
  discriminator's outputs within 2e-5, the discriminator's moving
  statistics within 1e-6, the ``CustomMetric``'s accuracy equal; every
  parameter after the updates within 2 lr + 1e-6, and the share of a
  module's elements past 1e-6 within chip_smoke's limit against the
  port's own share from parameters one float32 ulp away (Adam's first
  step is +-lr wherever |g| >> eps, so an element whose gradient lies
  near eps moves by what float32 noise in its gradient decides).
* The generator's outputs are read between its forward and its backward,
  and the JAX package's Executor then moves BatchNorm's moving statistics
  a second time (ROADMAP.md §C); the port moves them once. The test holds
  the port to one update and the JAX package to two, from the batch
  statistics the port's update implies.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj

import mxnet_tpu_torch as mxt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

NGF = NDF = 8
CODE, BATCH, ITERS = 100, 4, 2
MOMENTUM = 0.9          # BatchNorm's default
OUT_TOL, PARAM_ATOL = 2e-5, 1e-6


def _example():
    spec = importlib.util.spec_from_file_location(
        "dcgan_example", os.path.join(ROOT, "examples", "dcgan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("width", [8, 32, 64])
def test_chip_smoke_builders_are_the_examples(width):
    ex = _example()
    with mxj.name.NameManager():
        want = (ex.make_generator(ngf=width).tojson(),
                ex.make_discriminator(width).tojson())
    with mxt.name.NameManager():
        got = (cs.dcgan_generator(mxt.sym, width).tojson(),
               cs.dcgan_discriminator(mxt.sym, width).tojson())
    assert got == want


def _state(mod):
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


@pytest.fixture(scope="module")
def runs():
    """Both packages through ITERS iterations from the same Normal(0.02)
    parameters (drawn by the port from a seeded generator): per package
    the fakes and the discriminator's outputs of each iteration, the
    generator's moving statistics after each, the final states and the
    metric."""
    init = cs.dcgan_modules(mxt, mxt.cpu(), BATCH, NGF, NDF, CODE,
                            rng=torch.Generator().manual_seed(1))
    params = [_state(m) for m in init]
    rs = np.random.RandomState(0)
    noise = [rs.randn(BATCH, CODE, 1, 1).astype(np.float32)
             for _ in range(ITERS)]
    real = [cs.real_blobs(rs, BATCH) for _ in range(ITERS)]
    out = {"params": params}
    for name, mx, start in (("jax", mxj, params), ("port", mxt, params),
                            ("ulp", mxt, cs._one_ulp(params, 5))):
        ctx = mx.cpu()
        mods = cs.dcgan_modules(mx, ctx, BATCH, NGF, NDF, CODE,
                                params=start)
        labels = (mx.nd.ones((BATCH, 1), ctx=ctx),
                  mx.nd.zeros((BATCH, 1), ctx=ctx))
        metric = cs.dcgan_metric(mx)
        outs, g_aux = [], []
        for z, x in zip(noise, real):
            fake, d_outs = cs.dcgan_iteration(
                mx, *mods, mx.nd.array(z, ctx=ctx), mx.nd.array(x, ctx=ctx),
                labels, metric)
            outs.append([o.asnumpy() for o in [fake] + d_outs])
            g_aux.append(_state(mods[0])[1])
        out[name] = {"outputs": outs, "g_aux": g_aux,
                     "state": [_state(m) for m in mods],
                     "metric": metric.get()}
    return out


def test_outputs_agree(runs):
    for it, (want, got) in enumerate(zip(runs["jax"]["outputs"],
                                         runs["port"]["outputs"])):
        for k, (a, b) in enumerate(zip(want, got)):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=OUT_TOL, atol=OUT_TOL,
                                       err_msg=f"iteration {it} output {k}")
    assert runs["port"]["metric"][0] == "dacc"
    assert runs["port"]["metric"] == runs["jax"]["metric"]


def _past(a, b):
    """(elements of ``a`` more than PARAM_ATOL from ``b``, elements)."""
    return (sum(int((np.abs(a[k] - v) > PARAM_ATOL).sum())
                for k, v in b.items()), sum(v.size for v in b.values()))


@pytest.mark.parametrize("module", [0, 1], ids=["generator", "discriminator"])
def test_parameters_agree_after_the_updates(runs, module):
    want, got = runs["jax"]["state"][module][0], \
        runs["port"]["state"][module][0]
    start = runs["params"][module][0]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(w - start[k]).max() > 0, k       # the updates moved it
        assert np.abs(got[k] - w).max() <= \
            2 * cs.GAN_ADAM["learning_rate"] + PARAM_ATOL, k
    past, n = _past(got, want)
    ulp_past, _ = _past(runs["ulp"]["state"][module][0], got)
    assert past / n <= cs.GAN_SPREAD * ulp_past / n + cs.GAN_FLIP_FLOOR, \
        (past, ulp_past, n)


def test_discriminator_moving_statistics_agree(runs):
    want, got = runs["jax"]["state"][1][1], runs["port"]["state"][1][1]
    assert sorted(got) == sorted(want) and len(want) == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_generator_moving_statistics_follow_the_single_update(runs):
    """The port: ``P_t = m P_{t-1} + (1 - m) b_t`` once an iteration. The
    JAX package, whose outputs were read before its backward: ``J_t = m
    (m J_{t-1} + (1 - m) b_t) + (1 - m) b_t``, with the same batch
    statistics b_t (training-mode BatchNorm normalizes by b_t, so the
    outputs and gradients do not see the moving statistics)."""
    m = MOMENTUM
    prev_p = prev_j = runs["params"][0][1]
    checked = 0
    for p, j in zip(runs["port"]["g_aux"], runs["jax"]["g_aux"]):
        for k in p:
            b = (p[k].astype(np.float64) - m * prev_p[k]) / (1 - m)
            want_j = m * m * prev_j[k] + (1 - m) * (1 + m) * b
            np.testing.assert_allclose(j[k], want_j, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            assert np.abs(j[k] - p[k]).max() > 1e-4, k    # they do differ
            checked += 1
        prev_p, prev_j = p, j
    assert checked == ITERS * 6
