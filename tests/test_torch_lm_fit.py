"""The LM-training slice as a whole: ``Module.fit`` of the transformer LM
in ``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU, at the CPU size
the JAX package's own LM bench row uses (V=128, d_model=64, 2 layers, 4
heads, T=32, batch 8).

* ``get_symbol`` gives the JAX package's JSON byte for byte (loss head,
  ``normalization``, learned positions, the loss-free graph), and
  ``dropout`` > 0 is refused;
* ``SyntheticLMIter`` yields the JAX iterator's batches, dtypes included;
* a 4-batch SGD fit from the same parameters (Xavier in the JAX package,
  carried across as numpy) leaves the same parameters in both packages,
  the tied embedding table included, with the JAX side lowered as its
  XLA composition and as its Pallas kernels (interpret mode); the
  ``learned`` position variant fits alike too;
* an LM checkpoint written by either package loads in the other, and the
  port resumes from it where an uninterrupted run would be.

Tolerance: 2e-5 absolute and relative after 4 steps (the two frameworks
sum the matmuls and the reductions in other orders).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import transformer as jtfm

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm

TOL = 2e-5
CPU = mxt.cpu()
V, D, L, H, T, B = 128, 64, 2, 4, 32, 8
SGD = (("learning_rate", 0.05),)


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def _jax_fit(n_batches=4, seed=0, **kw):
    """A JAX module Xavier-initialized, its starting parameters (numpy)
    and the module after fitting ``n_batches`` batches."""
    it = jtfm.SyntheticLMIter(V, B, T, n_batches, seed=seed)
    mod = mx.mod.Module(jtfm.get_symbol(V, D, L, H, T, **kw),
                        context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD)
    return start, mod


def _torch_fit(start, n_batches=4, seed=0, **kw):
    mod = mxt.mod.Module(ttfm.get_symbol(V, D, L, H, T, **kw), context=CPU)
    metric = mxt.metric.create("acc")
    mod.fit(ttfm.SyntheticLMIter(V, B, T, n_batches, seed=seed),
            num_epoch=1, optimizer="sgd", optimizer_params=SGD,
            eval_metric=metric,
            arg_params=mxt.convert.params_from_numpy(start, CPU))
    return mod, metric


def _assert_same_params(jmod, tmod, start=None):
    jargs, targs = jmod.get_params()[0], tmod.get_params()[0]
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        _close(jargs[k].asnumpy(), targs[k].asnumpy(), msg=k)
        if start is not None:       # every parameter trained
            assert np.abs(targs[k].asnumpy() - start[k]).max() > 0, k


@pytest.mark.parametrize("kwargs", [{}, {"pos_embed": "learned"},
                                    {"include_loss": False},
                                    {"normalization": "valid"}])
def test_lm_symbol_json_identical(kwargs):
    with mx.name.NameManager():
        js = jtfm.get_symbol(32000, 512, 8, 8, 1024, **kwargs).tojson()
    with mxt.name.NameManager():
        ts = ttfm.get_symbol(32000, 512, 8, 8, 1024, **kwargs).tojson()
    assert ts == js


def test_lm_get_symbol_defaults_and_refusals():
    sym = ttfm.get_symbol()
    assert sym.list_outputs() == ["softmax_output"]
    assert sym.list_arguments()[-1] == "softmax_label"
    with pytest.raises(MXNetError, match="Dropout"):
        ttfm.get_symbol(dropout=0.1)


def test_synthetic_lm_iter_matches_jax():
    jit = jtfm.SyntheticLMIter(V, B, T, 3, seed=7)
    tit = ttfm.SyntheticLMIter(V, B, T, 3, seed=7)
    assert [(d.name, d.shape) for d in tit.provide_data] == \
        [(d.name, d.shape) for d in jit.provide_data]
    assert tit.provide_data[0].dtype == np.int32
    assert [(d.name, d.shape) for d in tit.provide_label] == \
        [(d.name, d.shape) for d in jit.provide_label]
    for _epoch in range(2):
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            for x, y in ((a.data[0], b.data[0]), (a.label[0], b.label[0])):
                x, y = x.asnumpy(), y.asnumpy()
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        jit.reset()
        tit.reset()


def test_lm_fit_matches_jax(jax_tier):
    start, jmod = _jax_fit()
    tmod, metric = _torch_fit(start)
    _assert_same_params(jmod, tmod, start)
    assert metric.num_inst == 4 * B * T


def test_lm_learned_positions_fit_matches_jax():
    start, jmod = _jax_fit(seed=1, pos_embed="learned")
    assert "lm_pos_embed_weight" in start
    tmod, _ = _torch_fit(start, seed=1, pos_embed="learned")
    _assert_same_params(jmod, tmod, start)


def test_lm_checkpoint_round_trip(tmp_path):
    """The JAX package's LM checkpoint (tied table and all) loads into
    the port's training module, which resumes where the JAX run would;
    the port's checkpoint loads back into the JAX package unchanged."""
    start, jmod = _jax_fit(n_batches=2)
    jprefix = str(tmp_path / "jax_lm")
    jmod.save_checkpoint(jprefix, 1)
    it = jtfm.SyntheticLMIter(V, B, T, 2, seed=3)
    jmod.fit(it, num_epoch=2, begin_epoch=1, optimizer="sgd",
             optimizer_params=SGD)

    tmod = mxt.mod.Module.load(jprefix, 1, context=CPU)
    tmod.fit(ttfm.SyntheticLMIter(V, B, T, 2, seed=3), num_epoch=2,
             begin_epoch=1, optimizer="sgd", optimizer_params=SGD)
    _assert_same_params(jmod, tmod)

    tprefix = str(tmp_path / "torch_lm")
    tmod.save_checkpoint(tprefix, 2)
    jsym, jargs, _ = mx.model.load_checkpoint(tprefix, 2)
    assert jsym.tojson() == tmod.symbol.tojson()
    for k, v in tmod.get_params()[0].items():
        np.testing.assert_array_equal(jargs[k].asnumpy(), v.asnumpy(),
                                      err_msg=k)
