"""``export_model`` / ``Predictor`` and ``PredictorEngine`` in the port,
held to the JAX package's ``Predictor`` on the same parameters and inputs.

The port's artifact is its own (the JAX ``.mxp`` holds a StableHLO
program; the port's zip holds the symbol, ``"program": "symbol"`` in the
manifest), so each case exports the same graph and parameters from both
packages and compares the two Predictors' outputs:

* float32 (an MLP with a softmax head; its label zero-filled);
* ``quantize="int8"`` and ``"fp8"`` on a conv + dense net, within
  ``quant.INT8_TOL`` / ``FP8_TOL`` of the float export and close to the
  JAX package's quantized export;
* ``compute_dtype`` bfloat16, at bfloat16 tolerance;
* integer ``data_dtypes`` (embedding ids past 256);
* ``batch_forward`` over a ragged row count;
* a two-layer ``per_slot`` decode artifact: step by step, then
  ``reset_slot`` and ``reset_state``.

A JAX ``.mxp`` given to the port's ``Predictor`` raises naming its format,
and ``PredictorEngine`` serves the port's artifact through
``InferenceServer.register(predictor=path)`` with no build after warmup.
"""
import json
import zipfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch.ops import quant as tquant

CPU = mxt.cpu()
TOL = {"rtol": 1e-5, "atol": 1e-6}
BF16_TOL = {"rtol": 2e-2, "atol": 2e-2}


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=16, name="fc1"), act_type="relu")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        h, num_hidden=5, name="fc2"), name="softmax")


def _convnet(pkg):
    data = pkg.sym.var("data")
    c = pkg.sym.Activation(pkg.sym.Convolution(
        data, kernel=(3, 3), num_filter=8, pad=(1, 1), name="conv1"),
        act_type="relu")
    f = pkg.sym.Flatten(c)
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        f, num_hidden=6, name="fc"), name="softmax")


def _params(sym, shapes, seed, scale=0.3):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (scale * rs.randn(*s) + n.endswith("gamma")).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes and not n.endswith("label")}


def _export_both(tmp_path, make, shapes, params, aux=None, tag="m", **kw):
    """The same graph and parameters through both packages' export;
    returns (JAX Predictor, port Predictor)."""
    jpath, tpath = str(tmp_path / f"{tag}.mxp"), str(tmp_path / f"{tag}.mxt")
    mx.export_model(jpath, make(mx),
                    {k: mx.nd.array(v) for k, v in params.items()},
                    {k: mx.nd.array(v) for k, v in (aux or {}).items()},
                    shapes, **kw)
    mxt.export_model(tpath, make(mxt),
                     mxt.convert.params_from_numpy(params, CPU),
                     mxt.convert.params_from_numpy(aux or {}, CPU),
                     shapes, **kw)
    return mx.Predictor(jpath), mxt.Predictor(tpath, device=CPU), tpath


def _np(outs):
    return [o.asnumpy() for o in outs]


def test_float32_matches_jax_and_manifest(tmp_path):
    shapes = {"data": (8, 12)}
    params = _params(_mlp(mxt), shapes, 0)
    jp, tp, tpath = _export_both(tmp_path, _mlp, shapes, params)
    x = np.random.RandomState(1).rand(8, 12).astype("f")
    for g, w in zip(_np(tp.forward(data=x)), _np(jp.forward(data=x))):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(tp.get_output(0).asnumpy(),
                                  tp.forward(data=x)[0].asnumpy())
    with zipfile.ZipFile(tpath) as z:
        assert sorted(z.namelist()) == ["manifest.json", "symbol.json",
                                        "weights.params"]
        man = json.loads(z.read("manifest.json"))
    assert man["program"] == "symbol" and man["format_version"] == 1
    assert man["param_names"][-1] == "softmax_label"      # zero-filled
    assert (tp.output_names, tp.input_shapes, tp.quantize, tp.stateful) == \
        (jp.output_names, jp.input_shapes, None, False)
    with pytest.raises(mxt.MXNetError, match="shape"):
        tp.forward(data=np.zeros((4, 12), "f"))
    with pytest.raises(mxt.MXNetError, match="missing input"):
        tp.forward()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_matches_jax(tmp_path, mode):
    shapes = {"data": (4, 3, 6, 6)}
    params = _params(_convnet(mxt), shapes, 2)
    jp, tp, _ = _export_both(tmp_path, _convnet, shapes, params,
                             quantize=mode, tag=mode)
    _, tfloat, _ = _export_both(tmp_path, _convnet, shapes, params,
                                tag="f" + mode)
    x = np.random.RandomState(3).rand(*shapes["data"]).astype("f")
    got = tp.forward(data=x)[0].asnumpy()
    tol = tquant.INT8_TOL if mode == "int8" else tquant.FP8_TOL
    np.testing.assert_allclose(got, jp.forward(data=x)[0].asnumpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tfloat.forward(data=x)[0].asnumpy(),
                               **tol)
    assert tp.quantize == mode
    assert tp._manifest["quantized_weights"] == \
        jp._manifest["quantized_weights"] == ["conv1_weight", "fc_weight"]


def test_bf16_compute_matches_jax(tmp_path):
    shapes = {"data": (8, 12)}
    params = _params(_mlp(mxt), shapes, 4)
    jp, tp, _ = _export_both(tmp_path, _mlp, shapes, params,
                             compute_dtype="bfloat16")
    x = np.random.RandomState(5).rand(8, 12).astype("f")
    out = tp.forward(data=x)[0]
    assert out.astorch().dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(),
                               np.asarray(jp.forward(data=x)[0].asnumpy(),
                                          np.float32), **BF16_TOL)
    assert tp._manifest["compute_dtype"] == "bfloat16"


def test_integer_ids_round_trip(tmp_path):
    """An embedding model exported with int32 ids past 256 (exact in
    neither 16-bit float) answers the JAX package's rows."""
    def emb(pkg):
        return pkg.sym.Embedding(pkg.sym.var("data"), input_dim=600,
                                 output_dim=4, name="embed")
    w = np.random.RandomState(6).randn(600, 4).astype("f")
    jp, tp, _ = _export_both(tmp_path, emb, {"data": (2, 3)},
                             {"embed_weight": w},
                             data_dtypes={"data": np.int32})
    ids = np.array([[0, 257, 599], [511, 300, 1]], np.int32)
    assert tp.input_dtypes == {"data": np.dtype("int32")}
    np.testing.assert_array_equal(tp.forward(data=ids)[0].asnumpy(),
                                  jp.forward(data=ids)[0].asnumpy())
    np.testing.assert_array_equal(tp.forward(data=ids)[0].asnumpy(), w[ids])


def test_batch_forward_ragged_rows(tmp_path):
    shapes = {"data": (4, 12)}
    params = _params(_mlp(mxt), shapes, 7)
    jp, tp, _ = _export_both(tmp_path, _mlp, shapes, params)
    x = np.random.RandomState(8).rand(11, 12).astype("f")
    got = tp.batch_forward(data=x)[0].asnumpy()
    assert got.shape == (11, 5)
    np.testing.assert_allclose(got, jp.batch_forward(data=x)[0].asnumpy(),
                               **TOL)
    one = tp.batch_forward(data=x[:3])[0].asnumpy()
    np.testing.assert_allclose(one, got[:3], **TOL)


def test_per_slot_decode_artifact_matches_jax(tmp_path):
    """A two-layer slot-pooled decode artifact: the port's Predictor
    carries the pooled cache step for step like the JAX package's; one
    slot rewound with ``reset_slot`` restarts from position 0 while its
    batchmates go on; ``reset_state`` rewinds all."""
    V, D, L, H, T, slots = 64, 32, 2, 4, 16, 3

    def dec(pkg):
        tfm = jtfm if pkg is mx else ttfm
        return tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                     n_head=H, capacity=T, per_slot=True,
                                     max_seq_len=T)
    params = _params(dec(mxt), {"data": (slots, 1)}, 9)
    jp, tp, _ = _export_both(tmp_path, dec, {"data": (slots, 1)}, params,
                             data_dtypes={"data": np.int32}, tag="dec")
    assert tp.stateful and jp.stateful
    toks = np.random.RandomState(10).randint(0, V, (slots, 7)) \
        .astype(np.int32)

    def step(t):
        g = tp.forward(data=t)[0].asnumpy()
        np.testing.assert_allclose(g, jp.forward(data=t)[0].asnumpy(),
                                   rtol=1e-5, atol=2e-6)
        return g
    first = [step(toks[:, t:t + 1]) for t in range(4)]
    tp.reset_slot(1)
    jp.reset_slot(1)
    step(toks[:, 4:5])
    tp.reset_state()
    jp.reset_state()
    again = step(toks[:, 0:1])
    np.testing.assert_array_equal(again, first[0])


def test_jax_artifact_raises_naming_its_format(tmp_path):
    shapes = {"data": (2, 12)}
    params = _params(_mlp(mxt), shapes, 11)
    jpath = str(tmp_path / "j.mxp")
    mx.export_model(jpath, _mlp(mx),
                    {k: mx.nd.array(v) for k, v in params.items()}, {},
                    shapes)
    with pytest.raises(mxt.MXNetError, match="StableHLO"):
        mxt.Predictor(jpath, device=CPU)


def test_predictor_defaults_to_the_card(tmp_path):
    """With no device the Predictor binds the current context, gpu(0):
    on a host without CUDA it raises instead of running there."""
    shapes = {"data": (2, 12)}
    path = str(tmp_path / "m.mxt")
    mxt.export_model(path, _mlp(mxt), mxt.convert.params_from_numpy(
        _params(_mlp(mxt), shapes, 12), CPU), {}, shapes)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default binds it")
    with pytest.raises(mxt.MXNetError, match="needs CUDA"):
        mxt.Predictor(path)
    with CPU:
        assert mxt.Predictor(path).context == CPU


def test_predictor_engine_serves_the_artifact(tmp_path):
    """``register(predictor=path)``: the exported batch is the ladder,
    requests pad into it, answers equal the Predictor's rows, and nothing
    is built after warmup; another ladder raises."""
    shapes = {"data": (4, 12)}
    params = _params(_mlp(mxt), shapes, 13)
    path = str(tmp_path / "m.mxt")
    mxt.export_model(path, _mlp(mxt),
                     mxt.convert.params_from_numpy(params, CPU), {}, shapes)
    clock = mxt.serve.FakeClock()
    server = mxt.serve.InferenceServer(clock=clock)
    eng = server.register("p", predictor=path, context=CPU)
    assert isinstance(eng, mxt.serve.PredictorEngine)
    assert eng.ladder.sizes == [4] and eng._path == path
    x = np.random.RandomState(14).rand(3, 12).astype("f")
    h = server.submit({"data": x}, model="p")
    clock.advance(1.0)
    assert server.pump() == 1
    want = mxt.Predictor(path, device=CPU).batch_forward(data=x)[0]
    np.testing.assert_array_equal(h.result(timeout=0)[0].asnumpy(),
                                  want.asnumpy())
    assert server.stats()["compiles_since_warmup"] == 0
    with pytest.raises(mxt.MXNetError, match="exported batch"):
        server.register("q", predictor=path, context=CPU, ladder=[1, 4])
    pred = mxt.Predictor(path, device=CPU)
    eng2 = server.register("r", predictor=pred)
    assert eng2._path == path
