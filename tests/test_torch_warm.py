"""Serve warm restarts in the port, and across packages.

``InferenceServer.checkpoint_to(manager)`` commits the JAX package's
``kind="serve"`` payload (per model the symbol JSON, numpy params, per-row
shapes, label names, ladder, compute dtype — or an artifact path) through
``checkpoint/``; ``serve.restore_server(directory)`` registers every
model again and serves with no build after warmup. Both packages write
and read the same payload, so:

* a JAX server's commit (a float32 and an int8 model) restored by the
  port's ``restore_server`` answers the JAX server's requests within
  1e-5;
* the port's commit restores in the JAX package, the same;
* the port's own restart keeps a ``PredictorEngine`` (by its artifact's
  path), the server's settings, and ``compiles_since_warmup() == 0``;
  a training commit in the same directory is passed over, and an empty
  directory raises.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

CPU_J, CPU_T = mx.cpu(), mxt.cpu()
TOL = {"rtol": 1e-5, "atol": 1e-5}


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=16, name="fc1"), act_type="relu")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        h, num_hidden=5, name="fc2"), name="softmax")


def _params(seed):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": (0.3 * rs.randn(16, 12)).astype("f"),
            "fc1_bias": (0.1 * rs.randn(16)).astype("f"),
            "fc2_weight": (0.3 * rs.randn(5, 16)).astype("f"),
            "fc2_bias": (0.1 * rs.randn(5)).astype("f")}


def _register(pkg, server, name, params, compute_dtype=None):
    ctx = CPU_J if pkg is mx else CPU_T
    nd = {k: pkg.nd.array(v, ctx=ctx) for k, v in params.items()}
    server.register(name, symbol=_mlp(pkg), arg_params=nd, aux_params={},
                    data_shapes={"data": (12,)}, ladder=[1, 2, 4],
                    context=ctx, compute_dtype=compute_dtype)


def _server(pkg, max_queue=77):
    server = pkg.serve.InferenceServer(clock=pkg.serve.FakeClock(),
                                       max_queue=max_queue,
                                       default_deadline_ms=40)
    _register(pkg, server, "f32", _params(0))
    _register(pkg, server, "i8", _params(1), compute_dtype="int8")
    return server


def _answers(server, xs, model):
    clock = server._clock
    outs = []
    for x in xs:
        h = server.submit({"data": x}, model=model)
        clock.advance(1.0)
        server.pump()
        outs.append(h.result(timeout=0)[0].asnumpy())
    return outs


REQUESTS = [np.random.RandomState(i).rand(r, 12).astype("f")
            for i, r in enumerate((1, 3, 4))]


@pytest.fixture(scope="module")
def jax_commit(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jaxserve") / "ck")
    server = _server(mx)
    want = {m: _answers(server, REQUESTS, m) for m in ("f32", "i8")}
    server.checkpoint_to(d)
    return d, want


def test_jax_serve_commit_restores_in_the_port(jax_commit):
    d, want = jax_commit
    server = mxt.serve.restore_server(d, clock=mxt.serve.FakeClock(),
                                      context=CPU_T)
    assert sorted(server.models) == ["f32", "i8"]
    assert server.engine("i8").quantized is None     # already quantized
    for m in ("f32", "i8"):
        for g, w in zip(_answers(server, REQUESTS, m), want[m]):
            np.testing.assert_allclose(g, w, **TOL)
    assert server.stats()["compiles_since_warmup"] == 0
    assert server._max_queue == 77


def test_port_serve_commit_restores_in_jax(tmp_path, jax_commit):
    _, want = jax_commit
    d = str(tmp_path / "ck")
    server = _server(mxt)
    mine = {m: _answers(server, REQUESTS, m) for m in ("f32", "i8")}
    seq = server.checkpoint_to(d)
    assert mxt.checkpoint.latest_checkpoint(d)[0] == seq
    restored = mx.serve.restore_server(d, clock=mx.serve.FakeClock(),
                                       context=CPU_J)
    for m in ("f32", "i8"):
        for g, w, own in zip(_answers(restored, REQUESTS, m), want[m],
                             mine[m]):
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(own, w, **TOL)


def test_port_warm_restart_keeps_predictors_and_settings(tmp_path):
    """A port server with a bucket model and a Predictor model commits
    beside a training checkpoint; ``restore_server`` picks the serve
    commit, serves the same answers with nothing built after warmup."""
    d = str(tmp_path / "ck")
    path = str(tmp_path / "m.mxt")
    mxt.export_model(path, _mlp(mxt),
                     mxt.convert.params_from_numpy(_params(2), CPU_T), {},
                     {"data": (4, 12)})
    server = _server(mxt, max_queue=33)
    server.register("pred", predictor=path, context=CPU_T)
    want = _answers(server, REQUESTS, "pred")
    mgr = mxt.checkpoint.CheckpointManager(d)
    payload = mxt.serve.server_payload(server)
    assert payload["kind"] == "serve" and \
        payload["models"]["pred"] == {"type": "predictor", "path": path}
    server.checkpoint_to(mgr)
    # a training commit after it: restore_server passes it over
    mod = mxt.mod.Module(_mlp(mxt), context=CPU_T)
    mod.bind([("data", (4, 12))], [("softmax_label", (4,))])
    mod.init_params(mxt.initializer.Xavier())
    mod.init_optimizer()
    mgr.save(mod, 0, 1, block=True)
    mgr.close()
    restored = mxt.serve.restore_server(d, clock=mxt.serve.FakeClock(),
                                        context=CPU_T)
    assert restored._max_queue == 33
    assert isinstance(restored.engine("pred"), mxt.serve.PredictorEngine)
    for g, w in zip(_answers(restored, REQUESTS, "pred"), want):
        np.testing.assert_array_equal(g, w)
    assert restored.stats()["compiles_since_warmup"] == 0
    assert mxt.checkpoint.restore_module(mod, d) == \
        {"epoch": 0, "nbatch": 1}
    with pytest.raises(mxt.MXNetError, match="no committed serve state"):
        mxt.serve.restore_server(str(tmp_path / "empty"))
