"""The one-shot serving plane of ``mxnet_tpu_torch`` on the CPU.

The port's scheduler, batcher, registry, breaker and shedding are driven
as ``tests/test_serve.py`` and ``tests/test_faults.py`` drive the JAX
package's: a ``FakeClock`` and ``pump()``, scripted arrivals, no
wall-clock sleeps. A served response is bitwise-equal to a direct forward
of the same padded batch through a Module bound at the bucket size.

The quantized tiers are served as ``tests/test_quant.py`` serves them:
int8 and fp8 ladders build nothing after warmup and answer within
``INT8_TOL`` / ``FP8_TOL`` of the float ladder; ``MXNET_SERVE_QUANTIZE``
selects the tier.

Against the JAX package: both servers, fed the same scripted arrivals on
a FakeClock, make the same dispatches (bucket sequence, occupancy,
padding waste, deadline misses) and return per-request outputs within
2e-5 (float32 sums in other orders), in float32 and in int8.

What is not ported raises ``MXNetError``: ``.mxp`` artifacts
(``PredictorEngine``), warm restarts (``checkpoint_to``) and a
``compute_dtype`` that is not a quantization tier.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.faults import (CircuitBreaker, CircuitOpenError,
                                    InjectedFault)
from mxnet_tpu_torch.ops import quant
from mxnet_tpu_torch.serve import (BucketLadder, FakeClock, QueueFullError,
                                   ShedError, bucket_for, default_ladder,
                                   pad_rows, run_scripted, slice_rows)
from mxnet_tpu_torch.telemetry import metrics as _metrics

CPU = mx.cpu()
FEATS = 6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_SERVE_QUANTIZE", raising=False)
    faults.clear()
    yield
    faults.clear()


def _cval(name, **labels):
    m = _metrics.get_metric(name, **labels)
    return m.value if m is not None else 0


def _mlp(prefix="fc", hidden=8, classes=3, lib=mx):
    data = lib.sym.var("data")
    fc = lib.sym.FullyConnected(data=data, num_hidden=hidden,
                                name=f"{prefix}1")
    act = lib.sym.Activation(fc, act_type="relu")
    fc2 = lib.sym.FullyConnected(act, num_hidden=classes,
                                 name=f"{prefix}2")
    return lib.sym.SoftmaxOutput(fc2, name="softmax")


def _params(sym, feat=FEATS, seed=0):
    shapes, _, _ = sym.infer_shape(data=(1, feat))
    rs = np.random.RandomState(seed)
    return {n: (0.5 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _bound_module(sym, feat=FEATS, batch=4, params=None):
    mod = mx.mod.Module(sym, context=CPU)
    mod.bind([("data", (batch, feat))], [("softmax_label", (batch,))],
             for_training=False)
    mod.init_params(arg_params=mx.convert.params_from_numpy(
        params if params is not None else _params(sym, feat), CPU),
        aux_params={})
    return mod


def _direct_forward(sym, mod, x, bucket):
    """The oracle: the same rows padded to the bucket, through a Module
    bound at that batch size on the served parameters."""
    ref = mx.mod.Module(sym, context=CPU)
    ref.bind([("data", (bucket,) + x.shape[1:])], for_training=False,
             label_shapes=[("softmax_label", (bucket,))])
    ref.init_params(arg_params=mod.get_params()[0], aux_params={})
    ref.forward(mx.io.DataBatch([pad_rows(x, bucket)], None),
                is_train=False)
    return ref.get_outputs()[0].asnumpy()[:x.shape[0]]


def _serve(sym=None, **kw):
    sym = sym if sym is not None else _mlp()
    kw.setdefault("start", False)
    kw.setdefault("clock", FakeClock())
    return mx.serve.serve(_bound_module(sym), **kw)


# --------------------------------------------------------------- helpers
def test_pad_slice_roundtrip_and_ladder(monkeypatch):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = pad_rows(x, 8)
    assert p.shape == (8, 4) and np.array_equal(p[:3], x)
    assert not p[3:].any()
    assert np.array_equal(pad_rows(x, 3), x)
    back = slice_rows([torch.from_numpy(p)], 1, 2)[0].asnumpy()
    assert np.array_equal(back, x[1:3])
    lad = BucketLadder([8, 2, 4, 2])
    assert lad.sizes == [2, 4, 8] and lad.max == 8
    assert lad.bucket_for(1) == 2 and lad.bucket_for(9) is None
    assert bucket_for(3, [2, 4]) == 4
    with pytest.raises(MXNetError):
        pad_rows(x, 2)
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "4, 1,16")
    assert default_ladder() == [1, 4, 16]
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "zero")
    with pytest.raises(MXNetError):
        default_ladder()


# ------------------------------------------------- deterministic scheduler
def test_deadline_flush_fake_clock():
    clock = FakeClock()
    server = _serve(_mlp("dl"), ladder=[1, 2, 4], clock=clock,
                    default_deadline_ms=50)
    h = server.submit({"data": np.random.RandomState(0).rand(1, FEATS)})
    assert server.pump() == 0
    clock.advance(0.049)
    assert server.pump() == 0
    clock.advance(0.001)
    assert server.pump() == 1
    assert h.done() and h.bucket == 1
    assert h.latency == pytest.approx(0.050) and not h.missed_deadline()
    stats = server.stats()["models"]["default"]
    assert stats["deadline_misses"] == 0 and stats["dispatches"] >= 1


def test_full_bucket_flushes_immediately():
    server = _serve(_mlp("fb"), ladder=[2, 4], default_deadline_ms=1000)
    rs = np.random.RandomState(1)
    hs = [server.submit({"data": rs.rand(2, FEATS)}) for _ in range(2)]
    assert server.pump() == 1
    assert {h.bucket for h in hs} == {4}
    assert all(h.latency == 0.0 for h in hs)


def test_coalesced_batch_slices_per_request_bitwise():
    mx.telemetry.reset()
    clock = FakeClock()
    sym = _mlp("co")
    mod = _bound_module(sym)
    server = mx.serve.serve(mod, ladder=[1, 2, 4], start=False,
                            clock=clock, default_deadline_ms=10)
    rs = np.random.RandomState(2)
    x1, x2 = rs.rand(2, FEATS).astype("f"), rs.rand(1, FEATS).astype("f")
    h1, h2 = server.submit({"data": x1}), server.submit({"data": x2})
    clock.advance(0.010)
    assert server.pump() == 1
    assert h1.bucket == h2.bucket == 4
    ref = _direct_forward(sym, mod, np.concatenate([x1, x2]), 4)
    assert np.array_equal(h1.result()[0].asnumpy(), ref[:2])
    assert np.array_equal(h2.result()[0].asnumpy(), ref[2:3])
    stats = server.stats()["models"]["default"]
    assert stats["batch_occupancy"] == pytest.approx(0.75)
    assert stats["padding_waste_pct"] == pytest.approx(25.0)
    assert stats["latency_ms"]["p99"] is not None
    assert stats["programs_resident"] is True and stats["quantized"] is None


def test_fair_scheduling_round_robin():
    server = mx.serve.InferenceServer(clock=FakeClock())
    server.register("a", model=_bound_module(_mlp("fa")), ladder=[2])
    server.register("b", model=_bound_module(_mlp("fb2", hidden=5)),
                    ladder=[2])
    order, rs = [], np.random.RandomState(3)
    for name in ("a", "a", "b", "b"):
        h = server.submit({"data": rs.rand(2, FEATS)}, model=name)
        h.add_done_callback(lambda _h, name=name: order.append(name))
    assert server.pump() == 4
    assert order == ["a", "b", "a", "b"]
    assert server.models == ["a", "b"]


def test_queue_full_rejection():
    mx.telemetry.reset()
    server = _serve(_mlp("qf"), ladder=[1, 4], max_queue=2,
                    default_deadline_ms=1000)
    x = np.zeros((1, FEATS), np.float32)
    server.submit({"data": x})
    server.submit({"data": x})
    with pytest.raises(QueueFullError) as ei:
        server.submit({"data": x})
    assert ei.value.retry_after_ms >= 1
    assert server.stats()["models"]["default"]["rejected"] == 1


def test_submit_validation_errors():
    server = _serve(_mlp("va"), ladder=[1, 2])
    for bad in ({"data": np.zeros((1, 7))}, {"data": np.zeros((3, FEATS))},
                {"wrong": np.zeros((1, FEATS))}):
        with pytest.raises(MXNetError):
            server.submit(bad)
    with pytest.raises(MXNetError):
        server.submit({"data": np.zeros((1, FEATS))}, model="ghost")


def test_dispatch_error_fails_batch_not_server():
    mx.telemetry.reset()
    clock = FakeClock()
    server = _serve(_mlp("er"), ladder=[1], clock=clock,
                    default_deadline_ms=5)
    engine = server.engine()
    real_forward = engine.forward
    engine.forward = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected"))
    h_bad = server.submit({"data": np.zeros((1, FEATS), np.float32)})
    clock.advance(0.005)
    server.pump()
    with pytest.raises(RuntimeError, match="injected"):
        h_bad.result(timeout=1)
    engine.forward = real_forward
    h_ok = server.submit({"data": np.zeros((1, FEATS), np.float32)})
    clock.advance(0.005)
    server.pump()
    assert h_ok.result(timeout=1)[0].shape == (1, 3)
    assert server.stats()["models"]["default"]["errors"] == 1
    kinds = [r["kind"] for r in mx.telemetry.flightrec.get_records()]
    assert "serve.dispatch.error" in kinds and "serve.dispatch" in kinds


def test_stop_without_drain_fails_pending():
    server = _serve(_mlp("sp"), ladder=[4], default_deadline_ms=1000)
    h = server.submit({"data": np.zeros((1, FEATS), np.float32)})
    server.stop(drain=False)
    with pytest.raises(MXNetError, match="stopped"):
        h.result(timeout=1)


def test_scripted_arrivals_deterministic():
    def run(prefix):
        server = _serve(_mlp(prefix), ladder=[1, 2, 4],
                        default_deadline_ms=20)
        return run_scripted(server, [0.000, 0.004, 0.008, 0.030, 0.031],
                            lambda i, rng: {"data": rng.rand(1, FEATS)},
                            slo_ms=25)
    out = run("sc")
    assert out["offered"] == out["completed"] == 5
    assert out["errors"] == 0 and out["deadline_misses"] == 0
    assert out["latency_ms"]["p99"] == pytest.approx(20.0)
    assert out["p99_within_slo"] is True
    assert run("sc2")["latency_ms"] == out["latency_ms"]


def test_threaded_server_answers_concurrent_clients():
    """The dispatch thread against the real clock, two tenants, clients
    on their own threads: every response is the direct forward."""
    mx.telemetry.reset()
    syms = {"a": _mlp("ea"), "b": _mlp("eb", hidden=5, classes=2)}
    mods = {k: _bound_module(s) for k, s in syms.items()}
    server = mx.serve.InferenceServer(default_deadline_ms=20)
    for k, m in mods.items():
        server.register(k, model=m, ladder=[1, 2, 4])
    results, lock = [], threading.Lock()

    def client(cid):
        rs = np.random.RandomState(100 + cid)
        for j in range(3):
            name = "a" if (cid + j) % 2 == 0 else "b"
            x = rs.rand(1 + (cid + j) % 3, FEATS).astype(np.float32)
            h = server.submit({"data": x}, model=name)
            out = h.result(timeout=30)[0].asnumpy()
            with lock:
                results.append((name, x, out, h.bucket))

    with server:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 12
    for name, x, out, bucket in results:
        ref = _direct_forward(syms[name], mods[name], x, bucket)
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    stats = server.stats()
    assert stats["compiles_since_warmup"] == 0
    assert stats["models"]["a"]["responses"] == 6


def test_poisson_loadgen_and_unregister():
    """The open-loop generator against a started server (real clock,
    short), then unregistering a model fails its queued requests."""
    server = _serve(_mlp("po"), ladder=[1, 2, 4], clock=None, start=True,
                    default_deadline_ms=5)
    try:
        gen = mx.serve.PoissonLoadGen(
            server, lambda i, rng: {"data": rng.rand(1 + i % 3, FEATS)},
            rate=2000.0, n_requests=20, seed=4)
        out = gen.run(slo_ms=1000)
    finally:
        server.stop()
    assert out["completed"] == 20 and out["errors"] == 0
    assert out["rejected"] == 0 and out["p99_within_slo"] is True
    h = server.submit({"data": np.zeros((1, FEATS), np.float32)})
    server.unregister("default")
    with pytest.raises(MXNetError, match="unregistered"):
        h.result(timeout=1)
    assert server.models == []


def test_flight_recorder_crash_report(tmp_path):
    mx.telemetry.flightrec.configure(dump_dir=str(tmp_path))
    try:
        mx.telemetry.flightrec.note("serve.test", model="m")
        path = mx.telemetry.flightrec.dump_crash(
            exc=RuntimeError("boom"), where="test")
    finally:
        mx.telemetry.flightrec.configure(dump_dir=".")
    import json
    with open(path) as f:
        report = json.load(f)
    assert report["exception"]["message"] == "boom"
    assert report["backend"] in ("cpu", "cuda")
    assert isinstance(report["devices"], list) and "rank" in report
    assert any(r["kind"] == "serve.test" for r in report["ring"])
    assert all("rank" not in r for r in report["ring"])


# ------------------------------------------------- breaker, faults, shed
def test_breaker_state_machine():
    b = CircuitBreaker(threshold=2, cooldown_s=1.0, site="m")
    assert b.acquire(0.0)
    b.record_failure(0.0)
    assert b.state == "closed"
    assert b.acquire(0.1)
    b.record_failure(0.1)
    assert b.state == "open" and not b.acquire(0.5)
    assert not b.admit_allowed(0.5)
    assert b.retry_after(0.5) == pytest.approx(0.6)
    assert b.acquire(1.2) and b.state == "half_open"
    assert not b.acquire(1.3)
    b.record_failure(1.3)
    assert b.state == "open" and b.acquire(2.4)
    b.record_success(2.5)
    assert b.state == "closed" and b.consecutive_failures == 0


def _fire_pattern(spec, n=6):
    hits = []
    with faults.scope(f"p:{spec}"):
        for i in range(1, n + 1):
            try:
                faults.point("p")
            except Exception:
                hits.append(i)
    return hits


@pytest.mark.parametrize("spec,want", [
    ("nth=3", [3]), ("once", [1]), ("always", [1, 2, 3, 4, 5, 6]),
    ("nth=1,error=value", [1]), ("nth=6,msg=late", [6])])
def test_fault_trigger_grammar(spec, want):
    assert _fire_pattern(spec) == want


@pytest.mark.parametrize("bad", ["noseparator", "p:", "p:nth=0", "p:prob=2",
                                 "p:wat=1", "p:once;p:always",
                                 "p:once,error=bogus", "p:latency=xyz",
                                 "p:every=2", "p:first=2"])
def test_bad_fault_specs_raise(bad):
    with pytest.raises(MXNetError):
        faults.parse_spec(bad)


def test_fault_scope_kinds_and_counters():
    assert _fire_pattern("nth=2", 4) == _fire_pattern("nth=2", 4) == [2]
    before = _cval("faults.injected", point="p")
    with faults.scope("p:once,error=os,msg=disk full"):
        with pytest.raises(OSError, match="disk full") as ei:
            faults.point("p", extra="ctx")
        assert ei.value.mx_fault_point == "p" and faults.fired("p") == 1
    assert not faults.enabled()
    assert _cval("faults.injected", point="p") == before + 1
    rec = [r for r in mx.telemetry.flightrec.get_records()
           if r["kind"] == "fault.injected"][-1]
    assert rec["point"] == "p" and rec["extra"] == "ctx"


def test_serve_dispatch_transient_failure_keeps_serving():
    clock = FakeClock()
    server = _serve(_mlp("sv"), ladder=[1, 2], clock=clock,
                    default_deadline_ms=50)
    x = np.random.RandomState(0).rand(1, FEATS).astype("f")
    errors_before = _cval("serve.errors", model="default")
    with faults.scope("serve.dispatch:nth=1"):
        h1 = server.submit({"data": x})
        clock.advance(0.06)
        server.pump()
        assert isinstance(h1.exception(), InjectedFault)
        h2 = server.submit({"data": x})
        clock.advance(0.06)
        server.pump()
    assert h2.exception() is None
    assert _cval("serve.errors", model="default") == errors_before + 1
    assert server._registry.entry("default").breaker.state == "closed"


def test_serve_breaker_opens_probes_and_recovers():
    clock = FakeClock()
    server = _serve(_mlp("bk"), ladder=[1, 2], clock=clock,
                    default_deadline_ms=50, breaker_threshold=2,
                    breaker_cooldown_ms=1000)
    x = np.random.RandomState(0).rand(1, FEATS).astype("f")
    entry = server._registry.entry("default")
    with faults.scope("serve.dispatch:always"):
        for _ in range(2):
            h = server.submit({"data": x})
            clock.advance(0.06)
            server.pump()
            assert isinstance(h.exception(), InjectedFault)
    assert entry.breaker.state == "open"
    with pytest.raises(CircuitOpenError) as ei:
        server.submit({"data": x})
    assert 0 < ei.value.retry_after_ms <= 1000
    assert _metrics.get_metric("serve.breaker.state",
                               model="default").value == 2
    clock.advance(1.0)
    h = server.submit({"data": x})
    clock.advance(0.06)
    assert server.pump() == 1
    assert h.exception() is None and entry.breaker.state == "closed"
    assert server.stats()["models"]["default"]["breaker"] == "closed"


def test_serve_breaker_failed_probe_reopens():
    clock = FakeClock()
    server = _serve(_mlp("bk2"), ladder=[1], clock=clock,
                    default_deadline_ms=50, breaker_threshold=1,
                    breaker_cooldown_ms=500)
    x = np.random.RandomState(0).rand(1, FEATS).astype("f")
    entry = server._registry.entry("default")
    with faults.scope("serve.dispatch:always"):
        server.submit({"data": x})
        clock.advance(0.06)
        server.pump()
        assert entry.breaker.state == "open"
        clock.advance(0.5)
        h2 = server.submit({"data": x})
        clock.advance(0.06)
        server.pump()
        assert isinstance(h2.exception(), InjectedFault)
    assert entry.breaker.state == "open"
    assert entry.breaker.retry_after(clock.now()) > 0


def test_serve_admit_fault_rejects_at_submit():
    server = _serve(_mlp("ad"), ladder=[1])
    with faults.scope("serve.admit:once"):
        with pytest.raises(InjectedFault):
            server.submit({"data": np.zeros((1, FEATS), np.float32)})
    assert server.stats()["models"]["default"]["queue_depth"] == 0


def test_serve_shed_doomed_and_queue_full_backpressure():
    clock = FakeClock()
    server = _serve(_mlp("sh"), ladder=[1, 2], clock=clock, max_queue=4,
                    shed_watermark=2, default_deadline_ms=50)
    x = np.random.RandomState(0).rand(1, FEATS).astype("f")
    shed_before = _cval("serve.shed", model="default")
    rej_before = _cval("serve.rejected", model="default")
    doomed = [server.submit({"data": x}, deadline_ms=10) for _ in range(2)]
    clock.advance(5.0)
    h = server.submit({"data": x}, deadline_ms=60000)
    for d in doomed:
        assert isinstance(d.exception(), ShedError)
        assert d.exception().retry_after_ms >= 1
    assert _cval("serve.shed", model="default") == shed_before + 2
    clock.advance(60.0)
    server.pump()
    assert h.exception() is None
    hs = [server.submit({"data": x}, deadline_ms=600000) for _ in range(4)]
    with pytest.raises(QueueFullError):
        server.submit({"data": x}, deadline_ms=600000)
    assert _cval("serve.rejected", model="default") == rej_before + 1
    clock.advance(600.0)
    server.pump()
    assert all(hh.exception() is None for hh in hs)


def test_request_trace_tree_and_telemetry_span():
    mx.telemetry.reset()
    mx.telemetry.enable()
    try:
        clock = FakeClock()
        server = _serve(_mlp("tr"), ladder=[1, 2], clock=clock,
                        default_deadline_ms=10)
        h = server.submit({"data": np.zeros((1, FEATS), np.float32)})
        clock.advance(0.010)
        server.pump()
    finally:
        mx.telemetry.disable()
    tree = mx.telemetry.trace.tree(h.trace_id)
    assert tree["name"] == "serve.request" and tree["bucket"] == 1
    names = sorted(c["name"] for c in tree["children"])
    assert names == ["serve.dispatch", "serve.queue.wait"]
    disp = [c for c in tree["children"] if c["name"] == "serve.dispatch"][0]
    assert sorted(c["name"] for c in disp["children"]) == \
        ["serve.assemble", "serve.exec", "serve.respond"]
    assert [s.name for s in mx.telemetry.core.get_spans()] == \
        ["serve.warmup"]
    stats = server.stats()["models"]["default"]
    assert stats["p99_trace"] == h.trace_id
    assert stats["slowest_trace"]["trace"] == h.trace_id


def test_histogram_quantile_and_exemplar():
    mx.telemetry.reset()
    hist = mx.telemetry.histogram("x.seconds")
    for i, v in enumerate((0.0002, 0.002, 0.002, 0.02)):
        hist.observe(v, exemplar=f"t{i}")
    # rank 2 of 4 lies halfway between the 1e-3 and 5e-3 bucket bounds
    assert hist.quantile(0.5) == pytest.approx(0.003)
    assert hist.max == 0.02 and hist.mean == pytest.approx(0.00605)
    assert hist.exemplar(0.99) == "t3"
    snap = mx.telemetry.snapshot()
    assert snap["histograms"]["x.seconds"]["count"] == 4


# ----------------------------------------------------- quantized serving
@pytest.mark.parametrize("tier,tol", [("int8", quant.INT8_TOL),
                                      ("fp8", quant.FP8_TOL)])
def test_quantized_serve_builds_nothing_and_stays_in_tolerance(tier, tol):
    sym = _mlp("q", hidden=32, classes=10)
    mod = _bound_module(sym, feat=16, batch=8,
                        params=_params(sym, feat=16))
    server = mx.serve.serve(mod, name="q", ladder=[1, 2, 4, 8],
                            compute_dtype=tier, start=False)
    try:
        eng = server.engine("q")
        assert eng.quantized == tier
        # the CPU builds no kernel library, at warmup or after
        assert eng.warmup_compiles == 0
        q_cells = eng._bm._leader._exec_group.executor.arg_dict
        want = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[tier]
        assert q_cells["q1_weight_q"].astorch().dtype == want
        x = np.random.RandomState(3).rand(8, 16).astype(np.float32)
        outs = [eng.forward(n, {"data": x[:n]})[0].asnumpy()
                for n in (1, 2, 4, 8)]
        assert eng.compiles_since_warmup() == 0
        stats = server.stats()
        assert stats["compiles_since_warmup"] == 0
        assert stats["models"]["q"]["quantized"] == tier
        ref = _direct_forward(sym, mod, x, 8)
        assert np.allclose(ref, outs[-1], **tol)
        assert not np.array_equal(ref, outs[-1])
        for n, o in zip((1, 2, 4), outs):
            np.testing.assert_allclose(o, outs[-1][:n], atol=1e-6)
    finally:
        server.stop()


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_serve_quantize_env_default(monkeypatch, tier):
    monkeypatch.setenv("MXNET_SERVE_QUANTIZE", tier)
    server = _serve(_mlp("envq"), ladder=[1, 4])
    assert server.engine().quantized == tier


def test_what_is_not_ported_raises():
    server = _serve(_mlp("np"), ladder=[1])
    with pytest.raises(MXNetError, match="multi-GPU slice"):
        server.checkpoint_to("/nonexistent")
    with pytest.raises(MXNetError, match="predict.py"):
        mx.serve.serve("model.mxp", start=False)
    with pytest.raises(MXNetError, match="predict.py"):
        mx.serve.PredictorEngine("m", "model.mxp")
    with pytest.raises(MXNetError, match="mixed precision"):
        _serve(_mlp("np2"), ladder=[1], compute_dtype="bfloat16")
    with pytest.raises(MXNetError, match="bound"):
        mx.serve.serve(mx.mod.Module(_mlp("np3"), context=CPU), start=False)


# ------------------------------------------------- parity with mxnet_tpu
@pytest.mark.parametrize("tier", [None, "int8"])
def test_same_dispatches_and_outputs_as_jax_server(tier):
    import mxnet_tpu as jmx
    arrivals = [0.000, 0.002, 0.003, 0.011, 0.012, 0.013, 0.014, 0.040,
                0.041, 0.070]

    def make(i, rng):
        return {"data": rng.rand(1 + i % 3, FEATS).astype(np.float32)}

    runs = {}
    for name, lib in (("jax", jmx), ("torch", mx)):
        sym = _mlp("par", hidden=16, classes=5, lib=lib)
        params = _params(sym)
        mod = lib.mod.Module(sym, context=lib.cpu())
        mod.bind([("data", (4, FEATS))], [("softmax_label", (4,))],
                 for_training=False)
        mod.init_params(initializer=None, arg_params={
            k: lib.nd.array(v, ctx=lib.cpu()) for k, v in params.items()},
            aux_params={})
        lib.telemetry.reset()
        server = lib.serve.serve(mod, name="par", ladder=[1, 2, 4],
                                 start=False, clock=lib.serve.FakeClock(),
                                 default_deadline_ms=8, compute_dtype=tier)
        handles, submit = [], server.submit

        def keep(*a, submit=submit, handles=handles, **k):
            handles.append(submit(*a, **k))
            return handles[-1]
        server.submit = keep
        summary = lib.serve.run_scripted(server, arrivals, make)
        m = server.stats()["models"]["par"]
        runs[name] = {
            "buckets": [h.bucket for h in handles],
            "completed_at": [h.completed_at for h in handles],
            "outs": [h.result()[0].asnumpy() for h in handles],
            "stats": {k: m[k] for k in ("dispatches", "batch_occupancy",
                                        "padding_waste_pct",
                                        "deadline_misses", "responses")},
            "summary": summary}
    j, t = runs["jax"], runs["torch"]
    assert t["buckets"] == j["buckets"]
    assert t["completed_at"] == j["completed_at"]
    assert t["stats"] == j["stats"]
    assert t["summary"] == j["summary"]
    for a, b in zip(j["outs"], t["outs"]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
