"""Decode serving's fast paths: ``mxnet_tpu_torch`` against ``mxnet_tpu``
on the CPU at a small size (V=64, d_model 32, 2 layers, 4 heads, cache 32;
a 1-layer draft of the same width).

* chunked prefill: ``serve_decoder(symbol_gen=, prefill_chunk=c)`` gives
  the JAX package's greedy chains and counts on the same FakeClock
  arrivals; S-token window logits agree within 1e-4; decoding slots ride
  a batchmate's prefill; a T-token prompt takes ⌈T/c⌉ prefill dispatches;
* speculative decoding: ``speculative_verify`` is exact against the JAX
  package's on the same logits (greedy, sampled, the ``q(d) = 0`` and the
  degenerate-residual branches); greedy output with a foreign draft is the
  target-only output and the JAX package's; a self draft accepts all;
* the prefix store: ``PrefixStore`` answers the JAX package's store call
  for call; a hit restores rows bitwise equal to a cold prefill's, and
  outputs equal a run without the store;
* telemetry: the ``serve.decode.*`` metric names and the span names of the
  same run equal the JAX package's;
* ``Module.init_params()``'s default initializer is ``Uniform(0.01)`` in
  both packages.

The JAX side runs as its XLA composition and as its Pallas kernels in
interpret mode (``jax_tier``). Parameters come from a numpy seed and go to
both packages unchanged.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import transformer as tfm
from mxnet_tpu.serve import FakeClock as JaxFakeClock
from mxnet_tpu.serve import PrefixStore as JaxPrefixStore
from mxnet_tpu.serve import sampling as jsamp

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serve import FakeClock, PrefixStore
from mxnet_tpu_torch.serve import sampling as tsamp

V, D, L, H, CAP = 64, 32, 2, 4, 32
TOL = 1e-4
CPU = mxt.cpu()
_names = iter(range(10 ** 6))


def _params(n_layer, seed):
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=n_layer,
                                 n_head=H, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(seed)
    return {n: ((1.0 if n.endswith("gamma") else 0.0)
                + (0.3 if n.endswith("weight") else 0.1) * rs.randn(*s))
            .astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}


@pytest.fixture(scope="module")
def target():
    return _params(L, 0)


@pytest.fixture(scope="module")
def draft():
    """A different, smaller model: 1 layer of the same width."""
    return _params(1, 1)


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


class _Side:
    """One package's serving surface, so that a scenario runs unchanged
    on both."""

    def __init__(self, jax):
        self.jax = jax
        self.pkg = mx if jax else mxt
        self.tfm = tfm if jax else ttfm
        self.ctx = mx.cpu() if jax else CPU

    def args(self, params):
        if self.jax:
            return {k: mx.nd.array(v) for k, v in params.items()}
        return mxt.convert.params_from_numpy(params, CPU)

    def gen(self, n_layer=L, **kw):
        return lambda s: self.tfm.get_decode_symbol(
            vocab_size=V, d_model=D, n_layer=n_layer, n_head=H,
            capacity=CAP, per_slot=True, step_len=s, **kw)

    def clock(self):
        return JaxFakeClock() if self.jax else FakeClock()

    def serve(self, target, chunk=1, draft=None, spec_k=None, prefix_mb=0,
              ladder=(1, 2, 4), clock=None, **kw):
        gen = self.gen()
        return self.pkg.serve.serve_decoder(
            gen(1), self.args(target), name=f"fast{next(_names)}",
            capacity=CAP, ladder=list(ladder),
            clock=clock or self.clock(), start=False, context=self.ctx,
            symbol_gen=gen if (chunk > 1 or draft is not None) else None,
            prefill_chunk=chunk,
            draft_symbol_gen=self.gen(1) if draft is not None else None,
            draft_params=self.args(draft) if draft is not None else None,
            spec_k=spec_k, prefix_cache_mb=prefix_mb, **kw)


JAX, PORT = _Side(True), _Side(False)


def _prompts(seed, n, lo=2, hi=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, rs.randint(lo, hi)).tolist() for _ in range(n)]


def _staggered(sched, prompts, max_new=6, prefix_ids=None):
    """Submit one prompt per FakeClock tick, pumping 1 or 2 iterations in
    between (slots land at different positions, the rung switches), then
    pump to the end; returns the greedy chains and the handles."""
    handles = []
    for i, p in enumerate(prompts):
        handles.append(sched.submit(
            p, max_new_tokens=max_new,
            prefix_id=prefix_ids[i] if prefix_ids else None))
        sched.pump(max_iterations=1 + i % 2)
        sched._clock.advance(0.01)
    sched.pump()
    return [h.result(timeout=0).tolist() for h in handles], handles


_COUNTS = ("iterations", "tokens", "joins", "leaves", "migrations",
           "responses", "prefill_chunks")


def _same_counts(a, b):
    for key in _COUNTS:
        assert a[key] == b[key], key


# ============================================================ chunked prefill
@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_chunked_prefill_chains_match_jax(target, jax_tier, chunk):
    prompts = _prompts(10 + chunk, 5)
    j, t = JAX.serve(target, chunk), PORT.serve(target, chunk)
    j_chains, _ = _staggered(j, prompts)
    t_chains, _ = _staggered(t, prompts)
    assert t_chains == j_chains
    assert t.prefill_chunk == j.prefill_chunk == chunk
    _same_counts(t.stats(), j.stats())
    assert t.stats()["prefill_chunks"] >= len(prompts)


@pytest.mark.parametrize("S", [3, 4])
def test_window_logits_match_jax(target, jax_tier, S):
    """Three slots at staggered cursors: S=1 steps, then S-token windows
    (the rows of a window see the window's earlier rows) — every logit
    within 1e-4 of the JAX package's, cursors equal."""
    drivers = []
    for side in (JAX, PORT):
        mods = []
        for step_len in (1, S):
            m = side.pkg.mod.Module(side.gen()(step_len), label_names=[],
                                    context=side.ctx)
            m.bind([("data", (3, step_len))], None, for_training=False,
                   shared_module=mods[0] if mods else None)
            if not mods:
                m.init_params(initializer=None, arg_params=side.args(target),
                              aux_params={}, allow_missing=True)
            mods.append(m)
        d = side.tfm.BatchedKVCacheDecoder(mods[0], CAP)
        d.add_window(S, mods[1])
        drivers.append(d)
    rs = np.random.RandomState(S)
    for d in drivers:
        d.join(0)
    for step in range(6):
        if step == 1:
            for d in drivers:
                d.join(1)
        if step == 3:
            for d in drivers:
                d.join(2)
        width = S if step % 2 else 1
        tok = rs.randint(0, V, (3, width))
        a, b = (d.step(tok).asnumpy() for d in drivers)
        assert b.shape == (3, width, V)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(drivers[0].pos, drivers[1].pos)


def test_decode_slots_ride_along_prefill(target):
    """A slot mid-decode rides a batchmate's 8-token chunk dispatches with
    one real token plus pads and rewinds after: both streams equal the
    token-at-a-time run's and the JAX package's."""
    a = [3, 5, 7]
    b = np.random.RandomState(2).randint(1, V, 20).tolist()
    outs = []
    for side, chunk in ((PORT, 8), (PORT, 1), (JAX, 8)):
        sched = side.serve(target, chunk, ladder=(2,))
        ha = sched.submit(a, max_new_tokens=10)
        sched.pump(max_iterations=2)            # a reaches steady state
        hb = sched.submit(b, max_new_tokens=4)
        sched.pump()
        outs.append([ha.result(timeout=0).tolist(),
                     hb.result(timeout=0).tolist()])
        if chunk == 8:
            assert sched.stats()["prefill_chunks"] >= 3
    assert outs[0] == outs[1] == outs[2]


def test_chunk_dispatch_count_and_prefill_spans(target):
    """A T-token prompt takes ⌈T/c⌉ window dispatches, the last of which
    samples the first new token; each of the n - 1 further tokens takes
    one dispatch. Each chunk records one ``serve.decode.prefill`` span."""
    from mxnet_tpu_torch.telemetry import trace
    T, c, n = 20, 8, 5
    sched = PORT.serve(target, c, ladder=(1,))
    prompt = np.random.RandomState(3).randint(1, V, T).tolist()
    h = sched.submit(prompt, max_new_tokens=n)
    sched.pump()
    assert len(h.result(timeout=0)) == n
    st = sched.stats()
    assert st["iterations"] == -(-T // c) + n - 1 == 7
    assert st["prefill_chunks"] == 3
    spans = [s for s in trace.spans(h.trace_id)
             if s["name"] == "serve.decode.prefill"]
    assert sorted(s["tokens"] for s in spans) == [4, 8, 8]
    assert {s["chunk"] for s in spans} == {c}
    assert h.ttft is not None and h.ttft >= h.ttft_exec >= 0


# ======================================================= speculative decoding
def _verify_cases():
    """(name, target rows, draft rows, proposals, SamplingParams kwargs)."""
    rs = np.random.RandomState(5)
    K = 4
    t_rows = (3 * rs.randn(K, V)).astype(np.float32)
    d_rows = (3 * rs.randn(K, V)).astype(np.float32)
    cases = []
    for seed in range(6):
        props = [int(np.argsort(-d_rows[j])[seed % 5]) for j in range(K)]
        cases.append((f"sampled{seed}", t_rows, d_rows, props,
                      dict(temperature=1.0, seed=seed)))
        cases.append((f"filtered{seed}", t_rows, d_rows, props,
                      dict(temperature=0.8, top_k=8, top_p=0.9, seed=seed)))
    # greedy: the draft agrees at j=0 and diverges at j=1
    g_draft = t_rows.copy()
    g_draft[1] += 100 * np.eye(V, dtype=np.float32)[0]
    cases.append(("greedy", t_rows, g_draft,
                  [int(np.argmax(r)) for r in g_draft], {}))
    # q(d) = 0: top_k=2 filters the draft's proposal away; the target
    # admits it at j=0 and not at j=1
    q0_t, q0_d = t_rows.copy(), d_rows.copy()
    d0 = int(np.argsort(-q0_d[0])[5])
    q0_t[0, d0] = q0_t[0].max() + 5.0
    d1 = int(np.argsort(-q0_d[1])[5])
    cases.append(("q_zero", q0_t, q0_d, [d0, d1, 0, 0],
                  dict(temperature=1.0, top_k=2, seed=3)))
    # degenerate residual: draft == target, a proposal off the argmax is
    # rejected under greedy and max(p - q, 0) is all zero
    cases.append(("degenerate", t_rows, t_rows.copy(),
                  [int(np.argmax(t_rows[0])),
                   int(np.argsort(-t_rows[1])[1]), 0, 0], {}))
    return cases


@pytest.mark.parametrize("case", _verify_cases(), ids=lambda c: c[0])
def test_speculative_verify_matches_jax(case):
    _name, t_rows, d_rows, props, kw = case
    jp, tp = jsamp.SamplingParams(**kw), tsamp.SamplingParams(**kw)
    jr, tr = jp.make_rng(), tp.make_rng()
    got = tsamp.speculative_verify(t_rows, d_rows, props, tp, tr)
    want = jsamp.speculative_verify(t_rows, d_rows, props, jp, jr)
    assert got == want
    assert tr.random() == jr.random()       # the same draws consumed
    accepted, toks = got
    assert toks[:accepted] == props[:accepted]
    if _name == "q_zero":
        assert accepted == 1 and len(toks) == 2
    if _name == "degenerate":
        assert got == (1, [props[0], int(np.argmax(t_rows[1]))])


def test_spec_greedy_foreign_draft_matches_target_only_and_jax(
        target, draft, jax_tier):
    """Greedy with a different 1-layer draft and spec_k=3 at staggered
    slot positions: the target-only chains, token for token, and the JAX
    package's chains and acceptance counts."""
    prompts = _prompts(30, 5, lo=2, hi=9)
    t = PORT.serve(target, 4, draft=draft, spec_k=3)
    j = JAX.serve(target, 4, draft=draft, spec_k=3)
    ref = PORT.serve(target, 4)
    t_chains, _ = _staggered(t, prompts, max_new=7)
    j_chains, _ = _staggered(j, prompts, max_new=7)
    ref_chains, _ = _staggered(ref, prompts, max_new=7)
    assert t_chains == ref_chains == j_chains
    ts, js = t.stats(), j.stats()
    assert ts["spec"] == js["spec"]
    assert ts["spec"]["k"] == 3 and ts["spec"]["proposed"] > 0
    _same_counts(ts, js)


def test_spec_self_draft_accepts_everything(target):
    """Draft == target: every proposal verifies (acceptance 1.0, no
    rollback), 8 tokens after prefill in ⌈8/4⌉ = 2 speculative
    iterations, and the output is the target-only output."""
    gen = PORT.gen()
    sched = mxt.serve.serve_decoder(
        gen(1), PORT.args(target), ladder=[1], clock=FakeClock(),
        start=False, context=CPU, symbol_gen=gen, prefill_chunk=1,
        draft_symbol_gen=gen, draft_params=PORT.args(target), spec_k=4,
        prefix_cache_mb=0)
    ref = PORT.serve(target, 1, ladder=(1,))
    p = [2, 9, 4]
    h, r = sched.submit(p, max_new_tokens=8), ref.submit(p, max_new_tokens=8)
    sched.pump()
    ref.pump()
    assert h.result(timeout=0).tolist() == r.result(timeout=0).tolist()
    st = sched.stats()["spec"]
    assert st["acceptance"] == 1.0 and st["rollbacks"] == 0
    assert st["proposed"] == 8


def test_spec_validation_errors_match_jax(target, draft):
    """The JAX package's refusals, message for message."""
    msgs = []
    for side in (JAX, PORT):
        got = []
        for kw in (dict(draft_symbol_gen=side.gen(1)),
                   dict(draft_symbol_gen=side.gen(1),
                        draft_params=side.args(draft))):
            with pytest.raises(side.pkg.base.MXNetError) as exc:
                side.pkg.serve.serve_decoder(
                    side.gen()(1), side.args(target), context=side.ctx,
                    start=False, **kw)
            got.append(str(exc.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "draft_params" in msgs[1][0] and "symbol_gen" in msgs[1][1]


# =============================================================== prefix store
def test_prefix_store_matches_jax():
    """The same calls on both stores: LRU refresh and eviction under the
    budget, token mismatch (a miss, never a join), a missing engine
    payload, hits capped at len(prompt) - 1, an oversized entry dropped."""
    rows = {"target": {"c": np.zeros((2, 8, 4), np.float32)}}
    t_rows = {"target": {"c": torch.zeros((2, 8, 4))}}
    entry_bytes = 2 * 8 + 2 * 8 * 4 * 4
    calls = [("put", "a", [1, 2]), ("put", "b", [3, 4]), ("put", "c", [5, 6]),
             ("lookup", "a", [1, 2, 9], ()), ("put", "d", [7, 8]),
             ("lookup", "b", [3, 4, 9], ()), ("lookup", "a", [1, 2, 9], ()),
             ("lookup", "a", [9, 9, 9], ()),
             ("lookup", "a", [1, 2, 9], ("target", "draft")),
             ("lookup", "a", [1, 2], ()), ("lookup", "zz", [1, 2], ())]
    stores = [JaxPrefixStore(budget_bytes=3 * entry_bytes),
              PrefixStore(budget_bytes=3 * entry_bytes)]
    for call in calls:
        out = []
        for store, r in zip(stores, (rows, t_rows)):
            if call[0] == "put":
                out.append(store.put(call[1], call[2], r))
            else:
                c, e = store.lookup(call[1], np.asarray(call[2]),
                                    tags=call[3])
                out.append((c, e is not None))
        assert out[0] == out[1], call
        assert stores[0].stats() == stores[1].stats(), call
    assert stores[1].stats()["evictions"] == 1
    assert stores[1].stats()["mismatches"] == 1
    tiny = [JaxPrefixStore(budget_bytes=8), PrefixStore(budget_bytes=8)]
    assert tiny[0].put("x", [1], rows) is tiny[1].put("x", [1], t_rows) \
        is False


def test_prefix_hit_rows_bitwise_equal_cold_prefill(target):
    """A cold prefill's rows go into the store; a second submit of the
    prompt joins at cursor C = len - 1 with those rows written back bit for
    bit, and decodes the cold output. The stored rows are bitwise what a
    fresh scheduler without the store writes."""
    sched = PORT.serve(target, 4, ladder=(1,), prefix_mb=4)
    prompt = np.random.RandomState(8).randint(1, V, 11).tolist()
    cold = sched.submit(prompt, max_new_tokens=5, prefix_id="sys")
    sched.pump()
    store = sched.prefix_store
    assert len(store) == 1 and store.misses == 1
    warm = sched.submit(prompt, max_new_tokens=5, prefix_id="sys")
    sched.pump()
    assert warm.result(timeout=0).tolist() == cold.result(timeout=0).tolist()
    assert store.hits == 1 and sched.stats()["prefix"]["hit_rate"] == 0.5
    entry = store.lookup("sys", np.asarray(prompt + [0]))[1]
    c = len(prompt) - 1
    # decode writes only past the prompt: the slot's first C rows still
    # hold what the join restored
    restored = sched.engine.driver(1).capture_rows(0, c)
    fresh = PORT.serve(target, 4, ladder=(1,))
    h = fresh.submit(prompt, max_new_tokens=5)
    fresh.pump()
    assert h.result(timeout=0).tolist() == cold.result(timeout=0).tolist()
    ref = fresh.engine.driver(1).capture_rows(0, len(prompt))
    for nm, rows in entry.payloads["target"].items():
        assert rows.dtype == torch.float32 and rows.shape[1] == len(prompt)
        assert torch.equal(rows, ref[nm]), nm
        assert torch.equal(restored[nm], rows[:, :c]), nm


def test_prefix_hits_equal_run_without_store_and_jax(target, draft):
    """8 requests sharing an 11-token prefix plus one distinct token
    each, speculation armed (the store keeps the draft's rows too): 7 of
    8 hit, the chains equal a run without the store and the JAX
    package's, with its hit counts. (The 12-token prompts end on a chunk
    boundary: a prompt whose last token is fed by a speculative iteration
    is not captured, in both packages.)"""
    rs = np.random.RandomState(9)
    shared = rs.randint(1, V, 11).tolist()
    prompts = [shared + [int(t)] for t in rs.randint(1, V, 8)]
    ids = ["sys"] * 8
    runs = []
    for side, mb in ((PORT, 1), (PORT, 0), (JAX, 1)):
        sched = side.serve(target, 4, draft=draft, spec_k=3, prefix_mb=mb,
                           ladder=(4,))
        first = sched.submit(prompts[0], max_new_tokens=4, prefix_id="sys")
        sched.pump()
        chains, _ = _staggered(sched, prompts[1:], max_new=4,
                               prefix_ids=ids[1:])
        runs.append(([first.result(timeout=0).tolist()] + chains,
                     sched.stats().get("prefix")))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert runs[0][1] == runs[2][1]
    assert runs[0][1]["hits"] == 7 and runs[0][1]["misses"] == 1
    assert runs[1][1] is None


# ================================================================= telemetry
def _names_of(snapshot):
    return {key.split("{")[0] for kind in ("counters", "gauges",
                                           "histograms")
            for key in snapshot[kind]}


def test_decode_telemetry_names_match_jax(target, draft):
    """The same FakeClock run with all three fast paths armed and
    telemetry on: the ``serve.decode.*`` metric names, the trace span
    names and the serving core spans equal the JAX package's (whose
    executor also records op and bind spans, which the port has not)."""
    seen = []
    for side in (JAX, PORT):
        tel = side.pkg.telemetry
        tel.reset()
        tel.enable()
        try:
            sched = side.serve(target, 4, draft=draft, spec_k=3,
                               prefix_mb=1, ladder=(1, 2))
            prompts = _prompts(40, 4, lo=8, hi=9)
            _staggered(sched, prompts[:1], max_new=5, prefix_ids=["p"])
            _staggered(sched, prompts, max_new=5, prefix_ids=["p"] * 4)
            metrics = {n for n in _names_of(tel.metrics.snapshot())
                       if n.startswith("serve.decode.")}
            spans = {s["name"] for s in tel.trace.spans()}
            core = {s.name for s in tel.core.get_spans()
                    if s.name.startswith("serve.")}
        finally:
            tel.disable()
            tel.reset()
        seen.append((metrics, spans, core))
    assert seen[1] == seen[0]
    metrics, spans, core = seen[1]
    assert {"serve.decode.prefix.hits", "serve.decode.spec.accepted",
            "serve.decode.prefill.chunks", "serve.decode.step.seconds",
            "serve.decode.request.latency.seconds"} <= metrics
    assert {"serve.decode.sequence", "serve.decode.queue.wait",
            "serve.decode.step", "serve.decode.prefill",
            "serve.decode.prefix.join"} <= spans
    assert core == {"serve.decode.warmup"}


# ===================================================== init_params' default
def _mlp(pkg):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.Activation(fc, act_type="relu"), num_hidden=4, name="fc2"),
        name="softmax")


def test_init_params_default_is_uniform_like_jax():
    """With no arguments, ``init_params`` draws U(-0.01, 0.01) weights and
    zero biases in both packages (the draws differ: other generators)."""
    for pkg, ctx in ((mx, mx.cpu()), (mxt, CPU)):
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.bind([("data", (4, 8))], [("softmax_label", (4,))])
        mod.init_params()
        args, _ = mod.get_params()
        for name in ("fc1_weight", "fc2_weight"):
            w = args[name].asnumpy()
            assert np.abs(w).max() <= 0.01 and np.abs(w).min() >= 0
            assert np.count_nonzero(w) == w.size, (pkg.__name__, name)
            assert w.std() > 0.003
        assert not args["fc1_bias"].asnumpy().any()


@pytest.mark.parametrize("bucketing", [False, True])
def test_default_initializer_refuses_unknown_aux_like_jax(bucketing):
    """The decode graph's cache cells have no initializer rule: the
    default initializer raises ``ValueError`` on them in both packages,
    and ``initializer=None`` keeps them zero."""
    for side in (JAX, PORT):
        sym = side.gen()(1)
        if bucketing:
            mod = side.pkg.mod.BucketingModule(
                lambda key: (sym, ["data"], []), default_bucket_key=2,
                context=side.ctx)
        else:
            mod = side.pkg.mod.Module(sym, label_names=[], context=side.ctx)
        mod.bind([("data", (2, 1))], None, for_training=False)
        with pytest.raises(ValueError, match="cache"):
            mod.init_params()
    mod = mxt.mod.Module(PORT.gen()(1), label_names=[], context=CPU)
    mod.bind([("data", (2, 1))], None, for_training=False)
    mod.init_params(initializer=None, arg_params={}, aux_params={},
                    allow_missing=True)
    assert not mod.get_params()[1]["lm_l0_attn_k_cache"].asnumpy().any()
    mod = mxt.mod.Module(PORT.gen()(1), label_names=[], context=CPU)
    mod.bind([("data", (2, 1))], None, for_training=False)
    with pytest.raises(MXNetError, match="missing"):
        mod.init_params(arg_params={})
