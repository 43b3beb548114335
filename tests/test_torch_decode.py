"""The decode-serving slice as a whole: ``mxnet_tpu_torch`` against
``mxnet_tpu`` on the CPU at a small size.

* a decode graph serialized by the JAX package loads in the port and
  serializes back to the same JSON;
* staggered ``BatchedKVCacheDecoder`` steps (and the scalar-cursor
  ``KVCacheDecoder``) give logits within 1e-4 of the JAX package's, whose
  side runs both its XLA composition and its Pallas kernels (interpret
  mode, ``MXNET_KERNEL_TIER=pallas``);
* ``serve_decoder(start=False, clock=FakeClock())`` + ``pump()`` gives the
  same greedy token chains as the JAX package's scheduler on the same
  arrivals;
* a ``.params`` file saved by the JAX package loads in the port.

Parameters come from a numpy seed and go to both packages unchanged.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import transformer as tfm
from mxnet_tpu.serve import FakeClock as JaxFakeClock

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serve import FakeClock

V, D, L, H, CAP = 64, 32, 2, 4, 16
TOL = 1e-4
CPU = mxt.cpu()


@pytest.fixture(scope="module")
def params():
    """One numpy-seeded parameter set, shaped by the decode graph."""
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                 n_head=H, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(0)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        scale = 0.3 if name.endswith("weight") else 0.1
        base = 1.0 if name.endswith("gamma") else 0.0
        out[name] = (base + scale * rs.randn(*shape)).astype(np.float32)
    return out


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def _jax_args(params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _torch_args(params):
    return mxt.convert.params_from_numpy(params, CPU)


def _jax_module(params, slots, per_slot):
    m = mx.mod.Module(tfm.get_decode_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
        per_slot=per_slot), label_names=[], context=mx.cpu())
    m.bind([("data", (slots, 1))], None, for_training=False)
    m.init_params(initializer=None, arg_params=_jax_args(params),
                  aux_params={}, allow_missing=True)
    return m


def _torch_module(params, slots, per_slot):
    m = mxt.mod.Module(ttfm.get_decode_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
        per_slot=per_slot), label_names=[], context=CPU)
    m.bind([("data", (slots, 1))], None, for_training=False)
    m.init_params(initializer=None, arg_params=_torch_args(params),
                  aux_params={}, allow_missing=True)
    return m


# ----------------------------------------------------------- symbol JSON
@pytest.mark.parametrize("per_slot", [True, False])
@pytest.mark.parametrize("pos_embed", ["rotary", "learned"])
def test_jax_decode_json_loads_in_port(per_slot, pos_embed):
    kw = dict(vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
              per_slot=per_slot, pos_embed=pos_embed)
    with mx.name.NameManager():
        js = tfm.get_decode_symbol(**kw).tojson()
    loaded = mxt.symbol.load_json(js)
    assert loaded.tojson() == js
    with mxt.name.NameManager():
        own = ttfm.get_decode_symbol(**kw)
    assert own.tojson() == js
    jsym = mx.sym.load_json(js)
    assert loaded.list_arguments() == jsym.list_arguments()
    assert loaded.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = {"data": (2, 1)}
    if pos_embed == "learned":
        shapes["pos_ids"] = (2, 1) if per_slot else (1,)
    assert loaded.infer_shape(**shapes) == jsym.infer_shape(**shapes)


# ------------------------------------------------------- decoder parity
def test_batched_decoder_staggered_matches_jax(params, jax_tier):
    """Three slots joining, leaving and rejoining at staggered positions:
    every step's logits within 1e-4 of the JAX package's."""
    jd = tfm.BatchedKVCacheDecoder(_jax_module(params, 3, True), CAP)
    td = ttfm.BatchedKVCacheDecoder(_torch_module(params, 3, True), CAP)
    rs = np.random.RandomState(1)
    for d in (jd, td):
        d.join(0)
        d.join(1)
    for step in range(9):
        if step == 2:
            for d in (jd, td):
                d.join(2)
        if step == 5:
            for d in (jd, td):
                d.leave(1)
                d.join(1)
        tok = rs.randint(0, V, (3, 1))
        a = jd.step(tok).asnumpy()
        b = td.step(tok).asnumpy()
        assert b.shape == (3, 1, V)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(jd.pos, td.pos)


def test_scalar_decoder_matches_jax(params, jax_tier):
    jd = tfm.KVCacheDecoder(_jax_module(params, 2, False), CAP)
    td = ttfm.KVCacheDecoder(_torch_module(params, 2, False), CAP)
    tokens = np.random.RandomState(2).randint(0, V, (2, 6))
    first = None
    for t in range(6):
        got = td.step(tokens[:, t:t + 1]).asnumpy()
        first = got if first is None else first
        np.testing.assert_allclose(jd.step(tokens[:, t:t + 1]).asnumpy(),
                                   got, atol=TOL, rtol=TOL)
    td.reset()          # zeroed caches and cursor: a fresh sequence
    assert td.pos == 0
    np.testing.assert_array_equal(td.step(tokens[:, :1]).asnumpy(), first)


def test_decode_steps_reproduce_full_forward(params):
    """N incremental decode steps == the length-N full forward, in the
    port; and the port's full forward == the JAX package's."""
    T = 8
    tokens = np.random.RandomState(3).randint(0, V, (2, T))
    full = mxt.mod.Module(ttfm.get_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, seq_len=T,
        include_loss=False, max_seq_len=CAP), label_names=[], context=CPU)
    full.bind([("data", (2, T))], None, for_training=False)
    full.init_params(arg_params=_torch_args(params), allow_missing=False)
    full.forward(mxt.io.DataBatch([mxt.nd.array(tokens, ctx=CPU)], []))
    ref = full.get_outputs()[0].asnumpy()
    assert ref.shape == (2, T, V)
    jfull = mx.mod.Module(tfm.get_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, seq_len=T,
        include_loss=False, max_seq_len=CAP), label_names=[],
        context=mx.cpu())
    jfull.bind([("data", (2, T))], None, for_training=False)
    jfull.init_params(initializer=None, arg_params=_jax_args(params),
                      allow_missing=False)
    jfull.forward(mx.io.DataBatch([mx.nd.array(tokens)], []),
                  is_train=False)
    np.testing.assert_allclose(jfull.get_outputs()[0].asnumpy(), ref,
                               atol=TOL, rtol=TOL)
    dec = ttfm.KVCacheDecoder(_torch_module(params, 2, False), CAP)
    for t in range(T):
        np.testing.assert_allclose(
            dec.step(tokens[:, t:t + 1]).asnumpy()[:, 0], ref[:, t],
            atol=TOL, rtol=TOL)


def test_batched_decoder_overflow_raises_before_dispatch(params):
    """A slot whose next window would pass capacity raises before the
    dispatch, for S=1 and for an S=4 window module; a window length with
    no module raises too."""
    base = _torch_module(params, 2, True)
    td = ttfm.BatchedKVCacheDecoder(base, CAP)
    with pytest.raises(MXNetError, match="no window module"):
        td.step(np.zeros((2, 4), np.int32))
    win = mxt.mod.Module(ttfm.get_decode_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
        per_slot=True, step_len=4), label_names=[], context=CPU)
    win.bind([("data", (2, 4))], None, for_training=False,
             shared_module=base)
    td.add_window(4, win)
    td.join(0)
    td.rewind(0, CAP - 3)
    with pytest.raises(MXNetError, match="overflow in slot"):
        td.step(np.zeros((2, 4), np.int32))
    td.rewind(0, CAP - 4)
    assert td.step(np.zeros((2, 4), np.int32)).shape == (2, 4, V)
    with pytest.raises(MXNetError, match="overflow in slot"):
        td.step(np.zeros((2, 1), np.int32))


# -------------------------------------------------------------- serving
def _drive(sched, clock, prompts, waves):
    """Submit ``prompts`` in ``waves`` [(n_submit, pump_iterations)] on a
    FakeClock, then pump to the end; returns the token chains."""
    handles, i = [], 0
    for n, iters in waves:
        for _ in range(n):
            handles.append(sched.submit(prompts[i], max_new_tokens=5 + i))
            i += 1
        sched.pump(max_iterations=iters)
        clock.advance(0.01)
    sched.pump()
    return [h.result(timeout=0).tolist() for h in handles]


def test_serve_decoder_greedy_chains_match_jax(params):
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, rs.randint(1, 5)).tolist()
               for _ in range(6)]
    waves = [(2, 3), (3, 4), (1, 2)]
    jclock, tclock = JaxFakeClock(), FakeClock()
    jsched = mx.serve.serve_decoder(
        tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                              n_head=H, capacity=CAP, per_slot=True),
        _jax_args(params), name="torch-parity", ladder=[1, 2, 4],
        clock=jclock, start=False, context=mx.cpu())
    tsched = mxt.serve.serve_decoder(
        ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                               n_head=H, capacity=CAP, per_slot=True),
        _torch_args(params), name="torch-parity", ladder=[1, 2, 4],
        clock=tclock, start=False, context=CPU)
    j_chains = _drive(jsched, jclock, prompts, waves)
    t_chains = _drive(tsched, tclock, prompts, waves)
    assert t_chains == j_chains
    assert [len(c) for c in t_chains] == [5 + i for i in range(6)]
    jst, tst = jsched.stats(), tsched.stats()
    for key in ("iterations", "tokens", "joins", "leaves", "migrations",
                "responses"):
        assert tst[key] == jst[key], key


def test_scheduler_overflow_fails_alone_and_deadline(params):
    clock = FakeClock()
    sched = mxt.serve.serve_decoder(
        ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                               n_head=H, capacity=CAP, per_slot=True),
        _torch_args(params), ladder=[1, 2], clock=clock, start=False,
        context=CPU)
    long = sched.submit([1] * 10, max_new_tokens=20)   # 10 + 20 > 16
    short = sched.submit([2, 3], max_new_tokens=4)
    sched.pump()
    assert len(short.result(timeout=0)) == 4
    assert short.finish_reason == "length"
    with pytest.raises(MXNetError, match="overflowed"):
        long.result(timeout=0)
    late = sched.submit([4, 5], max_new_tokens=50, deadline_ms=100)
    sched.pump(max_iterations=3)
    clock.advance(1.0)
    sched.pump()
    assert late.finish_reason == "deadline"
    assert 0 < len(late.result(timeout=0)) < 50
    st = sched.stats()
    assert st["errors"] == 1 and st["responses"] == 2


def test_serve_decoder_streams_tokens_through_thread(params):
    """The dispatch-thread drive mode (real clock) streams every token
    through the callback, in order."""
    sched = mxt.serve.serve_decoder(
        ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                               n_head=H, capacity=CAP, per_slot=True),
        _torch_args(params), ladder=[1, 2], context=CPU)
    seen = []
    try:
        h = sched.submit([1, 2, 3], max_new_tokens=6)
        h.add_token_callback(lambda _h, tok, idx: seen.append((idx, tok)))
        out = h.result(timeout=60)
    finally:
        sched.stop()
    assert [t for _, t in sorted(seen)] == out.tolist()
    assert [i for i, _ in seen] == list(range(6))


def _gen(capacity=CAP):
    return lambda s: ttfm.get_decode_symbol(
        vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=capacity,
        per_slot=True, step_len=s)


@pytest.mark.parametrize("kwarg", ["symbol_gen", "draft_symbol_gen"])
def test_serve_decoder_refuses_later_slice_options(params, kwarg):
    """The fast-path options are refused where they cannot work: a
    ``symbol_gen`` whose windows would not share the rung's cache cells
    (another capacity), and a ``draft_symbol_gen`` without
    ``draft_params`` or without ``symbol_gen`` (the JAX package's
    errors)."""
    sym = _gen()(1)
    kw = dict(context=CPU, start=False, ladder=[1], prefill_chunk=4)
    if kwarg == "symbol_gen":
        with pytest.raises(MXNetError, match="did not share aux cell"):
            mxt.serve.serve_decoder(sym, _torch_args(params),
                                    symbol_gen=_gen(2 * CAP), **kw)
        return
    with pytest.raises(MXNetError, match="draft_params"):
        mxt.serve.serve_decoder(sym, _torch_args(params),
                                draft_symbol_gen=_gen(), **kw)
    with pytest.raises(MXNetError, match="symbol_gen"):
        mxt.serve.serve_decoder(sym, _torch_args(params),
                                draft_symbol_gen=_gen(),
                                draft_params=_torch_args(params), **kw)


def test_submit_refuses_prefix_id(params):
    """A ``prefix_id`` whose stored tokens do not head the new prompt is
    refused as a join (a miss and a mismatch, never a wrong join): the
    sequence decodes as a cold one and its own prompt is stored under the
    id, which the next matching submit joins."""
    sched = mxt.serve.serve_decoder(
        _gen()(1), _torch_args(params), ladder=[1], clock=FakeClock(),
        start=False, context=CPU, symbol_gen=_gen(), prefill_chunk=4,
        prefix_cache_mb=1)
    first = sched.submit([1, 2, 3, 4, 5], max_new_tokens=3, prefix_id="sys")
    sched.pump()
    other = sched.submit([9, 8, 7, 6, 5], max_new_tokens=3, prefix_id="sys")
    sched.pump()
    st = sched.stats()["prefix"]
    assert st["hits"] == 0 and st["mismatches"] == 1 and st["misses"] == 2
    cold = mxt.serve.serve_decoder(
        _gen()(1), _torch_args(params), ladder=[1], clock=FakeClock(),
        start=False, context=CPU, prefix_cache_mb=0)
    ref = cold.submit([9, 8, 7, 6, 5], max_new_tokens=3)
    cold.pump()
    assert other.result(timeout=0).tolist() == ref.result(timeout=0).tolist()
    again = sched.submit([9, 8, 7, 6, 5], max_new_tokens=3, prefix_id="sys")
    sched.pump()
    assert sched.stats()["prefix"]["hits"] == 1
    assert again.result(timeout=0).tolist() == \
        other.result(timeout=0).tolist()
    assert len(first.result(timeout=0)) == 3


# --------------------------------------------------------- weights files
def test_params_file_from_jax_loads_in_port(params, tmp_path):
    path = str(tmp_path / "lm-0001.params")
    mx.nd.save(path, _jax_args(params))
    loaded = mxt.nd.load(path)
    assert sorted(loaded) == sorted(params)
    for name, arr in loaded.items():
        assert arr.context == CPU
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr.asnumpy(), params[name])
    # and the port writes the same bytes back
    back = str(tmp_path / "back.params")
    mxt.nd.save(back, loaded)
    with open(path, "rb") as f1, open(back, "rb") as f2:
        assert f1.read() == f2.read()


def test_params_file_dtype_codes_round_trip(tmp_path):
    """int32 and the fp8 extension codes (100/101) written by the JAX
    package read back bit for bit."""
    import ml_dtypes
    rs = np.random.RandomState(5)
    src = {"i": rs.randint(-5, 5, (3, 4)).astype(np.int32),
           "e4m3": rs.randn(4, 2).astype(ml_dtypes.float8_e4m3fn),
           "e5m2": rs.randn(2, 3).astype(ml_dtypes.float8_e5m2)}
    path = str(tmp_path / "codes.params")
    mx.nd.save(path, {k: mx.nd.array(v, dtype=v.dtype)
                      for k, v in src.items()})
    loaded = mxt.nd.load(path)
    assert loaded["i"].astorch().dtype == torch.int32
    np.testing.assert_array_equal(loaded["i"].asnumpy(), src["i"])
    for k, dt in (("e4m3", torch.float8_e4m3fn),
                  ("e5m2", torch.float8_e5m2)):
        t = loaded[k].astorch()
        assert t.dtype == dt
        assert t.view(torch.uint8).numpy().tobytes() == \
            src[k].view(np.uint8).tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, seed=3),
                                dict(temperature=1.3, top_k=5, seed=4),
                                dict(temperature=0.7, top_p=0.6, seed=5)])
def test_sampling_matches_jax(kw):
    """Host-side sampling on the same logits: the same distribution and
    the same draws from the same PCG64 chain."""
    from mxnet_tpu.serve import sampling as js
    from mxnet_tpu_torch.serve import sampling as ts
    rows = np.random.RandomState(6).randn(8, V).astype(np.float32)
    jp, tp = js.SamplingParams(**kw), ts.SamplingParams(**kw)
    jr, tr = jp.make_rng(), tp.make_rng()
    for row in rows:
        np.testing.assert_array_equal(js.token_probs(row, jp),
                                      ts.token_probs(row, tp))
        assert js.sample_token(row, jp, jr) == ts.sample_token(row, tp, tr)


def test_simple_bind_forward_advances_aux_cells(params):
    """Executor surface: simple_bind allocates zero cells (the cursor as
    int32), forward() reads kwargs into argument cells and writes the
    cache/cursor aux back after every step."""
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                 n_head=H, capacity=CAP, per_slot=True)
    exe = sym.simple_bind(ctx=CPU, type_dict={"data": "int32"},
                          data=(2, 1))
    for name, cell in exe.arg_dict.items():
        if name in params:
            cell.astorch().copy_(torch.tensor(params[name]))
    cur = exe.aux_dict["lm_l0_attn_cache_pos"]
    assert cur.dtype == np.int32 and cur.shape == (2, 1)
    for step in range(3):
        out = exe.forward(data=np.asarray([[1], [2]], np.int32))
        assert out[0].shape == (2, 1, V)
        np.testing.assert_array_equal(cur.asnumpy().reshape(-1),
                                      [step + 1] * 2)
    k0 = exe.aux_dict["lm_l0_attn_k_cache"].asnumpy()
    assert np.abs(k0[:, :, :3]).sum() > 0 and not k0[:, :, 3:].any()
