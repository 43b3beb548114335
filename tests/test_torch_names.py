"""The public names of the ported modules, against the JAX package.

* Each name ROADMAP §C 2 found missing is called through both packages on
  the same inputs (CPU): ``mx.rtc.flash_attention`` (and its gradient),
  ``mx.rtc.flash_attention_partial``, ``mx.rtc.pallas_sgd_mom_update``
  (the JAX side's Pallas kernels in interpret mode), the five
  ``mx.telemetry`` names with ``wrap_dispatch``'s spans and counters,
  ``mx.num_gpus`` and ``mx.serve.default_prefix_budget_bytes``.
* Every module that both packages have is compared by its public names
  (``dir()`` less the underscored names and the names third-party
  packages own): the JAX package's names the port lacks are exactly
  those ``LATER`` lists, each under the later slice (ROADMAP.md) that
  brings it, or as not to be ported.
* ``NDArray.asnumpy`` returns a copy on the CPU too, as the JAX package's
  does (numpy's view of a CPU tensor would move with an optimizer's
  in-place update).
"""
import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mxnet_tpu as mxj
from mxnet_tpu import rtc as jrtc

import mxnet_tpu_torch as mxt

TOL, GRAD_RTOL = 2e-5, 1e-5

#: the JAX package's public names the port lacks, by module ("" is the
#: package), by the slice that brings them (ROADMAP.md), or "not ported":
#: TPU-only machinery (Pallas, XLA's program cache, kernel tiers, VMEM),
#: and the names a JAX module imports for its own use
LATER = {
    "A5": {
        "": ["FeedForward", "init_registry"],
        "callback": ["LogValidationMetricsCallback", "ProgressBar",
                     "module_checkpoint"],
        "initializer": ["FusedRNN", "InitDesc", "LSTMBias", "Load", "Mixed",
                        "Orthogonal", "init_registry", "register"],
        "io": ["CSVIter", "MNISTIter", "PrefetchingIter", "ResizeIter",
               "StackedDataBatch"],
        "lr_scheduler": ["CosineScheduler", "PolyScheduler",
                         "WarmupScheduler"],
        "metric": ["F1", "Perplexity"],
        "model": ["FeedForward"],
        "module": ["PythonLossModule", "PythonModule", "SequentialModule",
                   "python_module", "sequential_module"],
        "optimizer": ["AdaDelta", "AdaGrad", "DCASGD", "Ftrl", "NAG",
                      "RMSProp", "SGLD", "Test", "ccSGD"],
        "ndarray": ["rmsprop_update", "rmspropalex_update"],
        "symbol": ["rmsprop_update", "rmspropalex_update"],
    },
    "A6": {
        "": ["rnn"],
        "ndarray": ["RNN"],
        "symbol": ["RNN"],
        "ops": ["rnn_op"],
    },
    "A7": {
        "": ["recordio", "mp_decode"],
        "image": ["CenterCropAug", "CreateAugmenter", "HorizontalFlipAug",
                  "ImageIter", "ImageRecordIter", "RandomCropAug",
                  "RandomOrderAug", "RandomSizedCropAug", "ResizeAug",
                  "center_crop", "color_normalize", "fixed_crop",
                  "imdecode", "random_crop", "random_size_crop",
                  "recordio", "resize_short", "scale_down"],
        "ndarray": ["imdecode"],
    },
    "A8": {
        "": ["kv", "kvstore", "kvstore_sched"],
        "checkpoint": ["DeadWorkerError", "recovery", "recovery_generation",
                       "reexec_survivor", "survivor_env"],
        "faults": ["KNOWN_POINTS"],
        "faults.plane": ["KNOWN_POINTS"],
        "parallel": ["FlatShardLayout", "ZeroPlan", "all_gather",
                     "all_reduce", "apply_spec_update", "barrier",
                     "data_sharding", "mesh_token", "placement",
                     "reduce_scatter", "replicated", "shard", "zero"],
        "parallel.collectives": ["all_gather", "all_reduce", "barrier",
                                 "reduce_scatter"],
        "parallel.mesh": ["data_sharding", "mesh_token", "replicated",
                          "shard"],
        "parallel.spmd": ["FlatShardLayout", "mesh_token",
                          "param_partition_specs"],
    },
    "A9": {
        "": ["Monitor", "analysis", "monitor", "profiler", "remat",
             "test_utils", "tpu", "visualization", "viz"],
        "ops": ["layout"],
        "context": ["tpu"],
        "executor": ["naive_engine_active"],
        "telemetry": ["AnomalyError", "NanSentinel", "chrome_trace", "fleet",
                      "health", "jsonl", "memory", "opsd", "prometheus",
                      "sentinel", "serve_ops", "stepattr"],
        "telemetry.flightrec": ["on_crash"],
        "telemetry.metrics": ["all_metrics", "generation"],
        "telemetry.trace": ["current", "current_id", "roots", "set_current",
                            "trace_ids", "use"],
        "serve.decode": ["token_probs"],
    },
    "not ported": {
        "": ["kernel_tier", "program_cache"],
        "ops": ["pallas_kernels"],
        "rtc": ["pallas_call", "register_pallas_op"],
        "telemetry.mfu": ["min_vmem_budget"],
        "parallel": ["shard_map"],
        "parallel.collectives": ["shard_map"],
        # imported by a JAX module for its own use
        "contrib.ops": ["parse_tuple"],
        "executor": ["current_context", "get_op", "nd_zeros"],
        "initializer": ["MXNetError"],
        "io": ["MXNetError", "array"],
        "model": ["DataIter", "NDArray", "NDArrayIter", "cpu",
                  "current_context", "metric_mod", "opt"],
        "module.executor_group": ["nd_zeros"],
        "module.module": ["nd"],
        "ndarray": ["OP_REGISTRY"],
        "ops.loss": ["parse_int"],
        "ops.optimizer_op": ["parse_bool"],
        "ops.quant": ["OP_REGISTRY", "get_op"],
        "optimizer": ["MXNetError", "nd", "zeros"],
    },
}

_CONST = (int, float, str, bool, tuple, list, dict, set, frozenset,
          type(None))


def _public(mod, pkg):
    """The public names of module ``mod`` of package ``pkg``: not
    underscored, and a module of the package, a value the package defines
    (by its ``__module__``, or its type's) or a plain constant."""
    out = set()
    for name in dir(mod):
        if name.startswith("_"):
            continue
        val = getattr(mod, name)
        if isinstance(val, types.ModuleType):
            if val.__name__.startswith(pkg + "."):
                out.add(name)
            continue
        owner = getattr(val, "__module__", None) or type(val).__module__
        if isinstance(val, _CONST) or (owner or "").split(".")[0] == pkg:
            out.add(name)
    return out


def _modules(pkg):
    out = {"": pkg.__name__}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[info.name.split(".", 1)[1]] = info.name
    return out


def test_public_names_of_every_ported_module():
    """Every module is imported first, so that each package's attributes
    hold all of its submodules whatever the tests before imported."""
    jmods, tmods = _modules(mxj), _modules(mxt)
    for name in list(jmods.values()) + list(tmods.values()):
        importlib.import_module(name)
    later = {}
    for by_module in LATER.values():
        for mod, names in by_module.items():
            later.setdefault(mod, set()).update(names)
    missing = {}
    for name in sorted(set(jmods) & set(tmods)):
        want = _public(importlib.import_module(jmods[name]), "mxnet_tpu")
        got = _public(importlib.import_module(tmods[name]),
                      "mxnet_tpu_torch")
        if want - got:
            missing[name] = want - got
    assert missing == later, (
        {k: sorted(v - later.get(k, set())) for k, v in missing.items()
         if v - later.get(k, set())},
        {k: sorted(v - missing.get(k, set())) for k, v in later.items()
         if v - missing.get(k, set())})
    assert {"contrib", "image", "contrib.ops"} <= set(tmods)


# --------------------------------------------------------------------------
# the names of ROADMAP §C 2, through both packages
# --------------------------------------------------------------------------
def _qkv(t, seed, dh=32, tk=None):
    rs = np.random.RandomState(seed)
    return (rs.randn(1, 2, t, dh).astype(np.float32),
            rs.randn(1, 2, tk or t, dh).astype(np.float32),
            rs.randn(1, 2, tk or t, dh).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_rtc_flash_attention_and_its_gradient_match_jax(causal):
    q, k, v = _qkv(64, 1)
    ct = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jrtc.flash_attention(
        *a, causal=causal, block_q=32, block_k=32),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(ct))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = mxt.rtc.flash_attention(*leaves, causal=causal, block_q=32,
                                  block_k=32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    got_g = torch.autograd.grad(got, leaves, torch.tensor(ct))
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max()
    for lib in (jrtc, mxt.rtc):
        with pytest.raises(Exception, match="multiple of block sizes"):
            lib.flash_attention(*(a[:, :, :48] for a in (q, k, v)),
                                block_q=32, block_k=32)


def test_rtc_flash_attention_partial_matches_jax():
    q, k, v = _qkv(32, 3, tk=64)
    for q_off, k_off, causal, scale in ((64, 0, True, None),
                                        (32, 32, True, 0.25),
                                        (0, 64, False, None)):
        want = jrtc.flash_attention_partial(
            *(jnp.asarray(a) for a in (q, k, v)), q_off, k_off,
            causal=causal, block_q=32, block_k=32, scale=scale)
        got = mxt.rtc.flash_attention_partial(
            *(torch.tensor(a) for a in (q, k, v)), q_off, k_off,
            causal=causal, block_q=32, block_k=32, scale=scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
    for lib in (jrtc, mxt.rtc):
        with pytest.raises(Exception, match="T must divide blocks"):
            lib.flash_attention_partial(q[:, :, :24], k, v, 0, 0,
                                        block_q=16, block_k=32)


def test_rtc_pallas_sgd_mom_update_matches_jax():
    rs = np.random.RandomState(4)
    w, g, m = (rs.randn(37, 5).astype(np.float32) for _ in range(3))
    hyper = dict(lr=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5,
                 clip_gradient=0.4)
    want = jrtc.pallas_sgd_mom_update(*(jnp.asarray(a) for a in (w, g, m)),
                                      **hyper)
    ins = [torch.tensor(a) for a in (w, g, m)]
    got = mxt.rtc.pallas_sgd_mom_update(*ins, **hyper)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(ins[0].numpy(), w)   # inputs untouched
    np.testing.assert_array_equal(ins[2].numpy(), m)


def _dispatch_trace(lib):
    """Two calls of a compiled program and one of an uncompiled one under
    ``wrap_dispatch``, a span and an event, with telemetry on: the
    results, the spans and events, the ``executor.dispatch`` count they
    added, and what ``clear`` leaves. The process-wide registry is read,
    not reset: other tests' servers hold its metrics."""
    tel = lib.telemetry

    def dispatched():
        metric = tel.get_metric("executor.dispatch")
        return 0 if metric is None else metric.value
    tel.clear()
    before = dispatched()
    tel.enable()
    try:
        run = tel.wrap_dispatch(lambda a, b: a + b, "fwd")
        outs = [run(1, 2), run(3, 4)]
        plain = tel.wrap_dispatch(lambda: 5, "eager", compiled=False)
        outs.append(plain())
        with tel.span("outer", step=1):
            tel.event("mark", n=1)
        spans = [(s.name, dict(s.args)) for s in tel.get_spans()]
        events = [(e["kind"], e["payload"]) for e in tel.get_events()]
        count = dispatched() - before
        tel.clear()
        left = (tel.get_spans(), tel.get_events())
    finally:
        tel.disable()
    with tel.null_span as s:
        s.set(x=1)
    return outs, spans, events, count, left


def test_telemetry_names_match_jax():
    """``wrap_dispatch``: the first call of a compiled program is
    ``executor.compile``, the rest ``executor.run`` (an uncompiled one's
    every call), each bumping ``executor.dispatch``; ``get_spans``,
    ``get_events``, ``clear`` and ``null_span``."""
    want, got = _dispatch_trace(mxj), _dispatch_trace(mxt)
    assert got == want
    assert [s[0] for s in got[1]] == ["executor.compile", "executor.run",
                                      "executor.run", "outer"]
    assert got[3] == 3 and got[4] == ([], [])


def test_num_gpus_and_prefix_budget_match_jax(monkeypatch):
    assert mxt.num_gpus() == torch.cuda.device_count()
    if not torch.cuda.is_available():     # JAX_PLATFORMS=cpu: no device
        assert mxt.num_gpus() == mxj.num_gpus() == 0
    for mb in (None, "8", "0"):
        if mb is not None:
            monkeypatch.setenv("MXNET_SERVE_PREFIX_CACHE_MB", mb)
        assert mxt.serve.default_prefix_budget_bytes() == \
            mxj.serve.default_prefix_budget_bytes()
    assert mxt.base.numeric_types == mxj.base.numeric_types
    assert mxt.base.string_types == mxj.base.string_types
    assert mxt.telemetry.flightrec.enabled() == \
        mxj.telemetry.flightrec.enabled()


def test_asnumpy_is_a_copy_on_the_cpu():
    arr = mxt.nd.array(np.ones((2, 3), np.float32), ctx=mxt.cpu())
    snap = arr.asnumpy()
    arr.astorch().add_(1.0)
    assert snap.tolist() == [[1.0] * 3] * 2
    assert arr.asnumpy().tolist() == [[2.0] * 3] * 2
