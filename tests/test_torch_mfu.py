"""The port's cost metadata and MFU accounting against the JAX package.

``ops/cost.py`` is carried across whole and ``telemetry/mfu.py`` with
the card's peaks only, so:

* the per-op ``cost_table`` — FLOPs, bytes, their train multiples and
  node coverage — equals the JAX package's exactly, op for op, for
  full-width ResNet-50 (plain and fused) at batch 32 and the bench's LM
  at T=1024, batch 8 (shape inference only: no array is made);
* every op the port registers carries metadata, and none carries half;
* ``Module.fit`` on the CPU records the per-batch telemetry (span,
  histogram, counter, ``batch_end`` events) and sets
  ``mfu.flops_per_step``, ``mfu.node_coverage`` and
  ``mfu.achieved_flops_per_sec`` — but no ``mfu.model``, since the CPU
  has no peak; with telemetry off it notes each batch in the flight ring
  and sets no per-batch gauge;
* ``device_peaks`` knows the H100 and nothing else.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.telemetry import mfu as jmfu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.models import transformer as jtfm

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import mlp as tmlp
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.ops import cost
from mxnet_tpu_torch.telemetry import metrics as _metrics
from mxnet_tpu_torch.telemetry import mfu as tmfu

from test_torch_fused_cbr import fused_resnet

RESNET50 = dict(units=[3, 4, 6, 3], filter_list=[64, 256, 512, 1024, 2048],
                num_classes=1000, image_shape=(3, 224, 224))
IMAGES = {"data": (32, 3, 224, 224), "softmax_label": (32,)}
LM = dict(vocab_size=32000, d_model=512, n_layer=8, n_head=8, seq_len=1024)


@pytest.mark.parametrize("build,shapes", [
    (lambda sym, res, tfm: res.get_symbol(1000, 50, "3,224,224"), IMAGES),
    (lambda sym, res, tfm: fused_resnet(sym, **RESNET50), IMAGES),
    (lambda sym, res, tfm: tfm.get_symbol(**LM),
     {"data": (8, 1024), "softmax_label": (8 * 1024,)}),
], ids=["resnet50", "resnet50_fused", "bench_lm"])
def test_cost_table_equals_jax(build, shapes):
    want = jmfu.cost_table(build(mx.sym, jresnet, jtfm), shapes)
    got = tmfu.cost_table(build(mxt.sym, tresnet, ttfm), shapes)
    assert got == want
    assert got["uncovered"] == [] and \
        got["covered_nodes"] == got["compute_nodes"]
    rows = tmfu.roofline(got, *tmfu.device_peaks("NVIDIA H100 80GB HBM3"))
    assert rows == jmfu.roofline(want, 989e12, 3.35e12)


def test_every_registered_op_has_cost_metadata():
    assert cost.uncovered_ops() == []
    assert cost.partial_cost_ops() == []
    fused = mxt.ops.get_op("FusedConvBNReLU")
    attrs = fused.normalize_attrs(dict(kernel=(3, 3), num_filter=8,
                                       pad=(1, 1)))
    flops, nbytes = fused.cost(attrs, [(2, 4, 6, 6), (8, 4, 3, 3), (8,),
                                       (8,)])
    out = 2 * 8 * 6 * 6
    assert flops == 2.0 * out * 4 * 9 + 11.0 * out
    assert nbytes == 4.0 * (2 * 4 * 36 + 8 * 36 + 16 + out)
    assert cost.optimizer_flops("SGD", 10) == 40.0


def test_device_peaks_only_the_card():
    assert tmfu.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert tmfu.device_peaks("NVIDIA H100 80GB HBM3", "f32") == \
        (67e12, 3.35e12)
    assert tmfu.device_peaks("NVIDIA H100 80GB HBM3", "tf32")[0] == 495e12
    assert tmfu.device_hbm_bytes("NVIDIA H100 80GB HBM3") == 80 * 10 ** 9
    for kind in list(jmfu.PEAKS) + ["cpu", "NVIDIA A100-SXM4-80GB"]:
        assert tmfu.device_peaks(kind) == (None, None)
        assert tmfu.device_hbm_bytes(kind) is None
    if not torch.cuda.is_available():
        assert tmfu.device_peaks() == (None, None)
    assert list(tmfu.PEAKS) == ["NVIDIA H100 80GB HBM3"]
    assert tmfu.model_mfu(989e12, 1.0, 989e12) == 1.0
    assert tmfu.model_mfu(1.0, None, 989e12) is None


def _fit(batches=3):
    rs = np.random.RandomState(0)
    X = rs.rand(8 * batches, 1, 4, 4).astype(np.float32)
    y = rs.randint(0, 10, 8 * batches).astype(np.float32)
    it = mxt.io.NDArrayIter(X, y, batch_size=8)
    mod = mxt.mod.Module(tmlp.get_symbol(10), context=mxt.cpu())
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
            initializer=mxt.initializer.Xavier(
                rng=torch.Generator().manual_seed(0)))
    return mod, it


@pytest.fixture
def telemetry():
    mxt.telemetry.reset()
    mxt.telemetry.enable()
    yield mxt.telemetry
    mxt.telemetry.disable()
    mxt.telemetry.reset()


def _gauge(name):
    g = _metrics.get_metric(name)
    return None if g is None else g.value


def test_fit_records_batches_and_mfu_on_cpu(telemetry):
    mod, it = _fit(batches=3)
    table = tmfu.cost_table(mod.symbol, dict(it.provide_data +
                                             it.provide_label))
    assert _gauge("mfu.flops_per_step") == table["train_flops"]
    assert _gauge("mfu.node_coverage") == 1.0
    n_params = sum(int(np.prod(v.shape))
                   for v in mod.get_params()[0].values())
    flops = table["train_flops"] + cost.optimizer_flops("SGD", n_params)
    spans = [s for s in telemetry.core.get_spans()
             if s.name == "module.fit.batch"]
    assert [s.args["nbatch"] for s in spans] == [0, 1, 2]
    assert _gauge("mfu.achieved_flops_per_sec") == pytest.approx(
        flops / (spans[-1].dur / 1e6))
    assert _gauge("mfu.model") is None          # no peak on the CPU
    assert _metrics.get_metric("module.fit.batches").value == 3
    assert _metrics.get_metric("module.fit.batch.seconds").count == 3
    events = [e for e in telemetry.core.get_events()
              if e["kind"] == "batch_end"]
    assert [(e["payload"]["nbatch"], e["payload"]["batch_size"])
            for e in events] == [(0, 8), (1, 8), (2, 8)]
    assert all(e["payload"]["duration_us"] == s.dur
               for e, s in zip(events, spans))


def test_fit_without_telemetry_notes_the_flight_ring():
    mxt.telemetry.reset()
    _fit(batches=2)
    notes = [r for r in mxt.telemetry.flightrec.get_records()
             if r["kind"] == "module.fit.batch"]
    assert [r["nbatch"] for r in notes] == [0, 1]
    assert all(r["dur_us"] >= 0 and r["batch_size"] == 8 for r in notes)
    assert _gauge("mfu.achieved_flops_per_sec") is None
    assert mxt.telemetry.core.get_spans() == []
    assert _gauge("mfu.flops_per_step") is not None
