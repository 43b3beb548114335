"""Package rules of the PyTorch port.

* ``import mxnet_tpu_torch`` pulls in neither JAX, the JAX package nor
  ``ml_dtypes`` (the numpy fp8 dtypes the JAX package's quantized tier
  uses) — checked in a fresh interpreter that also quantizes to fp8,
  serves, and touches the telemetry and fault planes — and no source
  file of the port, its ``telemetry/`` and ``faults/`` subpackages
  included, nor ``chip_smoke.py`` imports any of them (checked on the
  syntax tree);
* entry points default to the card: ``current_context()`` is ``gpu(0)``,
  and without CUDA, binding there raises instead of running on the host
  — for the training path's ``Module.fit`` as for serving.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "flax", "optax", "ml_dtypes")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_import_leaves_jax_out():
    code = ("import sys, mxnet_tpu_torch as mx\n"
            "mx.models.transformer.get_decode_symbol(per_slot=True)\n"
            "mx.models.resnet.get_symbol(10, 8, '3,16,16')\n"
            "import numpy as np\n"
            "from mxnet_tpu_torch.ops import quant\n"
            "quant.quantize_per_channel(np.ones((2, 3), 'f'), dtype='fp8')\n"
            "mx.telemetry.counter('x').inc(); mx.faults.point('x')\n"
            "mx.serve.InferenceServer(clock=mx.serve.FakeClock())\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_relative_imports_stay_inside_the_package():
    """A relative import never climbs out of mxnet_tpu_torch/."""
    for path in _port_sources():
        if not path.startswith(PKG):
            continue
        depth = os.path.relpath(path, PKG).count(os.sep) + 1
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth, (path, node.lineno)


def test_default_context_is_the_card():
    assert mxt.current_context() == mxt.gpu(0)
    with mxt.cpu():
        assert mxt.current_context() == mxt.cpu()
        assert mxt.nd.array([1, 2]).context == mxt.cpu()
    assert mxt.current_context() == mxt.gpu(0)


def test_serve_decoder_without_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: gpu(0) is a valid default here")
    sym = ttfm.get_decode_symbol(vocab_size=16, d_model=8, n_layer=1,
                                 n_head=2, capacity=8, per_slot=True)
    with pytest.raises(MXNetError, match="needs CUDA"):
        mxt.serve.serve_decoder(sym, {}, start=False)
    with pytest.raises(MXNetError, match="needs CUDA"):
        mxt.nd.array(np.zeros(3))
    with pytest.raises(MXNetError, match="needs CUDA"):
        mxt.mod.Module(sym, label_names=[]).bind([("data", (1, 1))])


def test_fit_without_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: gpu(0) is a valid default here")
    from mxnet_tpu_torch.models import mlp
    it = mxt.io.NDArrayIter(np.zeros((4, 1, 2, 2), np.float32),
                            np.zeros(4, np.float32), batch_size=2)
    with pytest.raises(MXNetError, match="needs CUDA"):
        mxt.mod.Module(mlp.get_symbol(10)).fit(it, num_epoch=1)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises (no silent fallback)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a system nvcc exists")
    with pytest.raises(MXNetError, match="nvcc"):
        ck._nvcc()


def test_inference_only_binding():
    """The decode graph is inference-only: it binds for training (the
    port trains), but its attention_decode op refuses a training
    forward."""
    sym = ttfm.get_decode_symbol(vocab_size=16, d_model=8, n_layer=1,
                                 n_head=2, capacity=8, per_slot=True)
    mod = mxt.mod.Module(sym, label_names=[], context=mxt.cpu())
    mod.bind([("data", (1, 1))], None, for_training=True)
    mod.init_params(arg_params={}, aux_params={}, allow_missing=True)
    with pytest.raises(MXNetError, match="inference op"):
        mod.forward(mxt.io.DataBatch([np.zeros((1, 1), np.int32)], []),
                    is_train=True)
    with pytest.raises(MXNetError, match="fp8"):
        ttfm.get_decode_symbol(vocab_size=16, d_model=8, n_layer=1,
                               n_head=2, capacity=8, cache_dtype="fp8")


def test_new_subpackages_are_guarded():
    """The syntax-tree guard walks the telemetry and fault planes too."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()}
    for path in ("telemetry/__init__.py", "telemetry/metrics.py",
                 "telemetry/core.py", "telemetry/trace.py",
                 "telemetry/flightrec.py", "faults/__init__.py",
                 "faults/plane.py", "faults/breaker.py", "ops/quant.py",
                 "serve/server.py", "serve/engine.py"):
        assert path in rel, path
