"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper. Import as ``import mxnet_tpu_torch as mx``.

This package imports ``torch`` and numpy, never JAX and nothing of the
JAX package. It keeps the JAX package's module names so each counterpart
is easy to find. Its entry points run on the card (``gpu(0)`` is the
default context) unless the caller passes ``mx.cpu()``.

The ported slices: the decode-serving path (the transformer LM
of ``models.transformer`` served by ``serve.serve_decoder``, with
chunked prefill, speculative decoding, the prefix store and the fp8 KV
cache), the single-device training path (``mod.Module.fit`` over the
image classifiers of ``models``, ResNet-50 first, with SGD-momentum or
Adam, and over the transformer LM, with the per-batch telemetry and MFU
accounting of ``telemetry.mfu``), one-shot serving
(``serve.serve(module)``) in float32 or the int8 / fp8 quantized tiers
(``ops/quant.py``), ``FusedConvBNReLU`` graphs (ResNet-50 with its
Conv -> BatchNorm -> ReLU triples fused) through both, ResNet-50 and the
transformer LM in bfloat16 and float16 mixed precision (``compute_dtype``), and the user-extension
surfaces: ``mx.rtc.Rtc`` and ``mx.rtc.register_cuda_op`` (the user's
own CUDA kernels), ``mx.operator.CustomOp`` (a Python layer) and
``mx.autograd`` (imperative gradients), and sequence-parallel LM
training (``fit(spmd=True, mesh=parallel.MeshConfig(seq=n))``: ring
attention over a mesh of one device's contexts, ``parallel/``), and
``mx.random`` (the JAX package's threefry2x32 key chain: ``seed``, the
samplers, the initializers' draws and ``Dropout``'s masks, the same bits
on the CPU and the card) with the classifiers that use Dropout, LRN and
Concat (AlexNet, VGG, Inception-BN, Inception-v3). The TPU
kernels on those paths are rewritten as CUDA C++ for sm_90a
(``ops/cuda_kernels.py``, sources under ``csrc/``).
"""
from . import base
from . import random
from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import ops  # populates the op registry (before nd/sym autogen)
from . import rtc  # registers attention / attention_decode
from . import parallel
from . import operator  # registers Custom
from . import ndarray
from . import ndarray as nd
from . import autograd
from . import contrib  # registers the contrib ops (before nd/sym autogen)
from . import _op_gen
_op_gen.init_ndarray_module(ndarray.__dict__)
from . import symbol
from . import symbol as sym
symbol._init_symbol_module(symbol.__dict__)
from .symbol import Group
from .attribute import AttrScope
from .name import NameManager, Prefix
from . import name
from .executor import Executor
from . import io
from . import image
from . import initializer
from . import optimizer
from .optimizer import Optimizer
from . import lr_scheduler
from . import metric
from . import callback
from . import model
from . import module
from . import module as mod
from . import models
from . import telemetry
from . import faults
from . import checkpoint
from . import serve
from . import convert
from . import predict
from .predict import export_model, Predictor

__version__ = "0.1.0"
