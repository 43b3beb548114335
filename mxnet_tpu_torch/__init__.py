"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper. Import as ``import mxnet_tpu_torch as mx``.

This package imports ``torch`` and numpy, never JAX and nothing of the
JAX package. It keeps the JAX package's module names so each counterpart
is easy to find. Its entry points run on the card (``gpu(0)`` is the
default context) unless the caller passes ``mx.cpu()``.

Four slices are ported: the decode-serving path (the transformer LM of
``models.transformer`` served by ``serve.serve_decoder``), the
single-device training path (``mod.Module.fit`` over the image
classifiers of ``models``, ResNet-50 first, with SGD-momentum or Adam,
and over the transformer LM), and one-shot serving
(``serve.serve(module)``) in float32 or the int8 / fp8 quantized tiers
(``ops/quant.py``). The TPU kernels on those paths are rewritten as CUDA
C++ for sm_90a (``ops/cuda_kernels.py``, sources under ``csrc/``).
"""
from . import base
from .base import MXNetError
from .context import Context, cpu, gpu, current_context
from . import ops  # populates the op registry (before nd/sym autogen)
from . import rtc  # registers attention / attention_decode
from . import ndarray
from . import ndarray as nd
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
from . import serve
from . import convert

__version__ = "0.1.0"
