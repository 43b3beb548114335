"""Operator library: importing this package populates the registry."""
from .registry import OP_REGISTRY, get_op, list_ops, register, alias
from . import tensor  # noqa: F401 — registers the tensor ops
from . import nn  # noqa: F401 — registers the layer ops
from . import loss  # noqa: F401 — registers the loss heads
from . import optimizer_op  # noqa: F401 — registers the update ops
from . import quant  # noqa: F401 — registers the quantized ops
from . import cuda_kernels  # noqa: F401 — CUDA kernels + their variants
from . import cost  # noqa: F401 — seeds the ops' cost metadata
