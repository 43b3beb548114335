"""Device context: ``mx.cpu()`` / ``mx.gpu(i)`` mapped to ``torch.device``.

A Context is a value object naming where NDArray storage lives and where
a bound graph runs. ``gpu(i)`` is CUDA device *i*; there is no ``tpu()``.
The default context is ``gpu(0)``: the port's entry points run on the
card unless the caller asks for the CPU, and a ``gpu`` context on a
machine without CUDA raises instead of quietly running on the host.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """Device context (``cpu`` or ``gpu``) with a ``with ctx:`` scope."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    _local = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise ValueError(f"unknown device type {device_type!r}")
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def torch_device(self):
        """The ``torch.device`` this context names. A ``gpu`` context
        raises when CUDA is absent or the id is past the device count."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"context {self} needs CUDA, which is not available here; "
                "pass context=mx.cpu() to run on the host")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(
                f"context {self}: only {torch.cuda.device_count()} CUDA "
                "device(s) visible")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._local, "stack"):
            Context._local.stack = []
        Context._local.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._local.stack.pop()


def context_of(device):
    """The Context naming a ``torch.device``."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


def current_context():
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(Context._local, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def cpu(device_id=0):
    """Host context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device context."""
    return Context("gpu", device_id)

