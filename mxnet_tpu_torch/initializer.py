"""Weight initializers: the JAX package's name-pattern dispatch.

An Initializer is called as ``init(name, arr)`` and routes on the
parameter name: ``*bias`` and ``*beta`` -> 0, ``*gamma`` -> 1,
``*moving_mean`` -> 0, ``*moving_var`` -> 1, ``*weight`` -> the class's
own rule (``_init_weight``); any other name raises. Random draws come
from an explicit ``torch.Generator`` on the CPU (``rng``; by default one
seeded with 0 per initializer), then move to the array's device, so the
card and the CPU start from the same values. The draws differ from the
JAX package's (another generator): a test that compares the two packages
carries the parameters across (``convert.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu"]


class Initializer:
    """Base: route by parameter name."""

    def __init__(self, rng=None):
        self.rng = rng if rng is not None else \
            torch.Generator().manual_seed(0)

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be string")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        if name.endswith("bias") or name.endswith("beta") or \
                name.endswith("moving_mean"):
            arr.astorch().fill_(0.0)
        elif name.endswith("gamma") or name.endswith("moving_var"):
            arr.astorch().fill_(1.0)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        else:
            self._init_default(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")

    def _init_default(self, name, arr):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default "
            "initialization is now limited to weight/bias/gamma/beta/"
            "moving_* suffixes.")


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.astorch().fill_(0.0)
    _init_default = _init_weight


class One(Initializer):
    def _init_weight(self, _, arr):
        arr.astorch().fill_(1.0)
    _init_default = _init_weight


class Constant(Initializer):
    def __init__(self, value=0.0, rng=None):
        super().__init__(rng)
        self.value = value

    def _init_weight(self, _, arr):
        arr.astorch().fill_(self.value)
    _init_default = _init_weight


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, rng=None):
        super().__init__(rng)
        self.scale = scale

    def _init_weight(self, _, arr):
        u = torch.rand(arr.shape, generator=self.rng)
        arr.astorch().copy_((2 * u - 1) * self.scale)


class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.astorch().copy_(
            self.sigma * torch.randn(arr.shape, generator=self.rng))


class Xavier(Initializer):
    """Uniform or gaussian with scale sqrt(magnitude / factor), the
    factor the average (``avg``), fan-in (``in``) or fan-out (``out``) of
    the weight, counting the spatial extent of a kernel."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 rng=None):
        super().__init__(rng)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("Unknown random type")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError("Incorrect factor type")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            val = (2 * torch.rand(shape, generator=self.rng) - 1) * scale
        else:
            val = scale * torch.randn(shape, generator=self.rng)
        arr.astorch().copy_(val)


class MSRAPrelu(Xavier):
    """He initialization with the PReLU slope correction: gaussian,
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, rng=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         rng)
