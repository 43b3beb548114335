"""Weight initializers: the JAX package's name-pattern dispatch.

An Initializer is called as ``init(name, arr)`` and routes on the
parameter name in the JAX package's order: ``upsampling*`` -> the
bilinear kernel (``UpSampling``'s weight), then ``*bias`` -> 0,
``*gamma`` -> 1, ``*beta`` -> 0, ``*weight`` -> the class's own rule
(``_init_weight``), ``*moving_mean`` -> 0, ``*moving_var`` -> 1,
``*moving_inv_var`` and ``*moving_avg`` -> 0; any other name raises.
Random draws come from the ``mx.random`` chain, one ``next_key()`` a
weight, in the JAX package's arithmetic: after the same
``mx.random.seed`` and the same order of calls (``Module.init_params`` goes by sorted name, as the JAX
package's does) both packages hold the same initial weights, uniform
draws bit for bit and the standard normal ones within 1e-5 of max(1,
|value|) (``erfinv`` is not XLA's polynomial). A weight on the card is
drawn there by the threefry kernel (``cuda_kernels.uniform``), one
launch, with the same bits as on the CPU. ``rng``, a
``torch.Generator``, draws from that generator on the CPU instead (then
moved to the weight's device) and leaves the chain alone.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random as _random
from .ndarray import NDArray

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "Bilinear", "bilinear_kernel"]


def bilinear_kernel(shape):
    """The bilinear upsampling kernel of ``shape`` (..., H, W) in float32,
    bit for bit the JAX package's ``_init_bilinear``: at (y, x) of every
    plane ``(1 - |x / f - c|) * (1 - |y / f - c|)`` in float64, f =
    ceil(W / 2), c = (2f - 1 - f % 2) / 2f, then rounded once."""
    shape = tuple(int(d) for d in shape)
    f = np.ceil(shape[3] / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = np.arange(int(np.prod(shape)))
    x = i % shape[3]
    y = (i // shape[3]) % shape[2]
    weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
    return weight.astype(np.float32).reshape(shape)


class Initializer:
    """Base: route by parameter name."""

    def __init__(self, rng=None):
        self.rng = rng

    def _draw(self, arr, transform, scale=1.0):
        """float32 draws of ``arr``'s shape, standard normal or uniform in
        [-scale, scale): from ``rng`` when given, else under
        ``next_key()`` where ``arr`` lies (the uniform kernel on the
        card)."""
        shape = tuple(arr.shape)
        if self.rng is not None:
            if transform == _random.NORMAL:
                return torch.randn(shape, generator=self.rng)
            return (2 * torch.rand(shape, generator=self.rng) - 1) * scale
        from .ops.cuda_kernels import uniform
        return uniform(_random.next_key(), shape, -scale, scale, transform,
                       arr.astorch().device)

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be string")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            arr.astorch().fill_(0.0)
        elif name.endswith("gamma"):
            arr.astorch().fill_(1.0)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or \
                name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            arr.astorch().fill_(0.0)
        elif name.endswith("moving_var"):
            arr.astorch().fill_(1.0)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        arr.astorch().copy_(torch.from_numpy(bilinear_kernel(arr.shape)))

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
        arr.astorch().copy_(self._draw(arr, _random.UNIFORM, self.scale))


class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.astorch().copy_(self.sigma * self._draw(arr, _random.NORMAL))


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
            val = self._draw(arr, _random.UNIFORM, scale)
        else:
            val = scale * self._draw(arr, _random.NORMAL)
        arr.astorch().copy_(val)


class MSRAPrelu(Xavier):
    """He initialization with the PReLU slope correction: gaussian,
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, rng=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         rng)


class Bilinear(Initializer):
    """Every weight the bilinear upsampling kernel (``bilinear_kernel``)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)
