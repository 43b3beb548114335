"""Device meshes over the port's contexts.

The port of ``mxnet_tpu/parallel/mesh.py``. A mesh is a named grid of
``Context``s: a numpy object array plus one axis name per dimension. The
canonical axes are the JAX package's:

  * ``data``   — batch sharding
  * ``model``  — tensor parallelism
  * ``seq``    — sequence parallelism (ring attention)
  * ``pipe``   — pipeline stages
  * ``expert`` — expert parallelism

``build_mesh`` lays the axes out as the JAX package does: ``pipe`` and
``data`` outer, ``expert``, ``seq`` and ``model`` inner (fastest
varying), so position ``(d, s)`` of a ``data x seq`` mesh holds context
``d * n_seq + s``. A context may appear several times in one mesh: MXNet
lets one card stand at several places of a context list, and the
single-controller ring of ``ring_attention`` runs over such a mesh on
one card.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from ..context import current_context

__all__ = ["MeshConfig", "Mesh", "build_mesh", "mesh_scope", "current_mesh",
           "DEFAULT_AXES", "ENV_AXIS_VARS"]

DEFAULT_AXES = ("data", "model", "seq", "pipe", "expert")

#: env knobs overriding per-axis mesh sizes
ENV_AXIS_VARS = {a: f"MXNET_MESH_{a.upper()}" for a in DEFAULT_AXES}

_LOCAL = threading.local()


@dataclass
class MeshConfig:
    """Axis-size spec; unlisted axes get size 1 and are dropped."""
    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def sizes(self):
        base = {"data": self.data, "model": self.model, "seq": self.seq,
                "pipe": self.pipe, "expert": self.expert}
        return {k: v for k, v in base.items() if v > 1}

    @classmethod
    def from_env(cls, n_devices=None):
        """MeshConfig from the ``MXNET_MESH_*`` env overrides, or None
        when no axis is set. Unset axes default to 1; with
        ``n_devices`` and no ``data`` override, the data axis takes the
        devices the set axes leave (when that is more than one)."""
        sizes = {}
        for axis, var in ENV_AXIS_VARS.items():
            raw = os.environ.get(var, "")
            if raw:
                try:
                    sizes[axis] = int(raw)
                except ValueError:
                    raise ValueError(f"{var}={raw!r} is not an integer")
        if not sizes:
            return None
        if n_devices is not None and "data" not in sizes:
            other = int(np.prod(list(sizes.values())))
            if other and n_devices % other == 0 and n_devices // other > 1:
                sizes["data"] = n_devices // other
        return cls(**sizes)


class Mesh:
    """A named grid of contexts: ``devices`` (numpy object array of
    ``Context``) and ``axis_names`` (one per dimension)."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims, "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self):
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def line(self, axis, index=None):
        """The contexts along ``axis`` at ``index`` (a dict {other axis:
        position}; 0 on every axis it leaves out)."""
        index = index or {}
        at = tuple(slice(None) if a == axis else index.get(a, 0)
                   for a in self.axis_names)
        return list(self.devices[at]) if axis in self.axis_names \
            else [self.devices[at]]

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def build_mesh(config=None, devices=None, **axis_sizes):
    """Build a Mesh: ``build_mesh(MeshConfig(data=2, seq=2), contexts)``
    or ``build_mesh(data=4, devices=contexts)``. Without ``devices`` the
    current context fills every position. Axis order: ``pipe``, ``data``,
    ``expert``, ``seq``, ``model``."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    sizes = config.sizes()
    if devices is None:
        devices = [current_context()] * int(np.prod(list(sizes.values())
                                                    or [1]))
    devices = list(devices)
    if not sizes:
        sizes = {"data": len(devices)}
    total = int(np.prod(list(sizes.values())))
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    order = [a for a in ("pipe", "data", "expert", "seq", "model")
             if a in sizes]
    grid = np.empty(total, dtype=object)
    for i, ctx in enumerate(devices[:total]):
        grid[i] = ctx
    return Mesh(grid.reshape([sizes[a] for a in order]), order)


def mesh_scope(mesh):
    """Context manager installing a current mesh."""
    class _Scope:
        def __enter__(self):
            if getattr(_LOCAL, "stack", None) is None:
                _LOCAL.stack = []
            _LOCAL.stack.append(mesh)
            return mesh

        def __exit__(self, *a):
            _LOCAL.stack.pop()
    return _Scope()


def current_mesh():
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None
