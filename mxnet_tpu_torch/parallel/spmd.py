"""SpmdPlan: the binding's mesh and the layout rules read from it.

The port of ``mxnet_tpu/parallel/spmd.py``'s plan for what the
sequence-parallel path needs. ``Module.fit(spmd=True, mesh=MeshConfig(
seq=n))`` builds one over the bound contexts; the executor arms it
(``plan_scope``) around its forward and backward, and the ``attention``
op reads it (``active_plan``) to lower to ring attention over the mesh's
``seq`` axis, with the batch split over ``data`` as well when the mesh
has both.

Every parameter is replicated, and every op other than attention runs
unpartitioned on the mesh's first context. That is only honest when the
contexts name one device, so a plan over contexts on two distinct
devices raises, as does a ``model``, ``pipe`` or ``expert`` axis longer
than 1: partitioning the rest of the graph over distinct GPUs, with the
gradient reduction, is the multi-GPU slice (``ROADMAP.md`` A8). One card
named several times (``[mx.gpu(0)] * 4``) and the host's CPU
(``[mx.cpu(i) for i in range(4)]``) are one device each.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from ..base import MXNetError
from .mesh import MeshConfig, build_mesh

__all__ = ["SpmdPlan", "active_plan", "plan_scope"]

#: the mesh axes a plan takes (any other axis longer than 1 raises), and
#: the token batch's axis they split: ``data`` on it, ``seq`` on the next
DATA_AXIS, SEQ_AXIS = "data", "seq"
BATCH_AXIS = 0

_TLS = threading.local()


def active_plan():
    """The SpmdPlan armed around the executor's current forward or
    backward (None outside a plan scope)."""
    return getattr(_TLS, "plan", None)


@contextlib.contextmanager
def plan_scope(plan):
    """Install ``plan`` as the active plan for the duration."""
    prev = getattr(_TLS, "plan", None)
    _TLS.plan = plan
    try:
        yield plan
    finally:
        _TLS.plan = prev


def _device_key(ctx):
    """What a context names as a device, without touching CUDA: the
    host's CPU whatever its id, or one CUDA device."""
    return ("cpu",) if ctx.device_type == "cpu" else ("gpu", ctx.device_id)


def _check_one_device(contexts):
    """Raise unless ``contexts`` name one device (see the module
    docstring)."""
    devices = sorted({_device_key(c) for c in contexts})
    if len(devices) > 1:
        raise MXNetError(
            f"contexts {list(contexts)} name {len(devices)} distinct devices:"
            " the port's spmd plan runs every op but attention on the first "
            "context, so its contexts must name one device; partitioning "
            "over distinct GPUs is the multi-GPU slice (ROADMAP.md A8)")


class SpmdPlan:
    """Mesh and layout rules of one SPMD binding."""

    data_axis, seq_axis = DATA_AXIS, SEQ_AXIS

    def __init__(self, mesh):
        extra = {a: n for a, n in mesh.shape.items()
                 if a not in (DATA_AXIS, SEQ_AXIS) and n > 1}
        if extra:
            raise MXNetError(
                f"mesh axes {extra}: the port's spmd plan takes a data and a "
                "seq axis; model, pipe and expert parallelism are the "
                "multi-GPU slice (ROADMAP.md A8)")
        _check_one_device(mesh.devices.flat)
        self.mesh = mesh

    @staticmethod
    def build_mesh_for(devices, config=None):
        """The binding's mesh: explicit MeshConfig > ``MXNET_MESH_*`` env
        > a 1-D data axis over every bound context."""
        devices = list(devices)
        if config is None:
            config = MeshConfig.from_env(len(devices))
        if config is None:
            config = MeshConfig(data=len(devices))
        return build_mesh(config, devices=devices)

    def data_spec_for(self, shape):
        """The token batch's layout, as a tuple of axis names (None for a
        dimension that is not split): ``data`` on the batch axis, and
        ``seq`` on the next one when the mesh has a ``seq`` axis longer
        than 1 that divides it — ``P(data, seq)`` in the JAX package."""
        spec = [None] * len(shape)
        if BATCH_AXIS < len(shape):
            spec[BATCH_AXIS] = DATA_AXIS
        n_seq = self.n_seq_shards()
        s = BATCH_AXIS + 1
        if n_seq > 1 and s < len(shape) and shape[s] >= n_seq and \
                shape[s] % n_seq == 0:
            spec[s] = SEQ_AXIS
        return tuple(spec)

    def n_data_shards(self):
        return int(self.mesh.shape.get(DATA_AXIS, 1))

    def n_seq_shards(self):
        return int(self.mesh.shape.get(SEQ_AXIS, 1))

    def n_devices(self):
        return int(np.prod(list(self.mesh.shape.values())))

    def describe(self):
        """Summary for diagnostics: the JAX package's keys (no parameter
        is sharded, ZeRO is not ported) and the seq axis."""
        return {"mesh": dict(self.mesh.shape), "data_axis": DATA_AXIS,
                "seq_axis": SEQ_AXIS, "sharded_params": {},
                "replicated_tagged": {}, "zero": False}
