"""Parallelism layer: the mesh, the SPMD plan, ring attention.

The port of ``mxnet_tpu/parallel/`` for the sequence-parallel training
path: ``Module.fit(spmd=True, mesh=MeshConfig(seq=n))`` lowers the
``attention`` op to ring attention over the mesh's ``seq`` axis, driven
from one process over one device (``[mx.gpu(0)] * n`` on the card,
``[mx.cpu(i) for i in range(n)]`` on the host). The rest of the JAX
package's layer — the other collectives, placement over a ``model``
axis, ZeRO, and sharding over distinct GPUs — is the multi-GPU slice
(``ROADMAP.md`` A8).
"""
from .mesh import (MeshConfig, Mesh, build_mesh, current_mesh, mesh_scope,
                   DEFAULT_AXES)
from .collectives import axis_size, ppermute
from .spmd import SpmdPlan, active_plan, plan_scope
from .ring_attention import attention, ring_attention, ring_attention_sharded
