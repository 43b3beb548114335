"""Collectives of the single-controller mesh.

The port of the two collectives of ``mxnet_tpu/parallel/collectives.py``
that ring attention needs. One process drives every position of the
mesh, so a value sharded along an axis is a Python list of per-shard
tensors, one per mesh position along that axis, each on its position's
device. ``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``barrier`` come with the multi-GPU slice (``ROADMAP.md`` A8).
"""
from __future__ import annotations

import torch

from .mesh import current_mesh

__all__ = ["axis_size", "ppermute"]


def axis_size(axis_name, mesh=None):
    """Size of ``axis_name`` in ``mesh`` (default: the current mesh); 1
    for an axis the mesh does not have."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("axis_size: no mesh given and none is current")
    return int(mesh.shape.get(axis_name, 1))


def ppermute(shards, perm, contexts):
    """Neighbor exchange: shard ``src`` moves to position ``dst`` for
    each ``(src, dst)`` pair of ``perm``, onto ``contexts[dst]``'s device
    (``.to``, which returns the tensor itself when the two positions
    share a device). A position no pair names receives zeros, as
    ``lax.ppermute`` gives."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(contexts[dst].torch_device())
    return [o if o is not None else
            torch.zeros_like(s, device=c.torch_device())
            for o, s, c in zip(out, shards, contexts)]
