"""Checkpointing: full training state, atomically committed.

The port's counterpart of ``mxnet_tpu/checkpoint``, in the JAX package's
on-disk format (a checkpoint either package commits resumes in the
other):

* ``checkpoint.state`` — full-training-state capture / restore
  (parameters, optimizer states by name and update counts, the random
  chains, the data cursor): a fast device-side capture on the training
  thread and a slow host phase on the writer thread;
* ``checkpoint.manager`` — :class:`CheckpointManager`: async snapshots off
  the training thread, versioned atomically committed checkpoint
  directories, ``keep_last`` retention, the ``MXNET_CKPT_*`` environment.
  ``Module.fit(checkpoint=..., resume=...)`` drives it.

The JAX package's ``checkpoint.recovery`` (dead-worker detection and the
survivor re-exec) comes with the multi-process kvstore (ROADMAP.md A8).
"""
from . import state
from . import manager
from .state import capture, restore, to_host, FORMAT_VERSION
from .manager import (CheckpointManager, latest_checkpoint,
                      restore_module, read_committed_payload)

__all__ = [
    "state", "manager",
    "capture", "restore", "to_host", "FORMAT_VERSION",
    "CheckpointManager", "latest_checkpoint", "restore_module",
    "read_committed_payload",
]
