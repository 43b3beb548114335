"""Full-training-state capture and exact restore.

The port's counterpart of ``mxnet_tpu/checkpoint/state.py``, writing and
reading the JAX package's payload: a pickle of numpy arrays and Python
values, never a torch tensor, so either package resumes the other's
checkpoint. What a training run is — parameters and aux states, the
optimizer states by parameter name, the update counts (Adam's bias
correction, lr schedules), the random chains (``mx.random``'s key, the
training step's own key, numpy's and the stdlib's generators) and the
epoch/batch cursor — is captured in two phases:

* :func:`capture` runs on the TRAINING thread and is cheap: every bound
  tensor is copied on its own device in one grouped call a (device,
  dtype) group (``torch._foreach_copy_`` into new buffers: one
  multi-tensor launch on the card). The copy is mandatory, not
  defensive — ``Module.update`` rewrites the weights and states in place
  (the ``sgd_mom_multi`` / ``adam_multi`` kernels), so a snapshot that
  held references would be torn by the next step. On the card the copy is
  left running behind a recorded CUDA event; host-side scalars (counts,
  cursors, random states) are read synchronously.
* :func:`to_host` runs on the checkpoint WRITER thread: it makes a side
  stream wait on that event and copies the snapshot into pinned host
  buffers there, so the transfer neither queues behind the training
  kernels on the default stream nor delays them, then hands back the
  pure-numpy payload.

Optimizer states are in the JAX package's canonical layout: by parameter
NAME, ``()`` when stateless, one array for SGD-momentum, ``(mean, var)``
for Adam. The port's updater is the staged one (``opt.mode`` is
``"staged"``); :func:`restore` takes a ``"fused"`` payload of the JAX
package as well, since both carry the same canonical states.

:func:`restore` is the inverse: parameters, optimizer states and counts,
the random chains — the training step's key re-tagged with the current
generation so it is not drawn again at once — returning the cursor so
``Module.fit(resume=...)`` continues bit for bit.
"""
from __future__ import annotations

import logging
import pickle
import random as _pyrandom

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray
from .. import faults as _faults
from .. import random as _mxrandom

__all__ = ["FORMAT_VERSION", "capture", "to_host", "restore",
           "write_payload", "read_payload", "dumps_payload",
           "loads_payload"]

FORMAT_VERSION = 1

log = logging.getLogger(__name__)

#: device -> the writer's side stream for device-to-host copies
_D2H_STREAMS = {}


def _copy_all(tensors):
    """Exclusively owned copies of ``tensors``, made on their devices:
    one ``torch._foreach_copy_`` a (device, dtype) group, into fresh
    buffers. Returns (copies in order, the CUDA events that mark the
    copies done, one a device)."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = [None] * len(tensors)
    events = {}
    for (dev, _dtype), idx in groups.items():
        src = [tensors[i] for i in idx]
        dst = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for t in src]
        torch._foreach_copy_(dst, src)
        for i, d in zip(idx, dst):
            out[i] = d
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events[dev] = ev
    return out, events


def _canon_state(v):
    """One parameter's staged state in canonical form: ``()`` when
    stateless, a tensor for one buffer, a tuple for several (Adam)."""
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(_canon_state(x) for x in v)
    return v.astorch()


def _flatten(tree, leaves):
    """The tensors of a nested dict / tuple tree (None kept as None)
    appended to ``leaves``; returns the tree with each tensor replaced by
    its position there."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_flatten(v, leaves) for v in tree)
    leaves.append(tree)
    return _Leaf(len(leaves) - 1)


class _Leaf(int):
    """A leaf position in a flattened snapshot tree."""


def _unflatten(tree, leaves):
    if isinstance(tree, _Leaf):
        return leaves[tree]
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_unflatten(v, leaves) for v in tree)
    return tree


def capture(module, epoch=0, nbatch=0):
    """Snapshot the module's full training state (device-side, fast).

    ``nbatch`` is the NEXT batch index of ``epoch`` — the cursor a
    resumed fit starts from. Returns the snapshot ``to_host`` finishes
    on the writer thread."""
    from ..module.module import Module
    if not isinstance(module, Module) or \
            getattr(module, "_exec_group", None) is None:
        raise MXNetError(
            "checkpoint capture needs a Module bound to an executor group "
            f"({type(module).__name__} modules are not supported)")
    assert module.binded and module.params_initialized, \
        "capture() needs a bound, initialized module"
    exe = module._exec_group.executor

    arg = {nm: exe.arg_dict[nm].astorch()
           for nm in module._param_names if nm in exe.arg_dict}
    aux = {nm: a.astorch() for nm, a in exe.aux_dict.items()}

    opt_mode, opt_states, opt_counts, opt_class = None, None, None, None
    if module.optimizer_initialized and module._updater is not None:
        opt_mode = "staged"
        opt_class = type(module._optimizer).__name__
        opt_counts = module._opt_counts()
        names = module._param_names
        opt_states = {names[i]: _canon_state(st)
                      for i, st in module._updater.states.items()
                      if isinstance(i, int) and 0 <= i < len(names)}

    leaves = []
    tree = _flatten({"arg_params": arg, "aux_params": aux,
                     "opt_states": opt_states}, leaves)
    copies, events = _copy_all(leaves)
    device = _unflatten(tree, copies)

    rng = {
        "mx": _mxrandom.get_state(),
        "device_chain": module.rng_chain(),
        "numpy": np.random.get_state(),
        "python": _pyrandom.getstate(),
    }
    return {
        "version": FORMAT_VERSION,
        "cursor": {"epoch": int(epoch), "nbatch": int(nbatch)},
        "device": device,
        "_events": events,          # device-side only, not serialized
        "opt": {"mode": opt_mode, "class": opt_class, "counts": opt_counts},
        "rng": rng,
    }


def _d2h_stream(dev):
    st = _D2H_STREAMS.get(dev)
    if st is None:
        st = _D2H_STREAMS[dev] = torch.cuda.Stream(dev)
    return st


def _host_array(t):
    """A CPU tensor as numpy. bfloat16 widens to float32 exactly (the
    payload holds numpy types only, and numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    elif t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise MXNetError(f"checkpoint: no numpy type holds {t.dtype}")
    return t.numpy()


def to_host(snapshot):
    """Device -> host the captured copies (blocks; runs on the writer
    thread). On the card each device's copies go through a side stream
    that first waits on the capture's event, into pinned host buffers.
    Returns the pure-numpy payload ``write_payload`` pickles."""
    _faults.point("ckpt.d2h")
    payload = {k: v for k, v in snapshot.items() if k != "_events"}
    leaves = []
    tree = _flatten(snapshot["device"], leaves)
    host = [None] * len(leaves)
    by_dev = {}
    for i, t in enumerate(leaves):
        if t.device.type == "cuda":
            by_dev.setdefault(t.device, []).append(i)
        else:
            host[i] = t
    for dev, idx in by_dev.items():
        stream = _d2h_stream(dev)
        ev = snapshot.get("_events", {}).get(dev)
        if ev is not None:
            stream.wait_event(ev)
        with torch.cuda.stream(stream):
            for i in idx:
                h = torch.empty(leaves[i].shape, dtype=leaves[i].dtype,
                                pin_memory=True)
                h.copy_(leaves[i], non_blocking=True)
                host[i] = h
        stream.synchronize()
    payload["device"] = _unflatten(tree, [_host_array(h) for h in host])
    return payload


def write_payload(payload, fobj):
    pickle.dump(payload, fobj, protocol=pickle.HIGHEST_PROTOCOL)


def dumps_payload(payload):
    """Serialized payload bytes — the writer hashes these into the
    manifest (``sha256``) so a read can tell torn or bit-rotted state
    from intact state: a flipped byte mid-pickle often still
    *unpickles*, into silently wrong arrays."""
    return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def _check_version(payload):
    version = payload.get("version")
    if version != FORMAT_VERSION:
        raise MXNetError(
            f"checkpoint format version {version!r} is not supported "
            f"by this build (expected {FORMAT_VERSION})")
    return payload


def loads_payload(data, sha256=None):
    """Inverse of :func:`dumps_payload`; verifies the manifest checksum
    first when one is recorded."""
    if sha256 is not None:
        import hashlib
        got = hashlib.sha256(data).hexdigest()
        if got != sha256:
            raise MXNetError(
                f"checkpoint state.pkl checksum mismatch "
                f"(manifest {sha256[:12]}…, file {got[:12]}…): "
                "damaged on disk")
    return _check_version(pickle.loads(data))


def read_payload(fobj):
    return _check_version(pickle.load(fobj))


def _tensor(v, like=None):
    """A writable tensor of a payload array, on ``like``'s device and of
    its dtype when given."""
    t = torch.from_numpy(np.array(v, copy=True))
    if like is not None:
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def _to_staged_state(v, weight):
    """Canonical state -> the staged updater's representation: None when
    stateless (plain SGD), else NDArray cells on the weight's device."""
    if isinstance(v, (tuple, list)):
        if len(v) == 0:
            return None
        return tuple(_to_staged_state(x, weight) for x in v)
    return NDArray(_tensor(v, weight.astorch()), ctx=weight.context)


def restore(module, payload):
    """Reinstate a ``to_host`` payload (the port's or the JAX package's)
    into a bound module; returns the cursor dict ``{"epoch": e,
    "nbatch": b}``.

    The module must already be through bind / init_params (and
    init_optimizer, for optimizer states to land) — exactly where
    ``Module.fit`` is after preparing."""
    dev = payload["device"]
    module.set_params({nm: np.array(v) for nm, v in
                       dev["arg_params"].items()},
                      {nm: np.array(v) for nm, v in
                       dev["aux_params"].items()},
                      allow_missing=False, force_init=True)

    opt = payload.get("opt") or {}
    states = dev.get("opt_states")
    if states is not None and module.optimizer_initialized:
        saved_cls = opt.get("class")
        now_cls = type(module._optimizer).__name__
        if saved_cls and saved_cls != now_cls:
            log.warning("checkpoint optimizer state is %s but the run "
                        "uses %s; restoring anyway (state layouts must "
                        "match)", saved_cls, now_cls)
        weights = module._exec_group.param_arrays
        idx = {nm: i for i, nm in enumerate(module._param_names)}
        for nm, st in states.items():
            if nm in idx:
                module._updater.states[idx[nm]] = _to_staged_state(
                    st, weights[idx[nm]])
        if opt.get("counts"):
            module._restore_opt_counts(opt["counts"])

    rng = payload.get("rng") or {}
    if rng.get("mx") is not None:
        _mxrandom.set_state(rng["mx"])
    if rng.get("numpy") is not None:
        np.random.set_state(rng["numpy"])
    if rng.get("python") is not None:
        _pyrandom.setstate(rng["python"])
    chain = rng.get("device_chain")
    if chain is not None and module._step_key is not None:
        module.set_rng_chain(chain)
    return dict(payload["cursor"])
