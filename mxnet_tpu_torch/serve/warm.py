"""Serve warm restart: checkpoint the registry, rebuild after re-exec.

The port's counterpart of ``mxnet_tpu/serve/warm.py``. Training survives a
kill because ``CheckpointManager`` owns an atomically committed copy of
everything a resume needs; this module gives ``InferenceServer`` the same
property: per model the symbol (JSON), the trained params (numpy), the
per-row input shapes and label names, the bucket ladder and the compute
dtype — or, for a ``PredictorEngine``, its artifact's path — plus the
server's admission settings, ride through
``CheckpointManager.save_payload`` as the JAX package's ``kind="serve"``
payload into the same commit directories (training and serving state can
share one root; readers filter by kind). A quantized engine persists its
already-quantized symbol and weights (fp8 weights as their exact float32
values: the payload holds numpy types only), so a restore binds without
quantizing again.

After a re-exec, :func:`restore_server` reads the newest *readable* serve
commit and registers every model again — which runs warmup, loading every
kernel library each rung needs — and returns a server that serves with
zero kernel builds beyond warmup (``compiles_since_warmup() == 0``), the
same contract a first boot makes. A commit of either package restores in
the other.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .engine import BucketEngine, PredictorEngine
from .server import InferenceServer

__all__ = ["save_server", "restore_server", "server_payload"]

log = logging.getLogger(__name__)


def server_payload(server):
    """The serve-state dict one commit persists (numpy/JSON only — the
    writer thread pickles it as-is)."""
    from ..checkpoint.state import FORMAT_VERSION
    models = {}
    for entry in server._registry.entries():
        eng = entry.engine
        name = eng.name
        if isinstance(eng, BucketEngine):
            arg, aux = eng._bm.get_params()
            cdt = eng._compute_dtype
            models[name] = {
                "type": "bucket",
                "symbol": eng._symbol.tojson(),
                "arg_params": {k: v.asnumpy() for k, v in arg.items()},
                "aux_params": {k: v.asnumpy() for k, v in aux.items()},
                "data_shapes": {nm: tuple(s) for nm, s in
                                eng.example_shapes.items()},
                "label_names": list(eng._label_names),
                "ladder": list(eng.ladder.sizes),
                "compute_dtype": None if cdt is None else
                str(cdt).replace("torch.", ""),
                # int8 engines persist the ALREADY-quantized symbol +
                # params (compute_dtype is None by then), so restore
                # re-binds without re-quantizing; recorded for audit
                "quantized": eng.quantized,
            }
        elif isinstance(eng, PredictorEngine) and eng._path is not None:
            models[name] = {"type": "predictor", "path": eng._path}
        else:
            log.warning(
                "serve checkpoint: model %r has no persistable source "
                "(a Predictor without an artifact path); it "
                "will be missing after a warm restart", name)
    return {
        "version": FORMAT_VERSION,
        "kind": "serve",
        "cursor": {"epoch": 0, "nbatch": 0},
        "server": {
            "max_queue": server._max_queue,
            "default_deadline_ms": int(server._default_deadline_s * 1000),
            "shed_depth": server._shed_depth,
        },
        "models": models,
    }


def save_server(server, manager, block=True):
    """Commit the server's registry/config through ``manager`` (a
    ``CheckpointManager`` or a directory string); returns the seq."""
    from ..checkpoint import CheckpointManager
    owned = False
    if not isinstance(manager, CheckpointManager):
        manager = CheckpointManager(str(manager))
        owned = True
    try:
        return manager.save_payload(server_payload(server), block=block)
    finally:
        if owned:
            manager.close()


def restore_server(directory, clock=None, start=False, context=None,
                   **server_kw):
    """Rebuild an ``InferenceServer`` from the newest readable
    ``kind="serve"`` commit in ``directory``.

    Registering each model again runs warmup (every rung, which loads
    the kernel libraries it needs), after which steady-state serving
    builds nothing: ``compiles_since_warmup()`` stays 0. ``server_kw``
    overrides the persisted server settings; ``context`` places the
    restored models (default: the current context).
    """
    from ..checkpoint import read_committed_payload
    from ..context import cpu
    from ..convert import params_from_numpy
    from ..symbol import load_json

    found = read_committed_payload(directory, kind="serve")
    if found is None:
        raise MXNetError(
            f"no committed serve state under {directory!r} "
            "(was InferenceServer.checkpoint_to ever called?)")
    seq, path, payload = found
    saved = payload.get("server") or {}
    kw = {"max_queue": saved.get("max_queue"),
          "default_deadline_ms": saved.get("default_deadline_ms")}
    kw.update(server_kw)
    server = InferenceServer(clock=clock, **kw)
    for name, rec in (payload.get("models") or {}).items():
        if rec["type"] == "predictor":
            server.register(name, predictor=rec["path"], context=context)
            continue
        server.register(
            name,
            symbol=load_json(rec["symbol"]),
            arg_params=params_from_numpy(rec["arg_params"], cpu()),
            aux_params=params_from_numpy(rec["aux_params"], cpu()),
            data_shapes=rec["data_shapes"],
            label_names=rec["label_names"] or None,
            ladder=rec["ladder"],
            context=context,
            compute_dtype=rec.get("compute_dtype"))
    log.info("serve: warm-restarted %d model(s) from %s (seq %d)",
             len(payload.get("models") or {}), path, seq)
    if start:
        server.start()
    return server
