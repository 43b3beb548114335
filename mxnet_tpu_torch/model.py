"""Checkpoint helpers and the single-device kvstore decision.

``save_checkpoint`` / ``load_checkpoint`` write and read
``prefix-symbol.json`` + ``prefix-NNNN.params`` in the reference's
container, so either package loads what the other saved.
``_create_kvstore`` is the single-device part of the JAX package's
decision: one device with a ``"local"`` (or ``"device"``) store, or no
store, trains without a store; a distributed store or several contexts
raise until the multi-device slice is ported.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device):
    """(kvstore, update_on_kvstore) for a single-device binding: always
    (None, False); anything that needs a store raises."""
    if num_device != 1:
        raise MXNetError(f"the port trains on one device, got {num_device} "
                         "contexts (data parallelism is a later slice)")
    if kvstore is None or (isinstance(kvstore, str) and
                           "dist" not in kvstore):
        return None, False
    raise MXNetError(f"kvstore {kvstore!r}: the port has no kvstore yet; "
                     "train on one device with kvstore='local'")


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save prefix-symbol.json + prefix-%04d.params."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) from a saved checkpoint; the
    arrays land on the CPU."""
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd.load(f"{prefix}-{epoch:04d}.params").items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
