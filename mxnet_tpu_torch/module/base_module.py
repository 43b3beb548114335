"""BaseModule: the train / evaluate interface every module carries.

``fit`` is the JAX package's core loop (reference base_module contract):
bind -> init_params -> init_optimizer, then per batch
``forward_backward`` / ``update`` / ``update_metric`` with the same
callback hook points, the train metric logged at each epoch end, the
epoch-end callbacks given the current parameters, and an optional
``score`` over ``eval_data``. The JAX package's arrangements around that
loop are not ported yet, and ``fit`` refuses each of them by name:
``spmd``, ``zero_stage``, ``steps_per_dispatch`` > 1, ``remat``,
``health``, ``elastic``, ``checkpoint`` / ``resume`` and ``monitor``.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..model import BatchEndParam

__all__ = ["BaseModule"]

#: fit() options of the JAX package that the port does not take yet,
#: each with the value that leaves it off
_NOT_PORTED = {"monitor": None, "steps_per_dispatch": 1, "zero_stage": 0,
               "spmd": False, "mesh": None, "checkpoint": None,
               "resume": False, "elastic": False, "remat": "none",
               "health": False}


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, param):
    for cb in _as_list(callbacks):
        cb(param)


class BaseModule:
    """The shared training and scoring loop; subclasses provide the
    executor plumbing."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------- training
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            **not_ported):
        """Train for ``num_epoch`` epochs over ``train_data``. The
        initializer defaults to ``Uniform(0.01)``."""
        from ..initializer import Uniform
        unknown = set(not_ported) - set(_NOT_PORTED)
        if unknown:
            raise TypeError(f"fit() got unexpected arguments "
                            f"{sorted(unknown)}")
        asked = sorted(k for k, v in not_ported.items()
                       if v is not None and v is not False
                       and not (type(v) is type(_NOT_PORTED[k])
                                and v == _NOT_PORTED[k]))
        if asked:
            raise MXNetError(f"fit({', '.join(asked)}=...): not ported to "
                             "the PyTorch package yet (ROADMAP.md)")
        if num_epoch is None:
            raise ValueError("fit() needs num_epoch")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            start = time.time()
            eval_metric.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    _fire(batch_end_callback,
                          BatchEndParam(epoch=epoch, nbatch=nbatch,
                                        eval_metric=eval_metric,
                                        locals=locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - start)
            arg_now, aux_now = self.get_params()
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_now, aux_now)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # ------------------------------------------------------------ evaluation
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run inference over ``eval_data`` accumulating ``eval_metric``;
        returns its (name, value) pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                nbatch -= 1
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=eval_metric,
                                    locals=locals()))
        if score_end_callback:
            _fire(score_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=nbatch + 1,
                                eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    # ---------------------------------------------------------- param files
    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        payload = {f"arg:{k}": v for k, v in arg_params.items()}
        payload.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(fname, payload)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise ValueError(
                    f"{fname} is not a param file (bad key {key!r})")
        self.set_params(arg_params, aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # ------------------------------------------------------ abstract surface
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError
