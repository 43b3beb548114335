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

Per-batch telemetry, as in the JAX package: with the span tracer enabled
each batch is a ``module.fit.batch`` span (histogram
``module.fit.batch.seconds``), counts in ``module.fit.batches``, records a
``batch_end`` event and sets the MFU gauges (``mfu.achieved_flops_per_sec``
and, on a card ``telemetry.mfu.PEAKS`` knows, ``mfu.model``) from the
step's FLOPs, which ``telemetry.mfu.cost_table`` and the optimizer's
update count once per ``fit``. One difference the card forces: CUDA
launches return before the work is done, so on a CUDA binding the span
closes after ``torch.cuda.synchronize()`` — its duration is the batch's
time to completion, not its enqueue time. With the tracer off (the
default) the loop adds no synchronization and notes each batch in the
flight-recorder ring.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import metric as metric_mod
from .. import ndarray as nd
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..model import BatchEndParam
from ..ops.cost import optimizer_flops

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
        self._mfu_profile = self._build_mfu_profile(train_data)
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            start = time.time()
            eval_metric.reset()
            for nbatch, batch in enumerate(train_data):
                self._fit_batch(epoch, nbatch, batch,
                                getattr(train_data, "batch_size", 0))
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

    def _fit_batch(self, epoch, nbatch, batch, batch_size):
        """One training batch with its telemetry (see the module's
        docstring)."""
        traced = _telemetry.enabled()
        batch_span = _telemetry.span(
            "module.fit.batch", _hist="module.fit.batch.seconds",
            epoch=epoch, nbatch=nbatch)
        t0 = time.perf_counter_ns()
        with batch_span:
            self.forward_backward(batch)
            self.update()
            dev = self._bound_device()
            if traced and dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if traced:
            _telemetry.counter("module.fit.batches").inc()
            _telemetry.record_event(
                "batch_end", epoch=epoch, nbatch=nbatch,
                duration_us=batch_span.dur, batch_size=batch_size)
            self._note_mfu(batch_span.dur)
        else:
            _telemetry.flightrec.note(
                "module.fit.batch", epoch=epoch, nbatch=nbatch,
                dur_us=(time.perf_counter_ns() - t0) // 1000,
                batch_size=batch_size)

    def _bound_device(self):
        """The torch device of the (one) bound context, or None."""
        ctxs = getattr(self, "_context", None)
        return ctxs[0].torch_device() if ctxs else None

    def _build_mfu_profile(self, train_data):
        """(train FLOPs per batch, peak FLOP/s or None): the op cost
        metadata folded over the bound graph plus the optimizer's update
        — the per-batch MFU gauges' numerator and denominator. Also sets
        ``mfu.node_coverage``, ``mfu.flops_per_step`` (the graph's train
        FLOPs, without the update) and the per-op ``mfu.op.*`` gauges.
        None when the graph's shapes cannot be inferred from the data's
        (the gauges then stay unset rather than guessed). The peak is the
        bound card's, from ``telemetry.mfu.PEAKS``; None on the CPU."""
        sym = self.symbol
        if sym is None:
            return None
        shapes = {name: tuple(shape) for name, shape in
                  list(train_data.provide_data) +
                  list(train_data.provide_label or [])}
        try:
            table = _telemetry.mfu.cost_table(sym, shapes, train=True)
        except MXNetError:
            return None
        flops = table["train_flops"]
        if not flops:
            return None
        opt = getattr(self, "_optimizer", None)
        if opt is not None:
            n_params = sum(int(np.prod(a.shape)) for a in
                           (getattr(self, "_arg_params", None) or {}).values())
            flops += optimizer_flops(type(opt).__name__, n_params)
        dev = self._bound_device()
        peak = None
        if dev is not None and dev.type == "cuda":
            peak, _bw = _telemetry.mfu.device_peaks(
                torch.cuda.get_device_name(dev))
        _telemetry.mfu.record_gauges(table, train=True)
        return flops, peak

    def _note_mfu(self, dur_us):
        """The per-batch MFU gauges: train FLOPs over the measured batch
        time, and that rate over the card's peak where one is known."""
        prof = getattr(self, "_mfu_profile", None)
        if not prof or not dur_us:
            return
        flops, peak = prof
        rate = flops / (dur_us / 1e6)
        _telemetry.gauge("mfu.achieved_flops_per_sec").set(rate)
        if peak:
            _telemetry.gauge("mfu.model").set(rate / peak)

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
