"""Optimizers: ``SGD`` and ``Adam`` over the update ops, and the updater.

The JAX package's contract: ``Optimizer.create_optimizer`` by name,
``create_state`` / ``update`` per weight index, ``lr_mult`` / ``wd_mult``
(from ``__lr_mult__`` / ``__wd_mult__`` symbol attributes; every
parameter whose name ends neither in ``_weight`` nor ``_gamma`` — biases,
betas — gets wd 0), ``rescale_grad``, ``clip_gradient``, a per-index
update count, and ``get_updater`` for the module's update path.

``update`` is ONE op call per weight, as the reference calls
``mx.nd.sgd_mom_update``: on the card ``sgd_mom_update`` and
``adam_update`` launch their CUDA kernels, which update the weight and
its state in place. ``update_multi`` is a whole step's update, the
module's path: SGD with momentum and Adam make one multi-tensor call
(``cuda_kernels.sgd_mom_update_multi`` / ``adam_update_multi``, one
launch on the card) with per-index lr and wd computed in the per-index
order, as the JAX package's fused step takes them
(``Module._fused_lr_wd`` there); every other case updates index by
index.
"""
from __future__ import annotations

import math

import torch

from .ndarray import NDArray, imperative_invoke
from .ops import cuda_kernels as ck

__all__ = ["Optimizer", "SGD", "Adam", "create", "get_updater", "Updater",
           "register"]


class Optimizer:
    """Base optimizer."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """One step over ``indices`` (with their weights, gradients and
        states), in their order. Here index by index; an optimizer with a
        multi-tensor kernel overrides it."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    def _lrs_wds(self, indices, scale=None):
        """Per-index lr and wd in the per-index update's order: each
        index's lr and wd are read before its update count advances, so
        a scheduler step inside the list moves only the later indices;
        ``scale(t)`` (Adam's bias correction) multiplies the lr at the
        index's new count t."""
        lrs, wds = [], []
        for i in indices:
            lr = self._get_lr(i)
            wds.append(self._get_wd(i))
            self._update_count(i)
            if scale is not None:
                lr *= scale(self._index_update_count[i])
            lrs.append(lr)
        return lrs, wds

    def _sym_mult(self, key):
        out = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mult("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Biases, betas and every other non-weight, non-gamma parameter
        default to wd_mult 0."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight")
                                or n.endswith("_gamma"))}
        self.wd_mult.update(self._sym_mult("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0


register = Optimizer.register
create = Optimizer.create_optimizer


def _state_like(weight):
    """A zero state cell on the weight's device, of its dtype."""
    return NDArray(torch.zeros_like(weight.astorch()), ctx=weight.context)


@register
class SGD(Optimizer):
    """SGD, with momentum through ``sgd_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _state_like(weight)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        if state is not None:
            imperative_invoke("sgd_mom_update", weight, grad, state,
                              momentum=self.momentum, **kwargs)
        else:
            imperative_invoke("sgd_update", weight, grad, **kwargs)

    def update_multi(self, indices, weights, grads, states):
        """One ``sgd_mom_update_multi`` call over the step; without
        momentum (no state: the plain ``sgd_update``, which has no kernel)
        index by index."""
        if any(s is None for s in states):
            return super().update_multi(indices, weights, grads, states)
        lrs, wds = self._lrs_wds(indices)
        with torch.no_grad():
            ck.sgd_mom_update_multi(
                [w.astorch() for w in weights], [g.astorch() for g in grads],
                [s.astorch() for s in states], lrs, wds, self.momentum,
                self.rescale_grad, self._clip())


@register
class Adam(Optimizer):
    """Adam (Kingma & Ba) through ``adam_update``, the bias correction
    folded into the step's learning rate:
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` at update count t."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_state_like(weight), _state_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        lr *= self._bias_correction(self._index_update_count[index])
        mean, var = state
        imperative_invoke("adam_update", weight, grad, mean, var, lr=lr,
                          wd=wd, beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.epsilon,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=self._clip())

    def update_multi(self, indices, weights, grads, states):
        """One ``adam_update_multi`` call over the step."""
        lrs, wds = self._lrs_wds(indices, self._bias_correction)
        with torch.no_grad():
            ck.adam_update_multi(
                [w.astorch() for w in weights], [g.astorch() for g in grads],
                [s[0].astorch() for s in states],
                [s[1].astorch() for s in states], lrs, wds, self.beta1,
                self.beta2, self.epsilon, self.rescale_grad, self._clip())

    def _bias_correction(self, t):
        """The lr multiplier at update count t, in double."""
        return math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)


class Updater:
    """Per-index state, created at the first update of each index."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_multi(self, indices, grads, weights):
        """Every listed index in one step (``Optimizer.update_multi``),
        each missing state created first as ``__call__`` creates it."""
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])


def get_updater(optimizer):
    return Updater(optimizer)
