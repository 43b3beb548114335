"""Imperative autograd: MXNet's contrib API on PyTorch's autograd.

The JAX package records imperative ops on a tape and replays it under
``jax.vjp`` (``mxnet_tpu/autograd.py``). PyTorch records as it runs, so
there is no tape here: inside ``train_section()`` every imperative op
(``imperative_invoke``, the NDArray operators) runs under
``torch.enable_grad()`` with ``is_train=True``, and ``backward`` hands
the outputs to ``torch.autograd.grad``. Outside a train section they
run under ``torch.no_grad()`` with ``is_train=False`` and record
nothing.

``mark_variables`` turns each variable's tensor into a leaf that
requires grad and remembers its gradient cell and request. A marked
variable stays a leaf: whatever ``NDArray._set`` later swaps into it
(``x[:] = v``, ``x -= lr * g``, an optimizer update) becomes a fresh
leaf, and ``backward`` differentiates the value the variable holds when
the outputs were computed from it. ``backward`` writes only the
variables its outputs reach (``write`` replaces the cell, ``add`` adds
to it, ``null`` leaves it); every other cell stays as it was.

Divergence from the JAX package, by design: inside a train section the
JAX package runs an op with ``is_train=False`` and records a replay
with ``is_train=True``, so a BatchNorm there returns its inference-mode
value beside the gradient of its training-mode forward. Here, as in
MXNet, the value and the gradient come from one training-mode forward
(``ROADMAP.md`` §C has the numbers). Ops that ignore ``is_train`` agree
with the JAX package exactly.

``grad_and_loss`` and ``grad`` record with training off: ``func`` runs
with ``is_train=False`` (a BatchNorm takes its moving statistics and
updates none), value and gradient from that one forward, as the JAX
package differentiates ``func`` under ``jax.vjp`` outside any train
section.
"""
from __future__ import annotations

import functools
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError
from .ndarray import NDArray, array

__all__ = ["grad_and_loss", "grad", "mark_variables", "backward",
           "train_section", "test_section", "set_is_training",
           "is_training"]

#: "train": ops run with is_train=True; "record": imperative ops record
#: autograd history. A train section sets both, ``grad_and_loss`` records
#: with training off
_STATE = {"train": False, "record": False}
#: id -> every variable marked and still alive (its ``_grad`` holds the
#: cell); keyed by id, as the JAX package keys its marks, because an
#: NDArray's ``==`` is elementwise and a set would compare arrays
_MARKED = weakref.WeakValueDictionary()


def set_is_training(is_train):
    """Switch training and recording on or off together; returns the
    previous training state."""
    prev = _STATE["train"]
    _STATE["train"] = _STATE["record"] = bool(is_train)
    return prev


def is_training():
    return _STATE["train"]


def is_recording():
    """True where imperative ops record autograd history: inside a train
    section, and inside ``grad_and_loss``'s call of its function."""
    return _STATE["record"]


@contextmanager
def _state(train, record):
    prev = dict(_STATE)
    _STATE.update(train=train, record=record)
    try:
        yield
    finally:
        _STATE.update(prev)


def train_section():
    """Record imperative ops (and run them with ``is_train=True``)."""
    return _state(True, True)


def test_section():
    """Stop recording inside a train section."""
    return _state(False, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf that ``backward`` differentiates, its
    gradient written into the matching cell under ``grad_reqs``
    (``"write"``, ``"add"`` or ``"null"``; one for all or one each)."""
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, cell, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        if not var.astorch().is_floating_point():
            raise MXNetError(f"mark_variables: a {var.astorch().dtype} "
                             "array has no gradient")
        var._grad = (cell, req)
        var._data = var._data.detach().requires_grad_(True)
        _MARKED[id(var)] = var


def _heads(outputs, out_grads):
    """(output tensors, head gradients): ones unless given."""
    outs = [o.astorch() for o in outputs]
    if out_grads is None:
        return outs, [torch.ones_like(o) for o in outs]
    if isinstance(out_grads, NDArray):
        out_grads = [out_grads]
    heads = [(g.astorch() if isinstance(g, NDArray)
              else torch.as_tensor(g)).to(o.device, o.dtype)
             for g, o in zip(out_grads, outs)]
    return outs, heads


def _grads(outs, heads, inputs, retain_graph=False):
    """The gradients of the outputs that carry autograd history with
    respect to ``inputs``: None for each input they do not reach."""
    pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
    if not pairs or not inputs:
        return [None] * len(inputs)
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [h for _, h in pairs],
                               retain_graph=retain_graph, allow_unused=True)


def backward(outputs, out_grads=None, retain_graph=False):
    """Differentiate ``outputs`` (recorded inside a train section) back to
    the marked variables they reach, with ``out_grads`` as the head
    gradients (default ones), and write each gradient into its cell by
    the variable's request. ``retain_graph`` keeps the recorded graph for
    another ``backward``."""
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    outs, heads = _heads(outputs, out_grads)
    if not any(o.requires_grad for o in outs):
        raise MXNetError(
            "backward() got outputs that no recorded op produced: run the "
            "computation inside a train_section() with variables marked "
            "first")
    marked = [v for v in list(_MARKED.values()) if v._data.requires_grad]
    grads = _grads(outs, heads, [v._data for v in marked], retain_graph)
    for var, g in zip(marked, grads):
        cell, req = var._grad
        if g is None or req == "null" or cell is None:
            continue
        g = g.to(cell.astorch().dtype)
        cell._set(cell.astorch() + g if req == "add" else g)


def grad_and_loss(func, argnum=None):
    """``func``'s gradients and outputs: the returned function runs
    ``func`` recording, with training off (``is_train=False``, as the
    JAX package runs it), on fresh leaves over its arguments (the
    arguments' own handles stay untouched) and differentiates its
    outputs with ones as head gradients. ``argnum`` (an int or a tuple)
    picks the arguments whose gradients it returns; default all."""
    @functools.wraps(func)
    def wrapped(*args):
        args = [a if isinstance(a, NDArray) else array(a) for a in args]
        argnums = tuple(range(len(args))) if argnum is None else \
            ((argnum,) if isinstance(argnum, int) else tuple(argnum))
        leaves = [a.astorch().detach().requires_grad_(True) for a in args]
        with _state(False, True):
            out = func(*[NDArray(t, ctx=a.context)
                         for t, a in zip(leaves, args)])
        many = isinstance(out, (list, tuple))
        outs = list(out) if many else [out]
        tensors, heads = _heads(outs, None)
        got = _grads(tensors, heads, [leaves[i] for i in argnums])
        grads = [NDArray(torch.zeros_like(leaves[i]) if g is None else g,
                         ctx=args[i].context)
                 for i, g in zip(argnums, got)]
        results = [NDArray(t.detach(), ctx=o.context)
                   for t, o in zip(tensors, outs)]
        return grads, (results if many else results[0])
    return wrapped


def grad(func, argnum=None):
    """``func``'s gradients alone (``grad_and_loss`` without the
    outputs)."""
    with_loss = grad_and_loss(func, argnum)

    @functools.wraps(with_loss)
    def wrapped(*args):
        return with_loss(*args)[0]
    return wrapped
