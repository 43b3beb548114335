"""Executor: binds a Symbol to a device and interprets it eagerly.

PyTorch runs eagerly, so an executor is an interpreter over the
topologically sorted nodes: each op dispatches by device (its CUDA kernel
variant for tensors on the card, its plain version on the CPU), there is
no program to trace and so no program cache.

Cells: ``arg_dict``, ``aux_dict`` and ``grad_dict`` map names to NDArray
cells that modules may share (the bucket ladder's parameters). After a
forward the new aux values are written back into their cells: after every
training forward (BatchNorm's moving statistics), and after every forward
of a ``stateful_infer`` op (the KV caches and their cursors). ``outputs``
holds the forward's output NDArrays.

Training: ``forward(is_train=True)`` records autograd. Every argument
whose ``grad_req`` is not ``"null"`` enters the graph as a leaf that
shares its cell's storage; ``backward(out_grads)`` seeds ones for loss
heads (whose backward ignores them) and zeros for the other outputs, and
writes each leaf's gradient into its ``grad_dict`` cell — replacing it
under ``"write"``, adding to it under ``"add"``; an argument the outputs
do not depend on gets a zero gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray, to_torch_dtype
from .ops.registry import dispatch

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")


class Executor:
    """A binding of ``symbol`` on ``ctx``.

    ``args`` / ``args_grad`` / ``aux_states``: dicts name -> NDArray (or
    lists in ``list_arguments`` / ``list_auxiliary_states`` order).
    ``grad_req``: ``"write"``, ``"add"`` or ``"null"``, one for all or a
    dict / list per argument; an argument without an ``args_grad`` cell
    is not differentiated."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = _as_dict("args", self.arg_names, args)
        self.aux_dict = _as_dict("aux_states", self.aux_names,
                                 aux_states or {})
        grads = args_grad if args_grad is not None else {}
        if not isinstance(grads, dict):
            grads = dict(zip(self.arg_names, grads))
        # an argument without a gradient cell is not differentiated,
        # whatever its request
        self.grad_req = {n: r if grads.get(n) is not None else "null"
                         for n, r in _normalize_req(grad_req,
                                                    self.arg_names).items()}
        self.grad_dict = {n: grads[n] for n, r in self.grad_req.items()
                          if r != "null"}
        self._nodes = symbol._topo_nodes()
        self._loss_mask = [not n.is_variable and n.opdef().is_loss
                           for n, _ in symbol._outputs]
        self.outputs = []
        self._recorded = None     # (graph outputs, {name: leaf}) to train

    @staticmethod
    def simple_bind(symbol, ctx, type_dict, shapes, grad_req):
        """Bind with zero-filled cells: shapes from ``shapes`` plus
        inference, dtypes from ``type_dict`` (default float32) and the
        aux dtypes the ops declare; a zero gradient cell for each argument
        whose ``grad_req`` is not ``"null"``."""
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        type_dict = type_dict or {}
        dev = ctx.torch_device()
        names = symbol.list_arguments()
        args = {nm: NDArray(torch.zeros(
            s, dtype=to_torch_dtype(type_dict.get(nm, "float32")),
            device=dev), ctx=ctx) for nm, s in zip(names, arg_shapes)}
        req = _normalize_req(grad_req, names)
        grads = {nm: NDArray(torch.zeros(s, device=dev), ctx=ctx)
                 for nm, s in zip(names, arg_shapes) if req[nm] != "null"}
        aux_types = aux_dtypes(symbol)
        aux = {nm: NDArray(torch.zeros(s, dtype=aux_types[nm], device=dev),
                           ctx=ctx)
               for nm, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
        return Executor(symbol, ctx, args, grads, req, aux)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    def forward(self, is_train=False, **kwargs):
        """Run the graph once. Keyword NDArrays/arrays overwrite the named
        argument cells first. ``is_train=True`` records autograd for a
        following ``backward()`` and writes the new aux values back.
        Returns ``outputs``."""
        for name, val in kwargs.items():
            cell = self.arg_dict.get(name)
            if cell is None:
                raise MXNetError(f"forward(): no argument named {name!r}")
            src = val.astorch() if isinstance(val, NDArray) \
                else torch.as_tensor(np.asarray(val))
            cell._set(src.to(device=cell.astorch().device,
                             dtype=cell.astorch().dtype))
        self._recorded = None
        leaves = {}
        if is_train:
            for name, req in self.grad_req.items():
                if req != "null":
                    leaves[name] = self.arg_dict[name].astorch().detach() \
                        .requires_grad_(True)
        with torch.set_grad_enabled(bool(leaves)):
            outs = self._run(bool(is_train), leaves)
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        if leaves:
            self._recorded = (outs, leaves)
        return self.outputs

    def _run(self, is_train, leaves):
        values = {}
        for node in self._nodes:
            if node.is_variable:
                if node._extra.get("__is_aux__"):
                    values[id(node)] = [self.aux_dict[node.name].astorch()]
                else:
                    values[id(node)] = [leaves[node.name]
                                        if node.name in leaves else
                                        self.arg_dict[node.name].astorch()]
                continue
            opdef = node.opdef()
            ins = [values[id(inp)][idx] for inp, idx in node.inputs]
            n_aux = len(opdef.aux_names(node.attrs))
            regular = ins[:len(ins) - n_aux] if n_aux else ins
            aux = ins[len(ins) - n_aux:] if n_aux else []
            outs, new_aux = dispatch(opdef, node.attrs, regular, aux,
                                     is_train, None)
            if not ins:
                # a source op (``_arange``: the learned positions' ids)
                # makes its tensor on the host; it belongs on the bound
                # device with everything that reads it
                outs = [o.to(self._ctx.torch_device()) for o in outs]
            if n_aux and (is_train or opdef.stateful_infer):
                for (inp, _), new in zip(node.inputs[len(ins) - n_aux:],
                                         new_aux):
                    self.aux_dict[inp.name]._set(
                        new.detach() if new.requires_grad else new)
            values[id(node)] = outs
        return [values[id(n)][i] for n, i in self._symbol._outputs]

    def backward(self, out_grads=None):
        """Gradients of the last training forward with respect to every
        argument whose ``grad_req`` is not ``"null"``. ``out_grads``: one
        head gradient per output (NDArray or array); by default ones for
        loss heads and zeros for the rest."""
        if self._recorded is None:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "with at least one argument to differentiate")
        outs, leaves = self._recorded
        if out_grads is None:
            heads = [torch.ones_like(o) if is_loss else None
                     for o, is_loss in zip(outs, self._loss_mask)]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [(g.astorch() if isinstance(g, NDArray)
                      else torch.as_tensor(np.asarray(g))).to(o.device,
                                                              o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads)
                 if h is not None and o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[n] for n in names],
            [h for _, h in pairs], allow_unused=True) if pairs \
            else [None] * len(names)
        self._recorded = None
        for name, g in zip(names, grads):
            cell = self.grad_dict[name]
            if g is None:
                g = torch.zeros_like(leaves[name])
            g = g.detach().to(cell.astorch().dtype).contiguous()
            if self.grad_req[name] == "add":
                g = cell.astorch() + g
            cell._set(g)


def aux_dtypes(symbol):
    """{aux name: torch dtype}: the dtype an op declared on the aux
    variable (``__dtype__``, e.g. the int32 cache cursor), else float32."""
    return {n.name: to_torch_dtype(n._extra.get("__dtype__", "float32"))
            for n in symbol._aux_nodes()}


def _normalize_req(grad_req, names):
    if isinstance(grad_req, str):
        req = {n: grad_req for n in names}
    elif isinstance(grad_req, dict):
        req = {n: grad_req.get(n, "null") for n in names}
    else:
        req = dict(zip(names, grad_req))
    bad = {n: r for n, r in req.items() if r not in _GRAD_REQS}
    if bad:
        raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got {bad}")
    return req


def _as_dict(what, names, cells):
    if isinstance(cells, dict):
        missing = [n for n in names if n not in cells]
        if missing:
            raise MXNetError(f"bind: {what} missing {missing}")
        return {n: cells[n] for n in names}
    cells = list(cells)
    if len(cells) != len(names):
        raise MXNetError(f"bind: {what} has {len(cells)} entries, the "
                         f"graph wants {len(names)}")
    return dict(zip(names, cells))
