"""Executor: binds a Symbol to a device and interprets it eagerly.

PyTorch runs eagerly, so an executor is an interpreter over the
topologically sorted nodes: each op dispatches by device (its CUDA kernel
variant for tensors on the card, its plain version on the CPU), there is
no program to trace and so no program cache. This slice binds for
inference only: ``forward(is_train=False)``.

Cells: ``arg_dict`` and ``aux_dict`` map names to NDArray cells that
modules may share (the bucket ladder's parameters). After every forward
the new aux values of ``stateful_infer`` ops (the KV caches and their
cursors) are written back into their cells, so the next forward reads
them. ``outputs`` holds the forward's output NDArrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray, to_torch_dtype
from .ops.registry import dispatch

__all__ = ["Executor"]


class Executor:
    """An inference binding of ``symbol`` on ``ctx``.

    ``args`` / ``aux_states``: dicts name -> NDArray (or lists in
    ``list_arguments`` / ``list_auxiliary_states`` order)."""

    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.arg_dict = _as_dict("args", self.arg_names, args)
        self.aux_dict = _as_dict("aux_states", self.aux_names,
                                 aux_states or {})
        self._nodes = symbol._topo_nodes()
        self.outputs = []

    @staticmethod
    def simple_bind(symbol, ctx, type_dict, shapes):
        """Bind with zero-filled cells: shapes from ``shapes`` plus
        inference, dtypes from ``type_dict`` (default float32) and the
        aux dtypes the ops declare."""
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        type_dict = type_dict or {}
        dev = ctx.torch_device()
        args = {nm: NDArray(torch.zeros(
            s, dtype=to_torch_dtype(type_dict.get(nm, "float32")),
            device=dev), ctx=ctx)
            for nm, s in zip(symbol.list_arguments(), arg_shapes)}
        aux_types = aux_dtypes(symbol)
        aux = {nm: NDArray(torch.zeros(s, dtype=aux_types[nm], device=dev),
                           ctx=ctx)
               for nm, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
        return Executor(symbol, ctx, args, aux)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def forward(self, is_train=False, **kwargs):
        """Run the graph once. Keyword NDArrays/arrays overwrite the named
        argument cells first. Returns ``outputs``."""
        if is_train:
            raise MXNetError("this executor binds for inference only "
                             "(training is not ported yet)")
        for name, val in kwargs.items():
            cell = self.arg_dict.get(name)
            if cell is None:
                raise MXNetError(f"forward(): no argument named {name!r}")
            src = val.astorch() if isinstance(val, NDArray) \
                else torch.as_tensor(np.asarray(val))
            cell._set(src.to(device=cell.astorch().device,
                             dtype=cell.astorch().dtype))
        values = {}
        for node in self._nodes:
            if node.is_variable:
                cells = self.aux_dict if node._extra.get("__is_aux__") \
                    else self.arg_dict
                values[id(node)] = [cells[node.name].astorch()]
                continue
            opdef = node.opdef()
            ins = [values[id(inp)][idx] for inp, idx in node.inputs]
            n_aux = len(opdef.aux_names(node.attrs))
            regular = ins[:len(ins) - n_aux] if n_aux else ins
            aux = ins[len(ins) - n_aux:] if n_aux else []
            outs, new_aux = dispatch(opdef, node.attrs, regular, aux,
                                     False, None)
            if n_aux and opdef.stateful_infer:
                for (inp, _), new in zip(node.inputs[len(ins) - n_aux:],
                                         new_aux):
                    self.aux_dict[inp.name]._set(new)
            values[id(node)] = outs
        self.outputs = [NDArray(values[id(n)][i], ctx=self._ctx)
                        for n, i in self._symbol._outputs]
        return self.outputs


def aux_dtypes(symbol):
    """{aux name: torch dtype}: the dtype an op declared on the aux
    variable (``__dtype__``, e.g. the int32 cache cursor), else float32."""
    return {n.name: to_torch_dtype(n._extra.get("__dtype__", "float32"))
            for n in symbol._aux_nodes()}


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
