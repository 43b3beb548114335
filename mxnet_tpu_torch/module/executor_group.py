"""Executor group over ONE device (the port binds a single context).

Allocates the argument and aux cells of a bound symbol, shares parameter
cells with a ``shared_group`` (the bucket ladder's leader), and shares an
aux cell only when its shape and dtype agree: a slot-pooled decode ladder
binds the same aux names at a different slot count per rung, and each
rung must own its own KV-cache pool.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..executor import Executor, aux_dtypes
from ..io import DataDesc
from ..ndarray import NDArray, to_torch_dtype

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, shared_group=None,
                 logger=logging):
        if for_training:
            raise MXNetError("the port binds for inference only "
                             "(training is not ported yet): bind with "
                             "for_training=False")
        if len(contexts) != 1:
            raise MXNetError(f"the port binds one device, got {contexts}")
        self.symbol = symbol
        self.contexts = contexts
        self.context = contexts[0]
        self.logger = logger
        self.param_names = param_names
        self.for_training = False
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                            for x in data_shapes]
        self.label_shapes = None if label_shapes is None else \
            [x if isinstance(x, DataDesc) else DataDesc(*x)
             for x in label_shapes]
        self.data_names = [x.name for x in self.data_shapes]
        self.label_names = [x.name for x in self.label_shapes or []]
        self.batch_size = self.data_shapes[0].shape[0]
        self._bind_exec(shared_group)

    def _bind_exec(self, shared_group):
        shapes = {d.name: d.shape for d in self.data_shapes}
        shapes.update({d.name: d.shape for d in self.label_shapes or []})
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        arg_types = {d.name: d.dtype
                     for d in self.data_shapes + (self.label_shapes or [])}
        for n in self.symbol._arg_nodes():
            if n._extra.get("__dtype__") and n.name not in arg_types:
                arg_types[n.name] = n._extra["__dtype__"]
        dev = self.context.torch_device()

        shared_args = {} if shared_group is None else \
            dict(zip(shared_group.arg_names,
                     shared_group.executor.arg_arrays))
        args = {}
        for name, shape in zip(self.arg_names, arg_shapes):
            is_input = name in self.data_names or name in self.label_names
            if name in shared_args and not is_input:
                args[name] = shared_args[name]     # shared NDArray cell
            else:
                dtype = to_torch_dtype(arg_types.get(name, "float32"))
                if dtype == torch.float64:
                    dtype = torch.float32
                args[name] = NDArray(torch.zeros(shape, dtype=dtype,
                                                 device=dev),
                                     ctx=self.context)
        shared_aux = {} if shared_group is None else \
            dict(zip(shared_group.aux_names,
                     shared_group.executor.aux_arrays))
        want = aux_dtypes(self.symbol)
        aux = {}
        for name, shape in zip(self.aux_names, aux_shapes):
            cell = shared_aux.get(name)
            if cell is not None and tuple(cell.shape) == tuple(shape) \
                    and cell.astorch().dtype == want[name]:
                aux[name] = cell
            else:
                aux[name] = NDArray(torch.zeros(shape, dtype=want[name],
                                                device=dev),
                                    ctx=self.context)
        self.executor = Executor(self.symbol, self.context, args, aux)
        self.execs = [self.executor]
        self.param_arrays = [args[n] for n in self.param_names]
        self.aux_arrays = [aux[n] for n in self.aux_names]

    def set_params(self, arg_params, aux_params):
        """Copy values into the bound cells, in place (each cell keeps its
        dtype and device; aliases of the cell see the new values)."""
        for cells, params in ((self.executor.arg_dict, arg_params),
                              (self.executor.aux_dict, aux_params or {})):
            for name, arr in params.items():
                cell = cells.get(name)
                if cell is None:
                    continue
                src = arr.astorch() if isinstance(arr, NDArray) \
                    else torch.as_tensor(arr)
                if tuple(src.shape) != cell.shape:
                    raise MXNetError(
                        f"parameter {name!r}: shape {tuple(src.shape)} "
                        f"does not match the bound {cell.shape}")
                cell.astorch().copy_(src)

    def forward(self, data_batch, is_train=None):
        if is_train:
            raise MXNetError("the port binds for inference only")
        for names, arrays in ((self.data_names, data_batch.data),
                              (self.label_names, data_batch.label or [])):
            for name, arr in zip(names, arrays):
                dst = self.executor.arg_dict.get(name)
                if dst is None:
                    continue
                src = arr.astorch() if isinstance(arr, NDArray) \
                    else torch.as_tensor(arr)
                dst._set(src.to(device=dst.astorch().device,
                                dtype=dst.astorch().dtype))
        self.executor.forward(is_train=False)

    def get_outputs(self, merge_multi_context=True):
        outs = self.executor.outputs
        if merge_multi_context:
            return outs
        return [[o] for o in outs]
