"""Executor group over ONE device.

Without ``spmd`` the group binds a single context, as the reference's
group binds one executor per device and the port has one device. With
``spmd`` (the JAX package's ``executor_group.py:152-163``) it takes the
whole context list, builds the binding's ``parallel.SpmdPlan`` over it
(mesh from ``mesh_config``, else ``MXNET_MESH_*``, else a data axis over
every context) and binds one executor on the first context with the
plan; the contexts must name one device (``[mx.gpu(0)] * 4``), since
every op but attention runs there unpartitioned. Sharding over distinct
devices is the multi-GPU slice (``ROADMAP.md`` A8).

Allocates the argument, gradient and aux cells of a bound symbol, shares
parameter cells with a ``shared_group`` (the bucket ladder's leader), and
shares an aux cell only when its shape and dtype agree: a slot-pooled
decode ladder binds the same aux names at a different slot count per
rung, and each rung must own its own KV-cache pool.

Training (``for_training=True``): every parameter gets a gradient cell
(``grad_req`` "write" or "add", one for all or a dict per name), and
the data inputs get one under ``inputs_need_grad``. ``forward`` / ``backward`` / ``get_outputs`` /
``get_input_grads`` / ``update_metric`` are the reference's group
surface over the one executor; ``param_arrays`` and ``grad_arrays`` are
flat, one cell per parameter. ``compute_dtype`` (``"bfloat16"``, ``"float16"``) goes to
the executor, which casts where the graph reads; the cells stay float32.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..executor import Executor, aux_dtypes
from ..io import DataDesc
from ..ndarray import NDArray, to_torch_dtype
from ..parallel.spmd import SpmdPlan

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, shared_group=None,
                 logger=logging, inputs_need_grad=False, grad_req="write",
                 compute_dtype=None, spmd=False, mesh_config=None):
        self._spmd_plan = None
        if spmd:
            self._spmd_plan = SpmdPlan(
                SpmdPlan.build_mesh_for(contexts, mesh_config))
        elif len(contexts) != 1:
            raise MXNetError(
                f"the port binds one device without spmd, got {contexts}: "
                "bind a context list with spmd=True (one device named "
                "several times), or see ROADMAP.md A8 for distinct devices")
        self.symbol = symbol
        self.compute_dtype = compute_dtype
        self.contexts = contexts
        self.context = contexts[0]
        self.logger = logger
        self.param_names = param_names
        self.for_training = bool(for_training)
        self.inputs_need_grad = bool(inputs_need_grad)
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
        self.grad_req = {}
        for name in self.arg_names:
            if name in param_names:
                req = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "null")
                if not self.for_training:
                    req = "null"
            elif name in self.data_names and self.inputs_need_grad and \
                    self.for_training:
                req = grad_req if isinstance(grad_req, str) else "write"
            else:
                req = "null"
            self.grad_req[name] = req
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
        args, grads = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            is_input = name in self.data_names or name in self.label_names
            dtype = to_torch_dtype(arg_types.get(name, "float32"))
            if dtype == torch.float64:
                dtype = torch.float32
            if name in shared_args and not is_input:
                args[name] = shared_args[name]     # shared NDArray cell
            else:
                args[name] = NDArray(torch.zeros(shape, dtype=dtype,
                                                 device=dev),
                                     ctx=self.context)
            if self.grad_req[name] != "null":
                grads[name] = NDArray(torch.zeros(shape, device=dev),
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
        self.executor = Executor(self.symbol, self.context, args, grads,
                                 self.grad_req, aux,
                                 compute_dtype=self.compute_dtype,
                                 spmd_plan=self._spmd_plan)
        self.execs = [self.executor]
        self.param_arrays = [args[n] for n in self.param_names]
        self.grad_arrays = [grads.get(n) for n in self.param_names]
        self.aux_arrays = [aux[n] for n in self.aux_names]

    def set_params(self, arg_params, aux_params):
        """Copy values into the bound cells, in place (each cell keeps its
        dtype and device; aliases of the cell see the new values)."""
        for cells, params in ((self.executor.arg_dict, arg_params),
                              (self.executor.aux_dict, aux_params or {})):
            for name, arr in params.items():
                cell = cells.get(name)
                if cell is None or arr is cell:
                    continue
                src = arr.astorch() if isinstance(arr, NDArray) \
                    else torch.as_tensor(arr)
                if tuple(src.shape) != cell.shape:
                    raise MXNetError(
                        f"parameter {name!r}: shape {tuple(src.shape)} "
                        f"does not match the bound {cell.shape}")
                cell.astorch().copy_(src)

    def forward(self, data_batch, is_train=None, key=None):
        """Load the batch's data (and labels, which loss heads read) into
        the bound input cells, on the bound device, and run: under
        ``key`` (the module's training chain) when given, else under a
        key the executor draws from ``mx.random``."""
        if is_train is None:
            is_train = self.for_training
        if is_train and not self.for_training:
            raise MXNetError("forward(is_train=True) on a module bound "
                             "with for_training=False")
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
        if key is None:
            self.executor.forward(is_train=bool(is_train))
        else:
            self.executor.forward_with_key(key, is_train=bool(is_train))

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("backward() needs a module bound with "
                             "for_training=True")
        self.executor.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.executor.outputs
        if merge_multi_context:
            return outs
        return [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True to get input "
                             "gradients")
        grads = [self.executor.grad_dict[n] for n in self.data_names]
        if merge_multi_context:
            return grads
        return [[g] for g in grads]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.executor.outputs)
