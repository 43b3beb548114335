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

Prologues: an op that declares a per-forward prologue
(``ops.registry.OpDef.set_prologue``) has it run once a forward, before
the nodes, over all of its nodes whose declared inputs come straight from
variables (their values as the graph reads them, cast included); each of
those nodes then runs on its prepared tensor. ``QuantizedConvolution``'s
prologue dequantizes every such conv weight in one call: one launch on the
card a forward (a conv whose weight the graph computes dequantizes its own,
one launch), and all of the forward's float32 conv weights exist together
until the forward ends.

Randomness (the JAX package's runner): a forward draws one key from
``mx.random`` (``next_key()``; a module's training step hands its own
chain's key to ``forward_with_key``), and node i of the node list,
variables counted, whose op needs randomness (``OpDef.need_rng``:
Dropout, the samplers) runs under ``mx.random.fold_in(key, i)``; every
other op gets None. A backward reuses what the forward drew: Dropout's
mask is its hidden output, and its gradient multiplies by it.

Training: ``forward(is_train=True)`` records autograd. Every argument
whose ``grad_req`` is not ``"null"`` enters the graph as a leaf that
shares its cell's storage; ``backward(out_grads)`` seeds ones for loss
heads (whose backward ignores them) and zeros for the other outputs, and
writes each leaf's gradient into its ``grad_dict`` cell — replacing it
under ``"write"``, adding to it under ``"add"``; an argument the outputs
do not depend on gets a zero gradient.

Mixed precision (``compute_dtype="bfloat16"`` or ``"float16"``, the JAX
package's ``_load_var``): every floating argument and aux state is cast
to the compute dtype where the graph reads it, while the cells keep their float32 storage —
master weights, gradients and moving statistics. The cast is
differentiable, so gradients come back float32. A new aux value is
written back in its cell's dtype where that dtype holds it exactly (a
float32 cell: BatchNorm's moving statistics, a decode step's KV caches,
which the op wrote in their compute-dtype cast); a cell too narrow for
it (an fp8 KV cache) takes the compute-dtype value itself, as the JAX
package's cell takes its compute-width value, so no write-back rounds. A
variable that feeds a loss head's label slot keeps its dtype (class ids
above 256 do not survive bfloat16, nor ids above 2048 float16). A cast
that autograd does not record (every read of an inference forward, the
aux states and inputs of a training one) is kept per source tensor and
reused while that tensor's version counter stands still, so a served
rung does not cast every parameter again on every forward; anything
that writes a cell in place bumps its counter (PyTorch's in-place ops
do, and so do the in-place update kernels' wrappers). A write-back drops
the kept cast of the tensor it replaces, which an op may have written in
place. ``cast_counts()`` counts the casts made and the write-backs that
changed a dtype.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import NDArray, to_torch_dtype
from .ops.registry import dispatch, dispatch_prepared, run_prologue
from .parallel.spmd import plan_scope

__all__ = ["Executor", "parse_compute_dtype", "cast_counts",
           "reset_cast_counts"]

_GRAD_REQS = ("write", "add", "null")
#: fp8 storage dtypes, which ``compute_dtype`` does not widen
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)

#: id(source tensor) -> (weak reference to it, its version when cast, the
#: cast): the casts of ``compute_dtype`` reads that autograd does not
#: record, shared by every executor that reads the same cell; an entry
#: leaves with its source tensor
_CASTS = {}


#: "casts": casts ``_load`` made (kept casts reused are not counted);
#: "write_backs": new aux values cast back to their cell's dtype
_COUNTS = {"casts": 0, "write_backs": 0}


def _forget(ref, key):
    if _CASTS.get(key, (None,))[0] is ref:
        del _CASTS[key]


def cast_counts():
    """{"casts": n, "write_backs": n} of the mixed-precision cast layer
    since the last ``reset_cast_counts()``: each is one elementwise
    launch on the card."""
    return dict(_COUNTS)


def reset_cast_counts():
    for key in _COUNTS:
        _COUNTS[key] = 0


def parse_compute_dtype(compute_dtype):
    """``compute_dtype`` as the executor takes it: None (or float32) for
    none, ``torch.bfloat16`` for ``"bfloat16"`` / ``torch.bfloat16`` (or
    a numpy dtype or scalar type named ``bfloat16``), ``torch.float16``
    for ``"float16"`` / ``torch.float16`` / ``np.float16``. Every other
    type raises."""
    if compute_dtype is None:
        return None
    if isinstance(compute_dtype, (str, torch.dtype)):
        name = str(compute_dtype).replace("torch.", "")
    else:       # a numpy dtype, or a scalar type such as np.float16
        name = getattr(compute_dtype, "__name__", None) or str(compute_dtype)
    if name in ("float32", "float"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float16", "half", "fp16"):
        return torch.float16
    raise MXNetError(f"compute_dtype={compute_dtype!r}: the port's mixed "
                     "precision takes bfloat16 or float16")


def _loss_label_names(symbol):
    """Variables that feed a loss head's label slot (every input of a
    loss op but its first)."""
    names = set()
    for node in symbol._topo_nodes():
        if not node.is_variable and node.opdef().is_loss:
            names.update(inp.name for inp, _ in node.inputs[1:]
                         if inp.is_variable)
    return names


class Executor:
    """A binding of ``symbol`` on ``ctx``.

    ``args`` / ``args_grad`` / ``aux_states``: dicts name -> NDArray (or
    lists in ``list_arguments`` / ``list_auxiliary_states`` order).
    ``grad_req``: ``"write"``, ``"add"`` or ``"null"``, one for all or a
    dict / list per argument; an argument without an ``args_grad`` cell
    is not differentiated. ``compute_dtype``: None, or ``"bfloat16"`` or
    ``"float16"`` for mixed precision (see the module docstring).
    ``spmd_plan``: the binding's ``parallel.SpmdPlan``, armed as the active
    plan around every forward and backward (the ``attention`` ops read it
    and lower to ring attention over its ``seq`` axis)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, compute_dtype=None, spmd_plan=None):
        self._symbol = symbol
        self._ctx = ctx
        self._spmd_plan = spmd_plan
        self.compute_dtype = parse_compute_dtype(compute_dtype)
        self._label_names = _loss_label_names(symbol) \
            if self.compute_dtype is not None else set()
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
        self._prologues = _prologue_plan(self._nodes)
        self._loss_mask = [not n.is_variable and n.opdef().is_loss
                           for n, _ in symbol._outputs]
        self.outputs = []
        self._recorded = None     # (graph outputs, {name: leaf}) to train

    @staticmethod
    def simple_bind(symbol, ctx, type_dict, shapes, grad_req,
                    compute_dtype=None):
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
        return Executor(symbol, ctx, args, grads, req, aux,
                        compute_dtype=compute_dtype)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy named parameters (NDArrays or arrays) into the bound cells,
        each cast to its cell's dtype and moved to its device; a name the
        graph does not have raises unless ``allow_extra_params``."""
        for params, cells, what in ((arg_params, self.arg_dict, "param"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux param")):
            for nm, arr in params.items():
                if nm not in cells:
                    if not allow_extra_params:
                        raise MXNetError(f"unknown {what} {nm!r}")
                    continue
                cell = cells[nm].astorch()
                src = arr.astorch() if isinstance(arr, NDArray) else \
                    torch.as_tensor(np.asarray(arr))
                cells[nm]._set(src.detach().to(cell.device, cell.dtype)
                               .clone())

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
        following ``backward()`` and writes the new aux values back. The
        forward draws one key from ``mx.random`` (``forward_with_key``).
        Returns ``outputs``."""
        return self.forward_with_key(_random.next_key(), is_train, **kwargs)

    def forward_with_key(self, key, is_train=False, **kwargs):
        """``forward`` with ``key`` as the forward's random key: node i of
        the node list, variables counted, whose op needs randomness runs
        under ``mx.random.fold_in(key, i)``, as the JAX package's runner
        folds it. A module's training step passes its own chain's key;
        ``backward()`` reuses what the forward drew (Dropout's mask)."""
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
        with torch.set_grad_enabled(bool(leaves)), \
                plan_scope(self._spmd_plan):
            outs = self._run(bool(is_train), leaves, key)
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        if leaves:
            self._recorded = (outs, leaves)
        return self.outputs

    def _load(self, name, t, aux=False):
        """A variable's tensor as the graph reads it: cast to
        ``compute_dtype`` when floating and not a loss label. An fp8
        argument (a quantized weight) reaches its op as stored: the
        quantized kernels read float8_e4m3fn, and every e4m3 value is
        exact in bfloat16 and float16, so the widening the JAX executor
        makes changes no value. An fp8 aux state (a decode cache cell) is
        widened, as the JAX executor widens it."""
        if self.compute_dtype is None or not t.is_floating_point() or \
                (t.dtype in _FP8 and not aux) or \
                name in self._label_names or t.dtype == self.compute_dtype:
            return t
        if t.requires_grad:
            _COUNTS["casts"] += 1
            return t.to(self.compute_dtype)
        key = id(t)
        hit = _CASTS.get(key)
        if hit is not None and hit[0]() is t and hit[1] == t._version and \
                hit[2].dtype == self.compute_dtype:
            return hit[2]
        _COUNTS["casts"] += 1
        cast = t.to(self.compute_dtype)
        _CASTS[key] = (weakref.ref(t, lambda r, k=key: _forget(r, k)),
                       t._version, cast)
        return cast

    def _run(self, is_train, leaves, key):
        values = {}
        for node in self._nodes:
            if node.is_variable:
                aux = bool(node._extra.get("__is_aux__"))
                if aux:
                    t = self.aux_dict[node.name].astorch()
                else:
                    t = leaves[node.name] if node.name in leaves else \
                        self.arg_dict[node.name].astorch()
                values[id(node)] = [self._load(node.name, t, aux)]
        # each declared prologue once, over all of its nodes, before them
        prepared = {}
        for opdef, nodes in self._prologues:
            pos = opdef.prologue["inputs"]
            groups = [tuple(values[id(node.inputs[i][0])][0] for i in pos)
                      for node in nodes]
            prepared.update(zip(map(id, nodes), run_prologue(opdef, groups)))
        device = self._ctx.torch_device()
        for i, node in enumerate(self._nodes):
            if node.is_variable:
                continue
            opdef = node.opdef()
            rng = _random.fold_in(key, i) if opdef.need_rng else None
            ins = [values[id(inp)][idx] for inp, idx in node.inputs]
            n_aux = len(opdef.aux_names(node.attrs))
            regular = ins[:len(ins) - n_aux] if n_aux else ins
            aux = ins[len(ins) - n_aux:] if n_aux else []
            if id(node) in prepared:
                outs, new_aux = dispatch_prepared(
                    opdef, node.attrs, regular, prepared.pop(id(node)), aux,
                    is_train, None)
            else:
                outs, new_aux = dispatch(opdef, node.attrs, regular, aux,
                                         is_train, rng, device)
            if not ins:
                # a source op (``_arange``, a sampler) makes its tensor on
                # the bound device (``dispatch``); a Python op with no
                # input (``Custom``) may make it on the host, and it
                # belongs with everything that reads it
                outs = [o.to(device) for o in outs]
            if n_aux and (is_train or opdef.stateful_infer):
                for (inp, _), new in zip(node.inputs[len(ins) - n_aux:],
                                         new_aux):
                    cell = self.aux_dict[inp.name]
                    new = new.detach() if new.requires_grad else new
                    if self.compute_dtype is not None:
                        new = _write_back(cell.astorch(), new)
                    cell._set(new)
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
            # zeros reach an op that ignores its head gradient (a Custom
            # op with need_top_grad=False), as the JAX executor's do
            heads = [torch.ones_like(o) if is_loss else torch.zeros_like(o)
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
        with plan_scope(self._spmd_plan):
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


def _prologue_plan(nodes):
    """[(opdef, [node, ...])]: for each op that declares a prologue, its
    nodes whose inputs at the declared positions all come straight from
    variables, in topological order."""
    plan = {}
    for node in nodes:
        if node.is_variable:
            continue
        opdef = node.opdef()
        if opdef.prologue is not None and all(
                i < len(node.inputs) and node.inputs[i][0].is_variable
                for i in opdef.prologue["inputs"]):
            plan.setdefault(opdef.name, (opdef, []))[1].append(node)
    return list(plan.values())


def _write_back(old, new):
    """The tensor a cell holding ``old`` takes for the new aux value
    ``new`` under ``compute_dtype``: ``new`` in ``old``'s dtype when that
    holds it exactly, else ``new`` itself (a float cell narrower than the
    compute dtype: an fp8 cache). Drops the kept cast of ``old``."""
    hit = _CASTS.get(id(old))
    if hit is not None and hit[0]() is old:
        del _CASTS[id(old)]
    if new.dtype == old.dtype or (
            old.is_floating_point() and new.is_floating_point() and
            torch.finfo(old.dtype).bits < torch.finfo(new.dtype).bits):
        return new
    _COUNTS["write_backs"] += 1
    return new.to(old.dtype)


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
