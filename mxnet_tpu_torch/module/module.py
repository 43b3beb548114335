"""Module: trains and predicts over one Symbol bound to one context.

The reference's arrangement for one device: ``bind`` allocates the cells
(with gradient cells when ``for_training``), ``init_params`` fills them,
``init_optimizer`` builds the optimizer (``rescale_grad`` = 1 / batch
unless given) and its updater, and ``update`` hands the updater every
parameter that has a gradient at once (``Updater.update_multi``): SGD
with momentum and Adam update the whole step in one multi-tensor kernel
launch on the card, with the per-index lr and wd of the per-index path.
The JAX package fuses forward, backward and update into one jitted step
on a single device; PyTorch runs eagerly and there is no program to
fuse, so the port keeps the updater's states and counts, which compute
the same numbers. It keeps the fused step's random chain: where the JAX
package arms that step (SGD or Adam, a training binding whose gradient
requests are ``"write"`` or ``"null"`` and that wants no input
gradients), ``init_optimizer`` draws one ``mx.random.next_key()``, and
each ``forward_backward`` splits it and runs the forward under the second
half; a ``mx.random.seed()`` since the last step draws the chain again.
So after the same seed a fit draws the JAX package's Dropout masks step by
step. Elsewhere every forward draws ``next_key()``, as the JAX package's
unfused path does.

``spmd=True`` (``bind``, ``fit`` or ``MXNET_SPMD=1``) binds a context
list as one ``parallel.SpmdPlan`` over the mesh ``mesh`` (a
``parallel.MeshConfig``): with a ``seq`` axis the ``attention`` ops lower
to ring attention, the rest of the graph runs on the first context, and
the kvstore is dropped as in the JAX package.

``compute_dtype="bfloat16"`` or ``"float16"`` is the JAX package's mixed
precision: the graph reads every floating parameter, input and aux state
cast to the compute dtype (labels of loss heads excepted), while the bound cells — master
weights, gradients, optimizer states, moving statistics — stay float32.
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from .. import optimizer as opt
from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from ..executor import parse_compute_dtype
from ..initializer import Uniform
from ..model import _create_kvstore, load_checkpoint
from ..ndarray import NDArray
from ..parallel.spmd import SpmdPlan
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]

_REBIND_SPMD = ("Module is already bound with another spmd plan than the one "
                "asked for; pass force_rebind=True to re-bind")


class Module(BaseModule):
    """Train or predict over a single Symbol bound to one context
    (default: the current context, ``gpu(0)`` unless a ``with mx.cpu():``
    scope says otherwise). ``compute_dtype``: None, or ``"bfloat16"`` /
    ``torch.bfloat16`` or ``"float16"`` / ``torch.float16`` for mixed
    precision. Like the JAX package, the port has no loss scaling: a
    float16 fit keeps the gradients float16 rounds to (subnormals
    included) and loses the ones below its range."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, compute_dtype=None):
        super().__init__(logger=logger)
        parse_compute_dtype(compute_dtype)      # other types raise here
        self._compute_dtype = compute_dtype
        context = context if context is not None else current_context()
        self._context = list(context) if isinstance(context, (list, tuple)) \
            else [context]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._output_names = symbol.list_outputs()
        inputs = set(self._data_names) | set(self._label_names)
        args = symbol.list_arguments()
        for nm in self._data_names:
            if nm not in args:
                raise MXNetError(f"data name {nm!r} is not an argument of "
                                 f"the symbol ({args})")
        self._param_names = [a for a in args if a not in inputs]
        self._exec_group = None
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._step_key = None           # the training step's key chain
        self._step_gen = None
        self._preload_opt_states = None
        self._spmd = None               # None -> MXNET_SPMD at bind time
        self._mesh_config = None        # parallel.MeshConfig (spmd mode)

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a saved checkpoint (symbol JSON + params); the
        params are copied into the cells at ``bind``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write prefix-symbol.json + prefix-NNNN.params (+ .states)."""
        self._symbol.save(f"{prefix}-symbol.json")
        self.save_params(f"{prefix}-{epoch:04d}.params")
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._exec_group.label_shapes

    # ---------------------------------------------------------------- params
    def get_params(self):
        """(arg_params, aux_params): name -> the bound cells."""
        assert self.binded and self.params_initialized
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the bound cells, in place: from ``arg_params`` /
        ``aux_params`` (name -> NDArray or array) where present, else by
        ``initializer(name, cell)`` — ``Uniform(0.01)`` by default, as in
        the JAX package; it raises ``ValueError`` on a name it has no rule
        for. A parameter missing from given params raises unless
        ``allow_missing``; with ``initializer=None`` it then keeps its
        bound zeros (the decode caches and cursors do exactly that)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "bind() must run before init_params()"
        exe = self._exec_group.executor
        self._arg_params = {n: exe.arg_dict[n] for n in self._param_names}
        self._aux_params = dict(exe.aux_dict)
        for cells, cache in ((self._arg_params, arg_params),
                             (self._aux_params, aux_params)):
            given = {}
            for name in sorted(cells):
                if cache is not None and name in cache:
                    given[name] = cache[name]
                elif cache is not None and not allow_missing:
                    raise MXNetError(
                        f"parameter {name!r} missing from the provided "
                        "params (pass allow_missing=True to keep it zero)")
                elif initializer is not None:
                    initializer(name, cells[name])
            self._exec_group.set_params(
                {k: v for k, v in given.items() if k in exe.arg_dict}, {
                    k: v for k, v in given.items() if k in exe.aux_dict})
        self.params_initialized = True

    # ------------------------------------------------------------------ bind
    def _resolve_spmd(self):
        """SPMD mode: the last bind or fit argument (self._spmd) >
        MXNET_SPMD env; default off."""
        if self._spmd is not None:
            return bool(self._spmd)
        return os.environ.get("MXNET_SPMD", "").lower() in \
            ("1", "true", "yes", "on")

    def _keep_spmd(self, spmd, mesh, force_rebind):
        if self.binded and not force_rebind and \
                not self._bound_as_asked(spmd, mesh):
            raise MXNetError(_REBIND_SPMD)
        if spmd is not None:
            self._spmd = bool(spmd)
        if mesh is not None:
            self._mesh_config = mesh

    def _bound_as_asked(self, spmd, mesh):
        """Whether the bound group has the plan that ``spmd`` / ``mesh``
        ask for; what is not asked (None) is what is bound. A ``mesh``
        without an spmd plan is not read, bound or not."""
        plan = self._exec_group._spmd_plan
        if not (bool(spmd) if spmd is not None else plan is not None):
            return plan is None
        return plan is not None and (
            mesh is None or plan.mesh.shape ==
            SpmdPlan.build_mesh_for(self._context, mesh).shape)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", spmd=None, mesh=None):
        """Allocate the cells of the bound graph (gradient cells too when
        ``for_training``). With ``shared_module`` (bound and initialized)
        the parameter cells are that module's own objects, and so are aux
        cells of equal shape and dtype. Params loaded before binding
        (``Module.load``) are copied in. ``spmd`` / ``mesh``: see the
        module docstring."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            if not self._bound_as_asked(spmd, mesh):
                raise MXNetError(_REBIND_SPMD)
            self.logger.warning("Module is already bound; ignoring bind() "
                                "(use force_rebind=True to re-bind)")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training=True")
        self._keep_spmd(spmd, mesh, True)     # kept for a later re-bind
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, for_training, shared_group,
            logger=self.logger, inputs_need_grad=inputs_need_grad,
            grad_req=grad_req, compute_dtype=self._compute_dtype,
            spmd=self._resolve_spmd(), mesh_config=self._mesh_config)
        self.for_training = bool(for_training)
        self.inputs_need_grad = bool(inputs_need_grad)
        self.binded = True
        exe = self._exec_group.executor
        if shared_module is not None:
            self._arg_params = {n: exe.arg_dict[n]
                                for n in self._param_names}
            self._aux_params = dict(exe.aux_dict)
            self.params_initialized = True
        elif self.params_initialized:
            loaded = (self._arg_params, self._aux_params)
            self.params_initialized = False
            self.init_params(arg_params=loaded[0], aux_params=loaded[1])

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Build the optimizer (by name, with ``rescale_grad`` defaulting
        to 1 / batch size, or an ``Optimizer`` instance) and its
        updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer is already initialized; "
                                "ignoring init_optimizer()")
            return
        n_device = len(self._context)
        if self._exec_group._spmd_plan is not None:
            # one device runs the plan, so no store reduces anything: a
            # local/device store is dropped (the JAX package drops it for
            # its in-program collectives); a dist store still raises below
            n_device = 1
            if kvstore is not None and "dist" not in str(kvstore):
                self.logger.info("spmd mode: %r kvstore dropped — one "
                                 "device runs the plan", kvstore)
                kvstore = None
        _create_kvstore(kvstore, n_device)
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)), **params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        group = self._exec_group
        self._step_key = None
        if isinstance(optimizer, (opt.SGD, opt.Adam)) and \
                group.for_training and not group.inputs_need_grad and \
                all(r in ("write", "null") for r in group.grad_req.values()):
            # the JAX package's fused step: its key chain, drawn once here
            self._step_key = _random.next_key()
            self._step_gen = _random.generation()
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ------------------------------------------------------------ train step
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def forward_backward(self, data_batch):
        """A training forward and its backward. Where the JAX package
        would run its fused step, the forward's key is the next of the
        step's own chain (see the module docstring)."""
        assert self.binded and self.params_initialized
        key = None
        if self.optimizer_initialized and self._step_key is not None:
            if self._step_gen != _random.generation():
                self._step_key = _random.next_key()
                self._step_gen = _random.generation()
            self._step_key, key = _random.split(self._step_key)
        self._exec_group.forward(data_batch, True, key=key)
        self.backward()

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on every parameter that has a gradient, in
        one updater call."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        live = [(i, w, g) for i, (w, g) in enumerate(zip(
            self._exec_group.param_arrays, self._exec_group.grad_arrays))
            if g is not None]
        self._updater.update_multi([i for i, _, _ in live],
                                   [g for _, _, g in live],
                                   [w for _, w, _ in live])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    # -------------------------------------------------- checkpoint state
    def _opt_counts(self):
        """Name-keyed update counts and the global count: the part of the
        optimizer's state that is not per-parameter arrays (Adam's bias
        correction, lr schedules)."""
        o = self._optimizer
        return {
            "num_update": int(o.num_update),
            "index_update_count": {
                self._param_names[i]: int(c)
                for i, c in o._index_update_count.items()
                if 0 <= i < len(self._param_names)}}

    def _restore_opt_counts(self, counts):
        o = self._optimizer
        o.num_update = int(counts.get("num_update", o.num_update))
        idx = {nm: i for i, nm in enumerate(self._param_names)}
        for nm, c in (counts.get("index_update_count") or {}).items():
            if nm in idx:
                o._index_update_count[idx[nm]] = int(c)

    def rng_chain(self):
        """The training step's key chain as uint32[2] (the JAX package's
        ``rng_chain``), or None when no chain is armed or a reseed since
        the last step means the next step draws a new one."""
        if self._step_key is None or self._step_gen != _random.generation():
            return None
        return np.array(self._step_key, dtype=np.uint32)

    def set_rng_chain(self, key):
        """Reinstate a checkpointed chain and tag it with the current
        generation, so the next step splits it instead of drawing anew."""
        self._step_key = np.array(key, dtype=np.uint32).reshape(2)
        self._step_gen = _random.generation()

    # ------------------------------------------------------ optimizer states
    def save_optimizer_states(self, fname):
        """Pickle the updater's states as host numpy arrays, keyed by
        parameter index, with the update counts (format 2 of the JAX
        package's staged layout)."""
        assert self.optimizer_initialized

        def host(v):
            if isinstance(v, NDArray):
                return v.asnumpy()
            if isinstance(v, (tuple, list)):
                return [host(x) for x in v]
            return v
        payload = {
            "__format__": 2,
            "states": {k: host(v) for k, v in self._updater.states.items()},
            **self._opt_counts()}
        with open(fname, "wb") as fout:
            pickle.dump(payload, fout)

    def load_optimizer_states(self, fname):
        """Restore what ``save_optimizer_states`` wrote; each state lands
        on its weight's device."""
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            payload = pickle.load(fin)
        if not (isinstance(payload, dict) and
                payload.get("__format__") == 2):
            raise MXNetError(f"{fname}: not an optimizer-state file of the "
                             "staged layout (format 2)")
        self._restore_opt_counts(payload)
        weights = self._exec_group.param_arrays

        def dev(v, ctx):
            if v is None:
                return None
            if isinstance(v, (tuple, list)):
                return tuple(dev(x, ctx) for x in v)
            return NDArray(v, ctx=ctx)
        self._updater.states = {
            int(i): dev(v, weights[int(i)].context)
            for i, v in payload["states"].items()}
