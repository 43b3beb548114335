"""Module: binds one Symbol on one context for inference."""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import current_context
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Predict over a single Symbol bound to one context (default: the
    current context, ``gpu(0)`` unless a ``with mx.cpu():`` scope says
    otherwise)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None):
        super().__init__(logger=logger)
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

    # ---------------------------------------------------------------- params
    def get_params(self):
        """(arg_params, aux_params): name -> the bound cells."""
        assert self.binded and self.params_initialized
        return self._arg_params, self._aux_params

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the bound cells, in place: from ``arg_params`` /
        ``aux_params`` (name -> NDArray or array) where present, else by
        ``initializer(name, cell)`` when one is given. A parameter found
        in neither raises unless ``allow_missing`` — then it keeps its
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
    def bind(self, data_shapes, label_shapes=None, for_training=False,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="null"):
        """Allocate the cells of the bound graph. With ``shared_module``
        (bound and initialized) the parameter cells are that module's own
        objects, and so are aux cells of equal shape and dtype."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Module is already bound; ignoring bind() "
                                "(use force_rebind=True to re-bind)")
            return
        if for_training or inputs_need_grad:
            raise MXNetError("the port binds for inference only (training "
                             "is not ported yet): for_training=False")
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, False, shared_group, logger=self.logger)
        self.binded = True
        if shared_module is not None:
            exe = self._exec_group.executor
            self._arg_params = {n: exe.arg_dict[n]
                                for n in self._param_names}
            self._aux_params = dict(exe.aux_dict)
            self.params_initialized = True

    # --------------------------------------------------------------- forward
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)
