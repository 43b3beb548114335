"""BaseModule: the state flags every module carries."""
from __future__ import annotations

import logging

__all__ = ["BaseModule"]


class BaseModule:
    """Shared module state; subclasses provide the executor plumbing."""

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

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError
