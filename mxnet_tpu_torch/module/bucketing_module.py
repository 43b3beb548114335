"""BucketingModule: one bound Module per bucket key over shared cells.

The *leader* module (default bucket) owns the parameter cells; every
other bucket binds with ``shared_module=`` the leader, so all buckets
alias the SAME parameter NDArrays and a bucket switch copies no weights.
The decode engine uses it as its slot-rung ladder (``_leader``,
``_buckets``, ``warm_buckets``).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._module_kwargs = dict(logger=logger, context=context)
        self._buckets = {}
        self._active_key = None

    def _generate(self, bucket_key):
        ret = self._sym_gen(bucket_key)
        if len(ret) != 3:
            raise ValueError(
                "sym_gen(bucket_key) must return (symbol, data_names, "
                "label_names)")
        return ret

    @property
    def _leader(self):
        return self._buckets[self._default_bucket_key]

    @property
    def _active(self):
        return self._buckets[self._active_key]

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the leader's cells (every bucket aliases them)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._leader.init_params(initializer=initializer,
                                 arg_params=arg_params,
                                 aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=False,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="null"):
        """Bind the leader (the default bucket)."""
        if shared_module is not None:
            raise ValueError("BucketingModule cannot itself be shared")
        if force_rebind:
            self.binded = False
            self._buckets = {}
            self._active_key = None
        if self.binded:
            self.logger.warning("Module is already bound; ignoring bind()")
            return
        sym, data_names, label_names = self._generate(
            self._default_bucket_key)
        leader = Module(sym, data_names, label_names, **self._module_kwargs)
        leader.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad)
        self._buckets[self._default_bucket_key] = leader
        self._active_key = self._default_bucket_key
        self.for_training = for_training
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Select (binding on first use) the module for ``bucket_key``."""
        assert self.binded, "bind() must run before switch_bucket()"
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._generate(bucket_key)
            mod = Module(sym, data_names, label_names,
                         **self._module_kwargs)
            mod.bind(data_shapes, label_shapes, self.for_training,
                     shared_module=self._leader)
            self._buckets[bucket_key] = mod
        self._active_key = bucket_key

    def warm_buckets(self, bucket_shapes):
        """Bind every bucket of ``(bucket_key, data_shapes, label_shapes)``
        up front (serving binds every rung before the first request);
        restores the active bucket and returns the keys bound."""
        assert self.binded and self.params_initialized, \
            "bind() + init_params() must run before warm_buckets()"
        prev = self._active_key
        bound = []
        for key, data_shapes, label_shapes in bucket_shapes:
            self.switch_bucket(key, data_shapes, label_shapes)
            bound.append(key)
        self._active_key = prev
        return bound

    def forward(self, data_batch, is_train=None):
        """Run ``data_batch`` on the module of its ``bucket_key`` (the
        default bucket when it has none), binding that bucket first if
        needed."""
        assert self.binded and self.params_initialized
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward(data_batch, is_train=is_train)

    def get_outputs(self, merge_multi_context=True):
        return self._active.get_outputs(merge_multi_context)
