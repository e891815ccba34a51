"""BucketingModule: one executor per bucket sharing one parameter set
(counterpart of ``incubator_mxnet_tpu/module/bucketing_module.py``;
reference python/mxnet/module/bucketing_module.py:35).

Each bucket (a sequence length, say) binds its own executor from
``sym_gen(key)``; parameters are shared by binding every bucket's
executor against the default bucket's arrays (``shared_module``), so
switching buckets costs one bind the first time and nothing after.
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _gen_symbol(self, key):
        out = self._sym_gen(key)
        if isinstance(out, tuple):
            sym, data_names, label_names = out
        else:
            sym, data_names, label_names = out, ("data",), ("softmax_label",)
        return sym, data_names, label_names

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._gen_symbol(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._gen_symbol(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            self.logger.warning(
                "Parameters already initialized and force_init=False."
                " set_params call ignored.")
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        sym, dnames, lnames = self._gen_symbol(self._default_bucket_key)
        module = Module(sym, dnames, lnames, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Bind-or-reuse the executor for `bucket_key`
        (reference bucketing_module.py:switch_bucket)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            sym, dnames, lnames = self._gen_symbol(bucket_key)
            module = Module(sym, dnames, lnames, logger=self.logger,
                            context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            module.bind(data_shapes, label_shapes, self._curr_module.
                        for_training, self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key])
            if self.optimizer_initialized:
                # buckets bound after init_optimizer share the updater
                # (reference switch_bucket leaves this to init_optimizer's
                # loop; here late buckets borrow on creation)
                module.borrow_optimizer(
                    self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Ensure the batch's bucket is bound, then switch back so the
        current batch's outputs/metrics still read from its own module
        (reference bucketing_module.py:prepare switches and restores)."""
        if data_batch.bucket_key is not None:
            original = self._curr_bucket_key
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
            self.switch_bucket(original, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if data_batch.bucket_key is not None and \
                data_batch.bucket_key != self._curr_bucket_key:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
