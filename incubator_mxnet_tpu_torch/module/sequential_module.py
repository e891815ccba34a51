"""SequentialModule: chain modules, output of k feeds input of k+1
(counterpart of ``incubator_mxnet_tpu/module/sequential_module.py``;
reference python/mxnet/module/sequential_module.py)."""
from __future__ import annotations

import logging

from ..initializer import Uniform
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append a module; meta kwargs: take_labels, auto_wiring
        (reference sequential_module.py:add)."""
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, f"Unknown meta {key}"
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module is not supported for SequentialModule"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_data_shapes = [
            d if hasattr(d, "name") else DataDesc(d[0], d[1])
            for d in data_shapes]
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas,
                                                     self._modules)):
            meta = dict(meta)
            if meta.get(self.META_TAKE_LABELS):
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = for_training and \
                (inputs_need_grad or i_layer > 0)
            if meta.get(self.META_AUTO_WIRING):
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [
                    DataDesc(new_name, d.shape)
                    for new_name, d in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            # outputs of this become data shapes of the next
            my_data_shapes = [
                DataDesc(name, shape)
                for name, shape in module.output_shapes]
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad, index=data_batch.index,
                          provide_data=data_batch.provide_data,
                          provide_label=data_batch.provide_label)
        for i_layer, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            batch = DataBatch(data=module.get_outputs(), label=batch.label,
                              pad=batch.pad, index=batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i_layer]
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels)

    def deferred_metric_update(self, eval_metric, labels):
        # per-module take-labels routing is not a plain
        # metric.update(labels, outputs): update eagerly and hand the
        # MetricDrain a no-op thunk
        self.update_metric(eval_metric, labels)
        return lambda: None

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
