"""BaseModule: the high-level train/predict interface (counterpart of
``incubator_mxnet_tpu/module/base_module.py``; reference
python/mxnet/module/base_module.py:BaseModule, fit at :376).

Intermediate-level API: bind -> init_params -> init_optimizer ->
forward/backward/update; `fit` wires the standard epoch loop with metrics
and callbacks on top.  Concrete subclasses: Module (one symbol),
BucketingModule (one executor per bucket over shared parameters),
SequentialModule.  The JAX ``fit`` also feeds the fault module's
periodic checkpoints, which wait for ROADMAP A6 here.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _check_input_names(symbol, names, typename, throw):
    """Check that input names are arguments of the symbol (reference
    base_module.py:_check_input_names)."""
    args = symbol.list_arguments()
    for name in names:
        if name not in args:
            msg = f"You created Module with Module(..., {typename}_names=" \
                  f"{names}) but input with name '{name}' is not found in " \
                  f"symbol.list_arguments(). Did you mean one of: \n\t" \
                  + "\n\t".join(args)
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # ---------------------------------------------------------- properties
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    # ------------------------------------------------------------ abstract
    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def deferred_metric_update(self, eval_metric, labels):
        """Capture this step's outputs NOW, return a thunk that folds
        them into the metric LATER — what `fit` pushes through a
        ``pipeline_io.MetricDrain`` so the host-side ``asnumpy`` of step
        *i* happens while step ``i+depth`` is already dispatched
        (each forward gives new output arrays, so holding them across
        steps is safe).  Deferral only applies when the subclass's
        ``update_metric`` is a stock ``metric.update(labels, outputs)``
        (Module's): a subclass that overrode ``update_metric`` with
        custom routing (label slicing, masking, per-bucket dispatch)
        but not this method gets its override called eagerly, so its
        logic is never silently lost during ``fit``."""
        from .module import Module
        um = type(self).update_metric
        if um is not BaseModule.update_metric and \
                um is not Module.update_metric:
            self.update_metric(eval_metric, labels)
            return lambda: None
        outputs = self.get_outputs()
        return lambda: eval_metric.update(labels, outputs)

    # ------------------------------------------------------------ derived
    def forward_backward(self, data_batch):
        """One fwd+bwd (reference base_module.py:forward_backward)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Assign parameters (reference base_module.py:set_params)."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Save params to file, arg:/aux: prefixed (reference
        base_module.py:save_params)."""
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        from ..ndarray import utils as nd_utils
        nd_utils.save(fname, save_dict)

    def load_params(self, fname):
        """(reference base_module.py:load_params)"""
        from ..ndarray import utils as nd_utils
        save_dict = nd_utils.load(fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError(f"Invalid param file {fname}")
        self.set_params(arg_params, aux_params)

    # ------------------------------------------------------------ evaluate
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a DataIter (reference base_module.py:score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
            actual_num_batch += 1
        if score_end_callback:
            param = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs, nbatch, batch) (reference
        base_module.py:iter_predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run inference over an iterator, concatenating batch outputs
        (reference base_module.py:predict)."""
        from ..ndarray import ndarray as _nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise ValueError(
                        "Cannot merge batches, as num of outputs is not the"
                        " same in mini-batches. Maybe bucketing is used?")
            output_list2 = [
                _nd.array(np.concatenate(
                    [out[i].asnumpy() for out in output_list]),
                    ctx=getattr(self, "_context", None))
                for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    # ------------------------------------------------------------ training
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The standard epoch loop (reference base_module.py:376)."""
        assert num_epoch is not None, "please specify number of epochs"

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        # non-blocking metric readback (pipeline_io.MetricDrain,
        # MXNET_METRIC_DRAIN_DEPTH): the asnumpy inside metric.update
        # happens `depth` steps late, so the host does not wait for
        # the step it just launched.  batch_end_callback metric values
        # lag by the drain depth; the epoch log flushes first.
        from ..pipeline_io import MetricDrain

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            metric_drain = MetricDrain()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                metric_drain.push(
                    self.deferred_metric_update(eval_metric,
                                                data_batch.label))
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1

            metric_drain.flush()      # mature deferred updates first
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)  # sync executor -> module cache
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # ------------------------------------------------------------ misc
    def prepare(self, data_batch):
        """Hook before forward on a new batch (reference
        base_module.py:prepare); bucketing modules switch buckets here."""

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_states(self, merge_multi_context=True):
        return []

    def set_states(self, states=None, value=None):
        pass


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
