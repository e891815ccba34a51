"""Module: intermediate-level training interface over one Symbol
(counterpart of ``incubator_mxnet_tpu/module/module.py``; reference
python/mxnet/module/module.py:39).

One Executor on one context holds the bound graph (the reference binds
one per GPU and reduces through a kvstore).  ``init_optimizer`` sets
``rescale_grad = 1/batch`` unless given (SoftmaxOutput's gradients are
per-sample sums); the ``local`` and ``device`` kvstores are no-ops with
one executor, and ``dist_*`` kvstores (or a kvstore object) raise until
multi-device support (ROADMAP A6).  ``update`` runs the optimizer's
updater once per parameter, in place.  A forward with another batch
size rebinds the executor, keeping the parameters.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import cpu, current_context
from ..executor import Executor
from ..initializer import Uniform, InitDesc
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _assign(arr, value):
    """Write ``value`` (an NDArray, tensor or numpy array) into ``arr``,
    on arr's device and in its dtype."""
    src = value._data if isinstance(value, NDArray) else \
        torch.as_tensor(np.asarray(value))
    arr._write(src.to(arr._data.device, arr._data.dtype))


def _shape_dict(shapes):
    """[(name, shape)] or [DataDesc] -> {name: shape}"""
    out = {}
    for item in shapes or []:
        if isinstance(item, tuple) and not hasattr(item, "name"):
            name, shape = item[0], item[1]
        else:
            name, shape = item.name, item.shape
        out[name] = tuple(shape)
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            context = context[0] if context else cpu()
        self._context = context
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        # label may legitimately be absent from the symbol (inference nets)
        args = symbol.list_arguments()
        label_names = [n for n in label_names if n in args]
        self._data_names = data_names
        self._label_names = label_names
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        self._param_names = [n for n in args
                             if n not in data_names and n not in label_names
                             and n not in self._state_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._grad_req = None
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec.outputs:
            return [(n, tuple(o.shape)) for n, o in
                    zip(self.output_names, self._exec.outputs)]
        shape_kwargs = _shape_dict(self._data_shapes)
        if self._label_shapes:
            shape_kwargs.update(_shape_dict(self._label_shapes))
        _, out_shapes, _ = self._symbol.infer_shape(**shape_kwargs)
        return list(zip(self.output_names, out_shapes))

    # ------------------------------------------------------------ binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None
        shape_kwargs = _shape_dict(data_shapes)
        shape_kwargs.update(_shape_dict(label_shapes))
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_kwargs)
        arg_names = self._symbol.list_arguments()
        arg_shape_map = dict(zip(arg_names, arg_shapes))
        aux_shape_map = dict(zip(self._aux_names, aux_shapes))

        args, grads, reqs = {}, {}, {}
        for name in arg_names:
            shape = arg_shape_map[name]
            if shared_module is not None and \
                    name in (shared_module._param_names +
                             shared_module._aux_names):
                # share parameter memory with the shared module (bucketing:
                # per-bucket executors over one parameter set)
                args[name] = shared_module._exec.arg_dict[name]
            else:
                args[name] = _nd.zeros(shape, ctx=self._context)
            if name in self._data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or \
                    name in self._fixed_param_names or not for_training:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req if isinstance(grad_req, str) else \
                    grad_req.get(name, "write")
            if reqs[name] != "null":
                grads[name] = _nd.zeros(arg_shape_map[name],
                                        ctx=self._context)
        aux = {}
        for name in self._aux_names:
            if shared_module is not None and \
                    name in shared_module._exec.aux_dict:
                aux[name] = shared_module._exec.aux_dict[name]
            else:
                aux[name] = _nd.zeros(aux_shape_map[name], ctx=self._context)

        self._exec = Executor(self._symbol, self._context, args, grads,
                              reqs, aux)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # re-binding with already-initialized (e.g. Module.load'd)
            # params: push them into the fresh executor (reference
            # module.py:435)
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # ------------------------------------------------------------ params
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_exec()
        return self._arg_params, self._aux_params

    def _sync_params_from_exec(self):
        for name in self._param_names:
            _assign(self._arg_params[name], self._exec.arg_dict[name])
        for name in self._aux_names:
            _assign(self._aux_params[name], self._exec.aux_dict[name])
        self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if self._arg_params is None:
            self._arg_params = {
                n: _nd.zeros(self._exec.arg_dict[n].shape, ctx=self._context)
                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                n: _nd.zeros(self._exec.aux_dict[n].shape, ctx=self._context)
                for n in self._aux_names}

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if tuple(np.shape(cache_arr)) != tuple(arr.shape):
                    raise MXNetError(
                        f"shape mismatch for {name}: saved"
                        f" {tuple(np.shape(cache_arr))} vs bound"
                        f" {tuple(arr.shape)}")
                _assign(arr, cache_arr)
                return
            if cache is not None and not allow_missing:
                raise RuntimeError(f"{name} is not presented")
            if initializer is not None:
                buf = np.zeros(arr.shape, dtype=str(arr.dtype))
                initializer(InitDesc(name), buf)
                _assign(arr, buf)

        for name in self._param_names:
            _impl(name, self._arg_params[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._aux_params[name], aux_params)
        if allow_extra is False and arg_params is not None:
            for name in arg_params:
                if name not in self._param_names and \
                        name not in self._data_names and \
                        name not in self._label_names:
                    if not allow_extra:
                        raise ValueError(
                            f"arg_params contains extra parameter {name}")
        self.params_initialized = True
        self._params_dirty = False
        # push values into the executor
        self._exec.copy_params_from(self._arg_params, self._aux_params,
                                    allow_extra_params=True)

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if isinstance(optimizer, str):
            batch_size = self._data_shapes[0][1][0] \
                if isinstance(self._data_shapes[0], tuple) \
                else self._data_shapes[0].shape[0]
            optimizer_params = dict(optimizer_params)
            # reference Module.init_optimizer defaults rescale_grad to
            # 1/batch_size (module.py:505) — SoftmaxOutput grads are
            # per-sample sums with normalization='null'
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer = optimizer
        idx2name = {i: n for i, n in enumerate(self._param_names)}
        optimizer.idx2name = idx2name
        self._updater = opt_mod.get_updater(optimizer)
        # one executor: the reduction of a single-process store type is
        # a no-op; a "dist_*" type or a store object takes the update
        # (push the gradient, pull the weight), with the module's
        # optimizer on the store, as the reference's update_on_kvstore
        # (the JAX Module sets no optimizer there, so its pull would
        # write the mean gradient into the weight)
        self._kvstore = None
        self._update_on_kvstore = False
        if kvstore is not None and not isinstance(kvstore, str):
            self._kvstore = kvstore
        elif isinstance(kvstore, str) and kvstore.startswith("dist"):
            from .. import kvstore as kvs
            self._kvstore = kvs.create(kvstore)
        if self._kvstore is not None:
            self._update_on_kvstore = True
            self._kvstore.set_optimizer(optimizer)
            for i, name in enumerate(self._param_names):
                # every rank starts from the store's (rank 0's) value
                self._kvstore.init(i, self._exec.arg_dict[name])
                self._kvstore.pull(i, out=self._exec.arg_dict[name])
        self.optimizer_initialized = True

    def borrow_optimizer(self, shared_module):
        """Share optimizer + updater state with another module (reference
        module.py:borrow_optimizer; used by BucketingModule)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self.optimizer_initialized = True

    # ------------------------------------------------------------ step
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        kwargs = {}
        data = data_batch.data
        for name, arr in zip(self._data_names, data):
            kwargs[name] = arr
        if self._label_names and data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                kwargs[name] = arr
        # allow a different batch size by rebinding (reference
        # Module.forward reshapes its executors the same way)
        new_shape = tuple(kwargs[self._data_names[0]].shape)
        bound_shape = tuple(self._exec.arg_dict[self._data_names[0]].shape)
        if new_shape != bound_shape:
            self._reshape_like(kwargs)
        self._exec.forward(is_train=is_train, **kwargs)

    def _reshape_like(self, kwargs):
        data_shapes = [(n, tuple(kwargs[n].shape)) for n in self._data_names]
        label_shapes = [(n, tuple(kwargs[n].shape))
                        for n in self._label_names if n in kwargs] or None
        self._sync_if_needed()
        self.binded = False
        self._exec = None
        self.bind(data_shapes, label_shapes,
                  for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad,
                  grad_req=self._grad_req, force_rebind=True)
        self._exec.copy_params_from(self._arg_params, self._aux_params,
                                    allow_extra_params=True)

    def _sync_if_needed(self):
        if self._params_dirty and self._arg_params is not None:
            self._sync_params_from_exec()

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply one optimizer step on accumulated gradients (reference
        module.py:629 -> model._update_params)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        for i, name in enumerate(self._param_names):
            w = self._exec.arg_dict[name]
            g = self._exec.grad_dict.get(name)
            if g is None:
                continue
            if self._kvstore is not None:
                self._kvstore.push(i, g)
                self._kvstore.pull(i, out=w)
            else:
                self._updater(i, g, w)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        assert self.binded
        mon.install_exec(self._exec)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """prefix-symbol.json + prefix-%04d.params (+ .states)
        (reference module.py:126)."""
        from .. import model
        arg_params, aux_params = self.get_params()
        model.save_checkpoint(prefix, epoch, self._symbol, arg_params,
                              aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """(reference module.py:load)"""
        from .. import model
        sym, args, auxs = model.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_optimizer_states(self, fname):
        """The optimizer states, from the store when it updates
        (reference module.py:save_optimizer_states)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
