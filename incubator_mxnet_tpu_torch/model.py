"""Checkpoints, ``BatchEndParam`` and the legacy ``FeedForward``
(counterpart of ``incubator_mxnet_tpu/model.py``; reference
python/mxnet/model.py).

The checkpoint format is the reference's and the JAX package's:
``prefix-symbol.json`` + ``prefix-%04d.params`` with ``arg:``/``aux:``
key prefixes (model.py:366 save_checkpoint, :396 load_checkpoint), so
checkpoints cross between the two packages.  ``FeedForward`` is a thin
shim over ``mx.mod.Module`` that takes numpy arrays.
"""
from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

from .context import cpu
from .ndarray import utils as nd_utils

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save prefix-symbol.json + prefix-%04d.params
    (reference model.py:366)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_utils.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) from a checkpoint
    (reference model.py:396).  The params come back as host arrays
    (``cpu()``), whatever the current context: a module or predictor
    copies them to its own device."""
    from .symbol import symbol as sym_mod
    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym_mod.load(f"{prefix}-symbol.json")
    with cpu():
        save_dict = nd_utils.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy training wrapper (reference python/mxnet/model.py:FeedForward
    — deprecated there in favor of Module, kept for old scripts): a thin
    shim over mx.mod.Module with the fit/predict/score/save/load/create
    surface, accepting numpy arrays directly.  ``ctx=None`` is the
    current context (``gpu(0)`` by the port's convention)."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0,
                 **optimizer_params):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.optimizer_params = dict(optimizer_params)
        self._module = None

    # ------------------------------------------------------------ helpers
    def _label_names(self):
        labels = [n for n in self.symbol.list_arguments()
                  if n.endswith("_label")]
        return tuple(labels) or ("softmax_label",)

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        X = np.asarray(X, np.float32)
        if y is not None:
            y = np.asarray(y, np.float32)
        batch = min(self.numpy_batch_size, len(X))
        return NDArrayIter(X, y, batch_size=batch, shuffle=shuffle,
                           label_name=self._label_names()[0])

    def _ensure_module(self, data_iter):
        from .module import Module

        if self._module is None:
            data_names = tuple(d.name for d in data_iter.provide_data)
            label_names = tuple(l.name for l in data_iter.provide_label) \
                or self._label_names()
            self._module = Module(self.symbol, data_names=data_names,
                                  label_names=label_names,
                                  context=self.ctx)
        return self._module

    # ------------------------------------------------------------- public
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, num_epoch=None):
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._ensure_module(train)
        if logger is not None:
            mod.logger = logger
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=tuple(self.optimizer_params.items()),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                # a load->score->fit fine-tune flow leaves the module
                # bound for inference (grad_req null); always rebind for
                # training or the fit would silently update nothing
                force_rebind=True,
                num_epoch=num_epoch or self.num_epoch or 1)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None):
        it = self._as_iter(X)
        mod = self._ensure_module(it)
        if not mod.binded:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
        outs = mod.predict(it, num_batch=num_batch)
        if isinstance(outs, list):
            if len(outs) > 1:   # multi-output symbol: keep every output
                return [np.asarray(o.asnumpy()) for o in outs]
            outs = outs[0]
        return np.asarray(outs.asnumpy())

    def score(self, X, y=None, eval_metric="acc"):
        it = self._as_iter(X, y)
        mod = self._ensure_module(it)
        if not mod.binded:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {})
        res = mod.score(it, eval_metric)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """model.FeedForward.save -> the standard two-artifact checkpoint."""
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=1,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **optimizer_params):
        """Train and return a fitted model (reference model.py
        FeedForward.create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer,
                            **optimizer_params)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger)
        return model
