"""Basic Gluon layers of the port (counterpart of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``; reference
python/mxnet/gluon/nn/basic_layers.py): ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``, ``BNReLU``,
``InstanceNorm``, ``LayerNorm``, ``Embedding``, ``Flatten``, ``Lambda``
and ``HybridLambda``.

These are the public, Gluon family of ``gluon.nn``: the JAX package's
constructors, Gluon ``Parameter``s, ``NDArray`` in and out, each
forward a ``hybrid_forward`` over the ``nd`` ops.  The tensor-level
``nn.Module`` layers that the model zoo and the training step build on
are the other family, in ``gluon.nn._modules``.
"""
from __future__ import annotations

import warnings

import numpy as np

from ... import ndarray as nd_mod
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "BNReLU", "Embedding", "Flatten", "Lambda", "HybridLambda",
           "InstanceNorm", "LayerNorm"]


class Sequential(Block):
    """Stack of Blocks run sequentially (reference basic_layers.py:Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn(
                "All children of this Sequential layer are HybridBlocks. "
                "Consider using HybridSequential for the best performance.",
                stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (reference basic_layers.py:HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer: out = act(dot(x, W^T) + b)
    (reference basic_layers.py:Dense; op FullyConnected,
    src/operator/nn/fully_connected-inl.h)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._in_units = in_units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten, no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return f"Dense({shape[1] if shape and len(shape) > 1 else None} -> " \
               f"{self._units}, " \
               f"{'linear' if self.act is None else self.act._act_type})"


class Dropout(HybridBlock):
    """Dropout (reference basic_layers.py:Dropout; op
    src/operator/nn/dropout-inl.h), active only in train mode
    (``autograd.record()`` / ``train_mode``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization (reference basic_layers.py:BatchNorm; op
    src/operator/nn/batch_norm-inl.h).  The moving statistics are
    auxiliary Parameters (``grad_req='null'``) that the ``nd`` front end
    folds in training."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_mean._is_aux = True
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var._is_aux = True

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return f"{type(self).__name__}(axis={self._axis}, " \
               f"eps={self._kwargs['eps']}, " \
               f"momentum={self._kwargs['momentum']}, in_channels={in_channels})"


class BNReLU(BatchNorm):
    """BatchNorm + ReLU as one op (``_FusedBatchNormRelu``): the math and
    parameters of BatchNorm then Activation('relu'), with the lean
    backward that reads one full activation tensor fewer.  Named as
    BatchNorm, so checkpoints interchange."""

    def _alias(self):
        return "batchnorm"

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F._FusedBatchNormRelu(x, gamma, beta, running_mean,
                                     running_var, **self._kwargs)


class InstanceNorm(HybridBlock):
    """Instance normalization (reference src/operator/instance_norm-inl.h)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        self._axis = axis
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis (op LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Index -> dense vector lookup (reference basic_layers.py:Embedding;
    op src/operator/tensor/indexing_op.cc Embedding), a gather;
    ``sparse_grad=True`` marks the weight's gradient ``row_sparse``:
    ``gluon.Trainer`` updates only its rows with a nonzero gradient."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim}, " \
               f"{self.weight.dtype})"


class Flatten(HybridBlock):
    """Collapse all but the batch axis (reference basic_layers.py:Flatten)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap a function as a Block (reference basic_layers.py:Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not (hasattr(nd_mod, function)):
                raise ValueError(f"Function name {function} is not found in ndarray.")
            self._func_impl = getattr(nd_mod, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda")

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """Wrap a function as a HybridBlock (reference basic_layers.py:HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not (hasattr(nd_mod, function)):
                raise ValueError(f"Function name {function} is not found in ndarray.")
            self._func = lambda F, *args: getattr(F, function)(*args)
        elif callable(function):
            self._func = function
        else:
            raise ValueError("Unrecognized function in lambda")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

