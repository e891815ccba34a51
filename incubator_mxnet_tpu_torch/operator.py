"""User-defined operators from Python (counterpart of
``incubator_mxnet_tpu/operator.py``; reference python/mxnet/operator.py:
CustomOp :422, CustomOpProp :662, register :732; backend
src/operator/custom/custom.cc).

The same API::

    @mx.operator.register("softmax_custom")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)
        def list_arguments(self): return ['data', 'label']
        def list_outputs(self):   return ['output']
        def infer_shape(self, in_shape): ...
        def create_operator(self, ctx, shapes, dtypes): return Softmax()

    out = mx.nd.Custom(data, label, op_type="softmax_custom")
    sym = mx.sym.Custom(data=d, label=l, op_type="softmax_custom")

The registry op ``Custom`` runs the user's ``forward`` and ``backward``
on NDArrays inside a ``torch.autograd.Function`` (``_CustomFunction``),
with the port's autograd paused, so the user's backward is the
gradient (the JAX package wraps the pair in ``jax.custom_vjp``).
Auxiliary states get zero gradients.
"""
from __future__ import annotations

import torch

from .base import MXNetError, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]

_REGISTRY = {}


class CustomOp:
    """Base class for custom operators (reference operator.py:422)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Write src into dst honoring the req mode
        (reference operator.py:455)."""
        if req in ("null", None):
            return
        value = src._data if hasattr(src, "_data") else torch.as_tensor(src)
        if req in ("write", "inplace"):
            dst._write(value.to(dst._data.device))
        elif req == "add":
            dst._write(dst._data + value.to(dst._data.device))
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Operator properties: argument/output names, shape/type inference,
    operator creation (reference operator.py:662)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        """Default: all outputs shaped like input 0, aux unchanged."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def needs_top_grad(self):
        return self.need_top_grad_


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under `reg_name`
    (reference operator.py:732 register)."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError(
                f"{prop_cls.__name__} must subclass CustomOpProp")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_prop_cls(op_type):
    if op_type not in _REGISTRY:
        raise MXNetError(
            f"custom op type {op_type!r} is not registered "
            f"(known: {sorted(_REGISTRY)})")
    return _REGISTRY[op_type]


def _make_prop(op_type, kwargs):
    # reference passes all kwargs to the prop ctor as strings
    return get_prop_cls(op_type)(**{k: str(v) for k, v in kwargs.items()})


def _nds(tensors):
    from .ndarray.ndarray import NDArray
    return [NDArray(t) for t in tensors]


class _CustomFunction(torch.autograd.Function):
    """The user's forward as the forward, the user's backward as the
    backward; the head gradients, inputs and outputs reach them as
    NDArrays."""

    @staticmethod
    def forward(ctx, op, is_train, n_args, out_specs, *xs):
        from . import autograd
        out_nd = _nds(torch.zeros(s, dtype=t, device=xs[0].device)
                      for s, t in out_specs)
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(out_nd),
                       _nds(xs[:n_args]), out_nd, _nds(xs[n_args:]))
        outs = tuple(o._data for o in out_nd)
        ctx.op, ctx.n_args = op, n_args
        ctx.save_for_backward(*xs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *cots):
        from . import autograd
        saved = ctx.saved_tensors
        n_in = len(saved) - len(cots)
        xs, outs = saved[:n_in], saved[n_in:]
        n_args = ctx.n_args
        cots = [torch.zeros_like(o) if c is None else c
                for c, o in zip(cots, outs)]
        in_grad = _nds(torch.zeros_like(x) for x in xs[:n_args])
        with autograd.pause():
            ctx.op.backward(["write"] * n_args, _nds(cots),
                            _nds(xs[:n_args]), _nds(outs), in_grad,
                            _nds(xs[n_args:]))
        # aux states receive no gradient (reference: aux excluded)
        return (None, None, None, None) + tuple(
            g._data for g in in_grad) + tuple(
            torch.zeros_like(x) for x in xs[n_args:])


def _custom_fn(*arrays, op_type, is_train=True, **kwargs):
    """Registry-facing functional form: tensors in and out, with the
    user's backward as the gradient.  Shared by ``nd.Custom`` and the
    symbol executor."""
    import numpy as np
    prop = _make_prop(op_type, kwargs)
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(arrays) != n_args + n_aux:
        raise MXNetError(
            f"Custom({op_type}) takes {n_args} args + {n_aux} aux, "
            f"got {len(arrays)} inputs")
    in_shapes = [list(a.shape) for a in arrays[:n_args]]
    out_shapes = [tuple(s) for s in prop.infer_shape(in_shapes)[1]]
    in_types = [np.dtype(str(a.dtype).replace("torch.", ""))
                for a in arrays[:n_args]]
    out_types = [torch_dtype(t) for t in prop.infer_type(in_types)[1]]
    op = prop.create_operator(None, in_shapes, in_types)
    res = _CustomFunction.apply(op, bool(is_train), n_args,
                                list(zip(out_shapes, out_types)), *arrays)
    return res[0] if len(prop.list_outputs()) == 1 else res


def _register_custom_op():
    """Expose as registry op 'Custom' so mx.nd.Custom / mx.sym.Custom and
    the graph executor dispatch it like any other operator."""
    from .ops.registry import register_op
    from . import ndarray
    from .ndarray import op as ndop

    register_op("Custom", _custom_fn, num_outputs=None)
    ndop._populate()
    ndop._populate(ndarray)


_register_custom_op()
