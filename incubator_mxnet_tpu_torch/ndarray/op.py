"""Generated eager op namespace ``mx.nd.*`` (counterpart of
``incubator_mxnet_tpu/ndarray/op.py``; reference
python/mxnet/ndarray/op.py + register.py): one thin wrapper per
registered op.  Tensor inputs are positional (or keywords named after
the op's tensor parameters); attributes are keyword arguments; ``out=``
writes the results in place; ``ctx=`` places an op without NDArray
inputs (a random draw, an init op)."""
from __future__ import annotations

import sys

from ..ops import find_op, get_op, list_ops
from .ndarray import invoke

_module = sys.modules[__name__]


def _make_wrapper(opname):
    op = get_op(opname)

    def wrapper(*args, out=None, name=None, ctx=None, **kwargs):
        inputs = list(args)
        # tensor kwargs by positional-parameter name (mxnet style)
        if op.arg_names and kwargs:
            for an in op.arg_names:
                if an in kwargs and (hasattr(kwargs[an], "shape")
                                     or kwargs[an] is None):
                    inputs.append(kwargs.pop(an))
        return invoke(op, inputs, kwargs, out=out, ctx=ctx)

    wrapper.__name__ = opname
    wrapper.__qualname__ = opname
    wrapper.__doc__ = op.fn.__doc__
    return wrapper


def _populate(target=None):
    target = target if target is not None else _module
    for name in list_ops():
        if not hasattr(target, name):
            setattr(target, name, _make_wrapper(name))


_populate()


def __getattr__(name):
    if find_op(name) is None:
        raise AttributeError(name)
    w = _make_wrapper(name)
    setattr(_module, name, w)
    return w
