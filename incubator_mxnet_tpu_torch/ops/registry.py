"""Operator registry of the port (counterpart of
``incubator_mxnet_tpu/ops/registry.py``; reference nnvm Op registry).

An op is a plain function on tensors with keyword-only attributes.
Tensor inputs are positional (``None`` for an absent optional input);
the function is the whole op: the eager front end (``ndarray.invoke``)
calls it, and its gradient is torch autograd's.  There is no ``jit``
here: PyTorch runs eagerly.

* ``differentiable=False`` ops (argmax, comparisons, random draws) run
  without autograd even under ``autograd.record()``.
* ``needs_rng`` ops get a ``torch.Generator`` of their device as their
  first argument, from ``random.generator``.
* An op whose attributes include ``device`` gets the context's
  ``torch.device`` when the caller gives none (ops without tensor
  inputs: the init ops).
"""
from __future__ import annotations

import inspect

from ..base import registry

__all__ = ["Operator", "register_op", "alias_op", "get_op", "find_op",
           "list_ops", "normalize_attrs"]

_OPS = registry("op")


class Operator:
    """A registered operator: ``name``, the function ``fn(*tensors,
    **attrs)`` returning a tensor or a tuple of tensors, and its flags."""

    def __init__(self, name, fn, differentiable=True, num_outputs=1,
                 needs_rng=False):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        sig = inspect.signature(fn)
        self.attr_names = tuple(
            p.name for p in sig.parameters.values()
            if p.kind == inspect.Parameter.KEYWORD_ONLY)
        self.arg_names = tuple(
            p.name for p in sig.parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD))
        if needs_rng:
            self.arg_names = self.arg_names[1:]
        # takes any number of tensor inputs (``*args``): Concat, Custom
        self.variadic = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                            for p in sig.parameters.values())

    def __repr__(self):
        return f"<Operator {self.name}>"


def normalize_attrs(attrs):
    """Drop ``None`` attributes: the op's default applies, as in the JAX
    package."""
    return {k: v for k, v in attrs.items() if v is not None}


def register_op(name, fn=None, aliases=(), differentiable=True,
                num_outputs=1, needs_rng=False):
    """Register an operator; usable as decorator or direct call.  Returns
    ``fn``."""
    if fn is None:
        return lambda f: register_op(name, f, aliases, differentiable,
                                     num_outputs, needs_rng)
    op = Operator(name, fn, differentiable=differentiable,
                  num_outputs=num_outputs, needs_rng=needs_rng)
    _OPS.register(name, op, aliases=aliases)
    return fn


def alias_op(name, *aliases):
    op = _OPS.get(name)
    for a in aliases:
        _OPS.register(a, op)


def get_op(name) -> Operator:
    return _OPS.get(name)


def find_op(name):
    return _OPS.find(name)


def list_ops():
    return _OPS.names()
