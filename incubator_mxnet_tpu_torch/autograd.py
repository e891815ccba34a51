"""Imperative autograd on ``torch.autograd`` (counterpart of
``incubator_mxnet_tpu/autograd.py``; reference python/mxnet/autograd.py:
record/pause :122,146, backward :243, grad :270, Function :364).

The JAX package keeps its own tape of ``jax.vjp`` closures.  Here torch
records the graph: an op dispatched by ``ndarray.invoke`` runs with
gradients enabled only under ``record()`` (and only when it is
differentiable); everywhere else it runs under ``torch.no_grad()``, so
an in-place update of a variable outside ``record()`` is allowed and no
graph is kept alive.

``attach_grad()`` / ``mark_variables`` make the array's tensor a leaf
that requires grad and tag it with its NDArray.  ``backward`` walks the
heads' graph to the tagged leaves and asks ``torch.autograd.grad`` for
their gradients, then writes each into the NDArray's grad buffer by its
``grad_req``: ``write`` overwrites it in place, ``add`` accumulates,
``null`` leaves it; a written buffer's array gets ``_fresh_grad``,
which ``gluon.Trainer.step`` clears.  Torch's own ``.grad`` fields are never used, so
nothing accumulates behind the caller's back.  The graph is freed after
``backward`` unless ``retain_graph=True``, as in the reference (the
JAX tape keeps it either way).

**Writes into saved arrays.**  A JAX array is immutable: a write
rebinds the NDArray and the tape keeps differentiating at the values
it recorded.  Torch saves tensors by reference and refuses ``backward``
after one was written in place.  So ``saving()`` notes the storage of
each tensor that a recorded op's graph saves (a saved-tensor hook; the
note goes when torch frees the graph), and ``ndarray._write`` rebinds
instead of writing in place while one is saved (``rebind``): the graph
keeps the old tensor, and the array keeps its place in the graph, as
its JAX tape node does.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    """Turn recording on or off for this thread; returns the previous
    state."""
    prev = _st().recording
    _st().recording = bool(flag)
    return prev


def set_training(flag):
    """Turn training mode on or off for this thread; returns the
    previous state."""
    prev = _st().training
    _st().training = bool(flag)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._r, self._t = recording, training

    def __enter__(self):
        s = _st()
        self._pr, self._pt = s.recording, s.training
        if self._r is not None:
            s.recording = self._r
        if self._t is not None:
            s.training = self._t
        return self

    def __exit__(self, *exc):
        s = _st()
        s.recording, s.training = self._pr, self._pt


def record(train_mode=True):
    """Scope that turns on recording (python/mxnet/autograd.py:122)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


# ---------------------------------------------------------------- saved
class _Saved:
    """A tensor as a recorded graph holds it, with its storage's address;
    it lives exactly as long as the graph keeps it."""

    __slots__ = ("t", "key", "__weakref__")

    def __init__(self, t):
        self.t = t
        self.key = t.untyped_storage().data_ptr()
        _saved.add(self)


_saved = weakref.WeakSet()      # the _Saved of every live recorded graph


def saving():
    """Context of a recorded op: notes the tensors its graph saves."""
    if not torch.is_grad_enabled():
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(_Saved, lambda s: s.t)


def is_saved(t):
    """True when a live recorded graph has saved ``t``'s storage."""
    if t.numel() == 0:
        return False
    key = t.untyped_storage().data_ptr()
    return any(s.key == key for s in list(_saved))


class _Rebound(torch.autograd.Function):
    """``new``'s values in ``old``'s place in the graph: the gradient
    goes to ``old`` unchanged (the JAX package's ``_set_data`` keeps the
    array's tape node)."""

    @staticmethod
    def forward(ctx, old, new):
        return new.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def rebind(arr, value):
    """Give ``arr`` the values of tensor ``value`` (its shape and dtype)
    without touching its tensor, which a live graph has saved.  A
    variable gets a new leaf tagged as its own; an array computed under
    ``record()`` a tensor that stands in its place in the graph."""
    old = arr._data
    value = value.detach()
    if old.grad_fn is not None:
        with torch.enable_grad():
            arr._data = _Rebound.apply(old, value)
        return
    new = value.clone()
    if old.requires_grad:
        new.requires_grad_(True)
    var = getattr(old, "_mx_variable", None)
    if var is not None:
        new._mx_variable = var
    arr._data = new


# ---------------------------------------------------------------- variables
def mark_variables(variables, gradients, grad_reqs="write"):
    """Associate gradient buffers with variables
    (python/mxnet/autograd.py:mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, "
                             f"not {req!r}")
        v._grad = g
        v._grad_req = req
        t = v._data
        if not t.is_leaf:           # computed under record(): cut it off
            t = v._data = t.detach()
        if t.is_floating_point() and not t.requires_grad:
            t.requires_grad_(True)
        t._mx_variable = weakref.ref(v)


def _variable_of(t):
    """The variable whose leaf ``t`` is (or was, before a ``rebind``)."""
    ref = getattr(t, "_mx_variable", None)
    return ref() if ref is not None else None


def _leaves(heads):
    """The tagged leaf tensors the heads' graph reaches, in the order
    first met."""
    out, seen = [], set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            if _variable_of(var) is not None:
                out.append(var)
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return out


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h._data) for h in heads]
    from .ndarray import NDArray
    if isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    return [g._data if g is not None else torch.ones_like(h._data)
            for h, g in zip(heads, head_grads)]


@torch.no_grad()
def _store(var, g):
    if var._grad is None or var._grad_req == "null":
        return
    if var._grad_req == "add":
        var._grad._data.add_(g)
    else:
        var._grad._data.copy_(g)
    # the fresh-gradient bit that gluon.Trainer.step reads and clears
    var._fresh_grad = True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the grad buffers of every variable the
    heads depend on (reference MXAutogradBackwardEx), by each
    variable's ``grad_req``."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    grads_out = _head_grads(heads, head_grads)
    outputs, seeds = [], []
    for h, g in zip(heads, grads_out):
        if h._data.grad_fn is not None:
            outputs.append(h._data)
            seeds.append(g)
        elif _variable_of(h._data) is not None:
            _store(h, g)            # a variable as its own head
        else:
            raise MXNetError("head array is not connected to the autograd "
                             "graph (was it computed under "
                             "autograd.record()?)")
    if not outputs:
        return
    leaves = [t for t in _leaves(outputs)
              if _variable_of(t)._grad_req != "null"]
    if not leaves:
        return
    grads = torch.autograd.grad(outputs, leaves, seeds,
                                retain_graph=retain_graph, allow_unused=True)
    # a variable rebound under record() has two leaves: sum them
    total = {}
    for t, g in zip(leaves, grads):
        if g is not None:
            var = _variable_of(t)
            prev = total.get(id(var), (var, None))[1]
            total[id(var)] = (var, g if prev is None else prev + g)
    for var, g in total.values():
        _store(var, g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    as new NDArrays; the variables' grad buffers are untouched
    (python/mxnet/autograd.py:270)."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if isinstance(heads, NDArray):
        heads = [heads]
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("autograd.grad: every variable needs "
                             "attach_grad() before record()")
    seeds = _head_grads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad([h._data for h in heads],
                                [v._data for v in variables], seeds,
                                retain_graph=retain_graph,
                                create_graph=create_graph, allow_unused=True)
    out = [NDArray(g if g is not None else torch.zeros_like(v._data),
                   v.context) for g, v in zip(grads, variables)]
    return out[0] if single else out


class _Bridge(torch.autograd.Function):
    """Carries a user ``Function``'s forward and backward into torch's
    graph."""

    @staticmethod
    def forward(ctx, func, inputs, *tensors):
        ctx.func = func
        with pause():
            outs = func.forward(*inputs)
        ctx.outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return tuple(o._data for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        cots = [NDArray(g if g is not None else torch.zeros_like(o._data),
                        o.context) for g, o in zip(grads, ctx.outs)]
        with pause():
            igs = ctx.func.backward(*cots)
        if not isinstance(igs, (list, tuple)):
            igs = [igs]
        return (None, None) + tuple(g._data if g is not None else None
                                    for g in igs)


def get_symbol(x):
    """Not supported, as in the JAX package (the reference returns the
    recorded graph as a Symbol): the tape is torch autograd's graph, not
    a Symbol."""
    raise NotImplementedError(
        "get_symbol is not supported by the torch tape; use gluon "
        "hybridize() or the symbol API for graph capture")


class Function:
    """Customized differentiable function (python/mxnet/autograd.py:364),
    carried by a ``torch.autograd.Function``.  Subclass and override
    ``forward(*inputs)`` and ``backward(*output_grads)`` on NDArrays;
    call it imperatively: ``y = MyFunc()(x)``."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        tensors = _Bridge.apply(self, inputs, *(i._data for i in inputs))
        outs = [NDArray(t, inputs[0].context) for t in tensors]
        return outs[0] if len(outs) == 1 else outs
