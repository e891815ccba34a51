"""Executor — a Symbol bound to arrays (counterpart of
``incubator_mxnet_tpu/executor.py``; reference include/mxnet/executor.h +
src/executor/graph_executor.cc).

The JAX executor jits the whole DAG into one forward program and its
``jax.vjp``.  Here bind builds the graph's plan once (``symbol._Plan``:
topological order, op functions with their attributes, input slots) and
``forward`` replays it eagerly on the bound tensors, on the context's
device, through the same registry ops as ``mx.nd`` (so the fused ops
reach the hand-written kernels on the card).

* ``forward(is_train=True)`` records the replay with torch autograd when
  any argument's ``grad_req`` is not ``null``; ``backward`` differentiates
  that recorded graph (no replay: dropout masks are the forward's) and
  keeps it, so a second ``backward`` adds the same gradients again under
  ``grad_req="add"``, as the JAX package's replay does.  ``out_grads=None``
  means head gradients of ones.  Gradients are written into ``grad_dict``
  in place (``write``) or added (``add``).
* BatchNorm's moving statistics are folded in training and written back
  into ``aux_dict`` (rebinding each array), as the JAX executor writes
  back its in-trace updates.
* Any ``forward`` drops the previous recorded graph, so ``backward``
  after an ``is_train=False`` forward raises; so does a ``backward``
  after the weights were updated in place (the JAX executor replays the
  forward at the arrays it kept).  Both are known differences.
* ``group2ctx`` places each ``ctx_group`` variable's argument, aux and
  gradient arrays on its group's context (reference PlaceDevice pass),
  as the JAX executor does; the graph is computed on the executor's
  device, so the replay moves a placed array there where an op consumes
  it (differentiably), and its gradient comes back into the grad array
  on the group's context.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .base import MXNetError
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray, _shares
from .symbol.symbol import _Plan

__all__ = ["Executor"]


class Executor:
    """Executable bound graph (reference executor.py:Executor)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None):
        from .context import current_context
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device()
        self._group2ctx = dict(group2ctx or {})
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        if isinstance(args, (list, tuple)):
            if len(args) != len(self.arg_names):
                raise MXNetError(
                    f"bind: expected {len(self.arg_names)} args "
                    f"({self.arg_names}), got {len(args)}")
            args = dict(zip(self.arg_names, args))
        if args is None:
            raise MXNetError("bind requires args")
        self.arg_dict = {}
        for name in self.arg_names:
            if name not in args:
                raise MXNetError(f"bind: missing argument {name}")
            self.arg_dict[name] = args[name]

        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.aux_names, aux_states))
        self.aux_dict = dict(aux_states or {})
        for name in self.aux_names:
            if name not in self.aux_dict:
                raise MXNetError(f"bind: missing aux state {name}")

        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.arg_names, args_grad))
        self.grad_dict = dict(args_grad or {})
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)

        if self._group2ctx:
            self._place_groups(symbol)

        self.outputs = []
        self._monitor_callback = None
        self._all_names = self.arg_names + self.aux_names
        self._plan = _Plan(symbol, self._all_names, self._device)
        # positions (in _all_names) of the arrays that get gradients
        self._grad_pos = [i for i, n in enumerate(self._all_names)
                          if self.grad_req.get(n, "null") != "null"
                          and n in self.grad_dict]
        self._graph = None      # (heads, leaves) of the last recorded run

    def _place_groups(self, symbol):
        """group2ctx placement (reference PlaceDevice pass,
        graph_executor.cc:406): a var's ``ctx_group`` names the context
        its arrays live on."""
        for node in symbol._topo():
            group = node.attr("ctx_group") if node.is_var else None
            target = self._group2ctx.get(group) if group else None
            if target is None:
                continue
            for d in (self.arg_dict, self.aux_dict, self.grad_dict):
                if node._name in d:
                    d[node._name] = d[node._name].as_in_context(target)

    # ------------------------------------------------------------ public
    def forward(self, is_train=False, **kwargs):
        """Run the forward (reference Executor.forward).  kwargs update
        argument values by name."""
        self._graph = None
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"unknown argument {name}")
            target = self.arg_dict[name]
            if isinstance(val, NDArray):
                val = val._data
            elif not isinstance(val, torch.Tensor):
                val = torch.as_tensor(np.asarray(val))
            target._write(val.to(target._data.device, target._data.dtype))

        tensors = [self.arg_dict[n]._data for n in self.arg_names] + \
            [self.aux_dict[n]._data for n in self.aux_names]
        record = is_train and bool(self._grad_pos)
        if record:
            leaves = {p: tensors[p].detach().requires_grad_(True)
                      for p in self._grad_pos}
            tensors = [leaves.get(i, t) for i, t in enumerate(tensors)]
        with autograd._Scope(recording=False, training=is_train), \
                torch.set_grad_enabled(record):
            # arrays group2ctx placed on another device cross to the
            # executor's, on the tape (their gradients cross back)
            tensors = [t.to(self._device) for t in tensors]
            outs, updates = self._plan.run(tensors, is_train)
        if record:
            self._graph = (outs, leaves)
        for name, val in updates.items():
            target = self.aux_dict.get(name)
            if target is None:
                target = self.arg_dict.get(name)
            target._data = val.to(target._data.device, target._data.dtype)

        self.outputs = [NDArray(self._own(o), self._ctx) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self.output_names, self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def _own(self, out):
        """An output as its NDArray holds it: detached, and copied when
        it shares storage with a bound array (an argument or auxiliary
        state passed straight through), which later writes would
        change."""
        out = out.detach()
        for d in (self.arg_dict, self.aux_dict):
            for arr in d.values():
                if _shares(out, arr._data):
                    return out.clone()
        return out

    def backward(self, out_grads=None):
        """Gradients of the recorded forward, written into grad_dict by
        grad_req (reference Executor.backward)."""
        if self._graph is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._graph
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
                out_grads = [out_grads]
            cots = []
            for g, o in zip(out_grads, outs):
                g = g._data if isinstance(g, NDArray) else \
                    torch.as_tensor(np.asarray(g))
                cots.append(g.to(o.device, o.dtype))
        heads = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        positions = list(leaves)
        grads = [None] * len(positions)
        if heads:
            grads = torch.autograd.grad(
                [o for o, _ in heads], [leaves[p] for p in positions],
                [c for _, c in heads], retain_graph=True, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(positions, grads):
                name = self._all_names[p]
                target = self.grad_dict[name]._data
                if g is None:
                    g = torch.zeros_like(target)
                if self.grad_req.get(name) == "add":
                    target.add_(g.to(target.dtype))
                else:
                    target.copy_(g)

    def set_monitor_callback(self, callback):
        """(reference GraphExecutor::SetMonitorCallback)"""
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """(reference Executor.copy_params_from)"""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                self._copy_into(self.arg_dict[name], array)
            elif not allow_extra_params:
                raise MXNetError(f"Found name {name!r} that is not in the"
                                 " arguments")
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                self._copy_into(self.aux_dict[name], array)
            elif not allow_extra_params:
                raise MXNetError(f"Found name {name!r} that is not in the"
                                 " auxiliary states")

    @staticmethod
    def _copy_into(target, array):
        src = array._data if isinstance(array, NDArray) else \
            torch.as_tensor(np.asarray(array))
        target._write(src.to(target._data.device, target._data.dtype))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Re-bind with new shapes, sharing the arrays whose shape is
        unchanged (reference Executor.reshape)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = {}
        for name, shape in zip(self.arg_names, arg_shapes):
            old = self.arg_dict[name]
            new_args[name] = old if tuple(old.shape) == tuple(shape) else \
                _nd.zeros(shape, ctx=self._ctx, dtype=old.dtype)
        new_aux = {}
        for name, shape in zip(self.aux_names, aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if tuple(old.shape) == tuple(shape) else \
                _nd.zeros(shape, ctx=self._ctx, dtype=old.dtype)
        grads = {n: _nd.zeros(new_args[n].shape, ctx=self._ctx)
                 for n in self.grad_dict}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self.grad_req, new_aux)

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    def debug_str(self):
        lines = ["Symbolic executor:"]
        for n in self.arg_names:
            lines.append(f"  arg {n}: {tuple(self.arg_dict[n].shape)}")
        return "\n".join(lines)
