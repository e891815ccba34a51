"""Block / HybridBlock of the port's Gluon (counterpart of
``incubator_mxnet_tpu/gluon/block.py``; reference
python/mxnet/gluon/block.py).

``Block`` subclasses ``torch.nn.Module``: child blocks are submodules,
so ``.children()``, ``.modules()``, ``.to()`` / ``.cuda()`` (which move
the Gluon parameters too) and ``.parameters()`` (the initialised
Parameters' tensors) work for torch code.  On top of that it keeps the
JAX package's Gluon surface: ``prefix`` / ``name`` / ``name_scope()``
with the ``_BlockScope`` counters, ``params`` and
``collect_params(select)``, ``register_child``, forward pre-hooks and
hooks (Gluon's: a handle with ``detach()``), ``apply``, ``cast``,
``initialize``, ``save_params`` / ``load_params`` (by attribute path,
with the JAX full-name fallback) and ``__call__`` on NDArrays.

``HybridBlock.forward`` runs ``hybrid_forward(nd, x, **params)`` with
the deferred initialisation of the JAX package: a parameter whose shape
is still unknown makes the layer run ``infer_shape`` on its inputs,
then allocate.  ``hybridize(active)`` is accepted and recorded
(``_active``), but the forward stays eager, with the same outputs either
way: the CUDA-graph form of ``hybridize`` is ROADMAP A4.
``HybridBlock.export`` writes the parameters in the checkpoint format
(``arg:``/``aux:`` keys, no symbol), as the JAX package does, and
``SymbolBlock`` runs a Symbol's graph as a block.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import ndarray as nd_mod
from ..context import cpu
from ..name import NameManager, Prefix
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name manager for nested blocks (reference
    gluon/block.py:_BlockScope): per-scope counters of each hint, the
    innermost scope thread-local."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    """Nested lists/tuples of NDArrays -> a flat list."""
    if isinstance(args, NDArray) or args is None:
        return [args]
    flat = []
    for a in args:
        flat.extend(_flatten(a))
    return flat


class _HookHandle:
    """Handle of a Gluon forward hook: ``detach()`` removes it."""

    _next_id = [0]

    def __init__(self, hooks_dict):
        self._hooks_dict = hooks_dict
        self._id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1

    def detach(self):
        self._hooks_dict.pop(self._id, None)

    remove = detach


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line
                                    for line in lines)


class Block(torch.nn.Module):
    """Base class of all Gluon layers and models (reference
    gluon/block.py:Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._gluon_pre_hooks = OrderedDict()
        self._gluon_hooks = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self._children.items())
        if not modstr:
            return f"{self.__class__.__name__}()"
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        if "_children" in self.__dict__:
            if hasattr(self, name):
                existing = getattr(self, name)
                if isinstance(existing, (Parameter, Block)) and \
                        not isinstance(value, type(existing)) and \
                        not isinstance(existing, type(value)):
                    raise TypeError(
                        f"Changing attribute type for {self.name} from "
                        f"{type(existing)} to {type(value)} is not allowed.")
            if isinstance(value, Block):
                self.register_child(value, name)
            elif isinstance(value, Parameter):
                if name in self._reg_params and \
                        self._reg_params[name] is not value:
                    raise AssertionError(f"Overriding Parameter attribute "
                                         f"{name} is not allowed.")
                self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Every Parameter of this block and its children, by full name;
        ``select`` is a regex the names must match (reference
        Block.collect_params)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pattern.match(n)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_params(self, filename):
        """Save the parameters keyed by attribute path (reference
        Block.save_params / save_parameters)."""
        params = self._collect_params_with_prefix()
        nd_utils.save(filename, {k: v.data() for k, v in params.items()
                                 if v._data is not None})

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load parameters saved by attribute path, or by full name (a
        file of ``ParameterDict.save`` or ``export``) as the JAX package
        accepts both."""
        with cpu():
            loaded = nd_utils.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and not any("." in k for k in loaded):
            full = self.collect_params()
            by_name = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
            for name in full:
                if name in by_name:
                    full[name]._load_init(by_name[name], ctx)
                elif not allow_missing:
                    raise IOError(f"Parameter {name} missing in {filename}")
            return
        for name in params:
            if name not in loaded:
                if not allow_missing:
                    raise IOError(f"Parameter {name} missing in {filename}")
                continue
            params[name]._load_init(loaded[name], ctx)
        if not ignore_extra:
            for name in loaded:
                if name not in params:
                    raise IOError(
                        f"Parameter {name} in file {filename} is not present"
                        " in this Block")

    load_parameters = load_params

    def register_child(self, block, name=None):
        """Register ``block`` as a child (and a torch submodule)."""
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        self._modules[name] = block

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward."""
        handle = _HookHandle(self._gluon_pre_hooks)
        self._gluon_pre_hooks[handle._id] = hook
        return handle

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each forward."""
        handle = _HookHandle(self._gluon_hooks)
        self._gluon_hooks[handle._id] = hook
        return handle

    def apply(self, fn):
        """``fn`` on every child, recursively, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init="uniform", ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Nothing on a plain Block; recurses into the children."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def _apply(self, fn, recurse=True):
        """``torch.nn.Module._apply`` (behind ``.to()``, ``.cuda()``,
        ``.float()`` ...), which also moves this block's Parameters."""
        super()._apply(fn, recurse)
        for param in self._reg_params.values():
            param._apply_tensor(fn)
        return self

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        """``(attribute path, tensor)`` of every initialised Parameter,
        for torch code (``.parameters()``)."""
        params = self._collect_params_with_prefix(prefix) if recurse else \
            {(prefix + "." if prefix else "") + k: v
             for k, v in self._reg_params.items()}
        seen = set()
        for name, p in params.items():
            if p._data is None or (remove_duplicate and id(p) in seen):
                continue
            seen.add(id(p))
            yield name, p._data._data

    def summary(self, *inputs):
        """Print each child's output shape and parameter count (reference
        Block.summary)."""
        summary = OrderedDict()
        hooks = []

        def shapes(args):
            flat = [tuple(x.shape) if x is not None else None
                    for x in _flatten(args)]
            return flat[0] if len(flat) == 1 else flat

        def register(block, name):
            def hook(blk, inp, out):
                summary[name] = (shapes(out), sum(
                    int(np.prod(p.shape)) for p in blk._reg_params.values()
                    if p._shape_known()))
            hooks.append(block.register_forward_hook(hook))

        for name, child in self._children.items():
            register(child, name)
        register(self, self.__class__.__name__)
        try:
            self(*inputs)
            print(f"{'Layer':<30}{'Output Shape':<25}{'Params':<10}")
            print("-" * 65)
            total = 0
            for name, (shape, count) in summary.items():
                print(f"{name:<30}{str(shape):<25}{count:<10}")
                total += count
            print("-" * 65)
            print(f"Total params: {total}")
        finally:
            for h in hooks:
                h.detach()

    def forward(self, *args):
        raise NotImplementedError

    def __call__(self, *args):
        for hook in list(self._gluon_pre_hooks.values()):
            hook(self, args)
        out = self.forward(*args)
        for hook in list(self._gluon_hooks.values()):
            hook(self, args, out)
        return out


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(self, F, x, *args, **params)``
    over the ``nd`` ops (reference gluon/block.py:HybridBlock): ``F`` is
    the port's ``ndarray`` module and ``params`` the block's own
    Parameters' arrays by attribute name."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        """Recorded (``_active``); the forward stays eager (module
        note)."""
        self._active = active
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Set the deferred shapes of this layer's Parameters from its
        inputs; a layer with such Parameters overrides it."""
        raise NotImplementedError(
            f"{self.__class__.__name__} has deferred-init parameters but"
            " does not implement infer_shape")

    def _deferred_init_params(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            p._finish_deferred_init()

    def forward(self, x, *args):
        try:
            params = {k: p.local_data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_init_params(x, *args)
            params = {k: p.local_data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Save the parameters for deployment as ``path-%04d.params``
        (the JAX package's export: the checkpoint format, no symbol
        JSON, since the graph is this Python module).  The op-declared
        auxiliary states (BatchNorm's moving statistics) take the
        ``aux:`` prefix, every other parameter ``arg:``, frozen or not."""
        arg_dict = {}
        for name, param in self.collect_params().items():
            prefix = "aux:" if param._is_aux else "arg:"
            arg_dict[prefix + name] = param.data()
        nd_utils.save(f"{path}-{epoch:04d}.params", arg_dict)


class SymbolBlock(HybridBlock):
    """A Block over a Symbol (reference gluon/block.py:598): the
    symbol's arguments other than ``inputs`` become Parameters under
    their own names (an empty prefix, as the reference keys them;
    deferred, ``grad_req="write"``), its auxiliary states Parameters
    with ``grad_req="null"``.  A call infers the deferred shapes from
    the inputs' (``Symbol.infer_shape``), then runs the graph in eval
    mode on the Parameters' arrays (the auxiliary states bound as such)
    and the inputs; it is not
    recorded by ``autograd``, as the JAX block's jitted ``eval`` is not.
    The JAX SymbolBlock names its Parameters with the block's prefix,
    which the graph does not know, and never infers their shapes, so
    its first call raises; the port's follows the reference there."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        from ..symbol.symbol import Symbol
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if not isinstance(outputs, Symbol):
            raise TypeError("outputs must be a Symbol")
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._output_sym = outputs
        self._input_names = [i.name for i in inputs]
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True,
                                grad_req="write")
        for name in outputs.list_auxiliary_states():
            self.params.get(name, allow_deferred_init=True, grad_req="null")

    def forward(self, *args):
        deferred = [p for p in self.params.values() if p._deferred_init]
        if deferred:
            sym = self._output_sym
            arg_shapes, _, aux_shapes = sym.infer_shape(**{
                n: a.shape for n, a in zip(self._input_names, args)})
            shapes = dict(zip(sym.list_arguments(), arg_shapes))
            shapes.update(zip(sym.list_auxiliary_states(), aux_shapes))
            for p in deferred:
                p.shape = shapes[p.name]
                p._finish_deferred_init()
        sym = self._output_sym
        values = {p.name: p.data() for p in self.params.values()}
        values.update(zip(self._input_names, args))
        aux = {n: values.pop(n) for n in sym.list_auxiliary_states()}
        out = sym.bind(args[0].context, values, aux_states=aux,
                       grad_req="null").forward(is_train=False)
        return out[0] if len(out) == 1 else out

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
