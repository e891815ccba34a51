"""Parameter / ParameterDict of the port's Gluon (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``; reference
python/mxnet/gluon/parameter.py).

A ``Parameter`` holds one ``NDArray`` on one device, allocated at
``initialize`` (or at the first forward when its shape has zeros, the
deferred-init protocol) and marked as an autograd variable through
``autograd.mark_variables``, so ``grad_req`` ``write`` / ``add`` /
``null`` keep the semantics of ``attach_grad``.  ``backward`` sets the
array's fresh-gradient bit (``_fresh_grad``), which ``Trainer.step``
reads and clears.

A Parameter may instead *view* a tensor that a ``torch.nn.Module`` owns
(``Parameter.view``): its NDArray wraps that very tensor, with the same
storage and no copy, and the variable mark lands on it, so gradients of
a forward through the module reach the Parameter's grad buffer and an
update writes the module's tensor in place.  Initialising, loading or
``set_data`` then copies into the tensor; moving or casting a view is
the owner module's business and raises here.

``stype`` / ``grad_stype`` take ``default``, ``row_sparse`` or
``csr``, as in the JAX package: the data and the gradient buffer stay
dense, and ``Trainer.step`` hands a ``row_sparse`` gradient to the
optimizer as a ``RowSparseNDArray`` of its nonzero rows (the lazy
update).

``sharding`` is the JAX package's: a tuple of mesh axis names or None,
one per dim, which the model-parallel layers (``parallel.layers``,
``MoELayer``, ``PipelineStack``) declare.  A step on a mesh with such
an axis larger than 1 (``parallel.TrainStep`` / ``EvalStep(mesh=)``)
``cut``s the parameter: it was initialised as the global array (the
seed's and name's bits at the global shape), and from then on holds
only this rank's block (``local_data()``, what the layer computes
with, what ``Block.parameters()`` yields and the optimizer updates).
``data()``, ``save_parameters`` and ``export`` give the global array,
gathered over the axis (a collective: every rank of the axis calls
it), and ``set_data`` of a global array keeps this rank's block.
``shape`` stays the global shape.

A list of contexts (``initialize``, ``reset_ctx``, ``load``) places the
value on the first one, as the JAX package does; ``list_ctx`` gives
that one context.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import autograd, initializer
from .. import random as _random
from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import context_of, cpu, current_context
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray, zeros

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (NDArray,)


class DeferredInitializationError(MXNetError):
    """Raised when accessing a parameter whose shape is not yet known
    (reference gluon/parameter.py:DeferredInitializationError)."""


def _run_init(init, default_init, name, data):
    """Apply the parameter's own initializer to the numpy ``data``,
    bypassing the name-suffix dispatch; else the default one's
    dispatch (reference Initializer.__call__ honouring ``__init__``)."""
    desc = initializer.InitDesc(name)
    if init is not None:
        if isinstance(init, str):
            init = initializer.create(init)
        if isinstance(init, initializer.Initializer):
            init._init_weight(desc, data)
        else:
            init(desc, data)
    else:
        if isinstance(default_init, str):
            default_init = initializer.create(default_init)
        default_init(desc, data)


def _is_bf16(dtype):
    return dtype == torch.bfloat16 or str(dtype) == "bfloat16"


def _host_dtype(dtype):
    """The numpy dtype the initializers fill for ``dtype`` (bf16, which
    numpy lacks, is filled in fp32 and rounded on the device)."""
    return np.float32 if _is_bf16(dtype) else np.dtype(dtype)


def _to_device(values, ctx, dtype):
    """An NDArray of the numpy ``values`` in ``dtype`` on ``ctx``."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    t = t.to(torch.bfloat16 if _is_bf16(dtype) else torch_dtype(dtype))
    return NDArray(t.to(ctx.torch_device()), ctx)


def _one_ctx(ctx):
    """The Context a Parameter lives on, from ``ctx``: None is the
    current one, and a list its first entry (JAX ``Parameter.initialize``
    takes ``ctx[0]``)."""
    if ctx is None:
        return current_context()
    if isinstance(ctx, (list, tuple)):
        return ctx[0] if ctx else current_context()
    return ctx


class Parameter:
    """A trainable array with lazy allocation and a gradient buffer
    (reference gluon/parameter.py:Parameter).  ``shape`` may hold 0s for
    the sizes the first forward infers; ``_is_aux`` marks the
    operator-declared auxiliary states (BatchNorm's moving statistics)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._data = None
        self._grad = None
        self._view = False
        self._deferred_init = ()
        self.name = name
        self._differentiable = differentiable
        if not differentiable:
            grad_req = "null"
        self._grad_req = None
        self.grad_req = grad_req
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        for kind, value in (("stype", stype), ("grad_stype", grad_stype)):
            if value not in ("default", "row_sparse", "csr"):
                raise ValueError(f"invalid {kind} {value}")
        self._stype = stype
        self._grad_stype = grad_stype
        self._is_aux = False
        self._var = None
        #: a tuple of mesh axis names or None per dim (JAX
        #: ``Parameter.sharding``); the model-parallel layers set it
        self.sharding = None
        #: the ``parallel.Sharding`` this parameter is cut by (its data
        #: then holds this rank's block), or None
        self._cut = None

    @classmethod
    def view(cls, name, tensor, grad_req="write", **kwargs):
        """A Parameter over ``tensor`` itself (a ``torch.nn.Parameter``
        or buffer of a module): same storage, no copy.  With a
        ``grad_req`` other than ``null`` the tensor becomes the autograd
        variable, so it must be a leaf."""
        dtype = "bfloat16" if tensor.dtype == torch.bfloat16 else \
            numpy_dtype(tensor.dtype).name
        p = cls(name, grad_req=grad_req, shape=tuple(tensor.shape),
                dtype=dtype, **kwargs)
        p._view = True
        p._data = NDArray(tensor, context_of(tensor.device))
        if p.grad_req != "null":
            p._init_grad()
        return p

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # ------------------------------------------------------------ grad_req
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._grad, self._data._grad_req = None, "null"
        elif self._data is not None:
            self._init_grad()

    # ------------------------------------------------------------ helpers
    def _shape_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def _check_and_get(self, arr):
        if arr is not None:
            return arr
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because"
                " initialization was deferred. Actual initialization happens"
                " during the first forward pass. Please pass one batch of"
                " data through the network before accessing Parameters.")
        raise RuntimeError(
            f"Parameter {self.name} has not been initialized. You should"
            " initialize parameters with Block.initialize() before use.")

    def _assign(self, value):
        """Give the parameter the values of the NDArray ``value``: in
        place for a view, else by ``NDArray._write``."""
        t = value._data.detach()
        if self._cut is not None and tuple(t.shape) == tuple(self.shape) \
                and tuple(t.shape) != tuple(self._data.shape):
            t = self._cut.cut(t)
        if self._view:
            with torch.no_grad():
                self._data._data.copy_(t)
        else:
            self._data._write(t.to(self._data._data.device,
                                   self._data._data.dtype))

    def _load_init(self, data, ctx=None):
        """Set the value from a loaded array, checking its shape
        (reference gluon/parameter.py:_load_init)."""
        if self._shape_known() and tuple(self.shape) != tuple(data.shape):
            raise MXNetError(
                f"Failed loading Parameter {self.name} from saved params:"
                f" shape mismatch {tuple(data.shape)} vs {self.shape}")
        if not isinstance(data, NDArray):
            data = NDArray(torch.from_numpy(np.array(data)), cpu())
        self.shape = tuple(data.shape)
        if self._data is not None:
            self._assign(data)
        else:
            if ctx is None:
                ctx = self._deferred_init[1] if self._deferred_init \
                    else current_context()
            self._init_impl(data.as_in_context(_one_ctx(ctx)).copy())
        # a loaded value supersedes any pending deferred init
        self._deferred_init = ()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        if not self._shape_known():
            raise MXNetError(
                f"Cannot initialize Parameter {self.name} because it has"
                f" invalid shape: {self.shape}.")
        self._allocate(init, ctx, default_init)

    def _allocate(self, init, ctx, default_init):
        values = np.zeros(self.shape, dtype=_host_dtype(self.dtype))
        with _random.sampling_on((ctx or current_context()).torch_device()):
            self._fill(init, default_init, values)
        data = _to_device(values, ctx, self.dtype)
        if self._data is not None:
            self._assign(data)
        else:
            self._init_impl(data)

    def _fill(self, init, default_init, values):
        """Fill the numpy ``values`` by the initializer."""
        _run_init(init, default_init, self.name, values)

    def _init_impl(self, data):
        self._data = data
        if self.grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer, and the data marked as the autograd
        variable with this ``grad_req``."""
        self._grad = zeros(self._data.shape, ctx=self._data.context,
                           dtype=self._data._data.dtype)
        autograd.mark_variables([self._data], [self._grad], self.grad_req)

    # ------------------------------------------------------------ public
    def initialize(self, init=None, ctx=None, default_init="uniform",
                   force_reinit=False):
        """Allocate and fill (reference gluon/parameter.py:initialize);
        with a shape still unknown, defer to the first forward."""
        if self._data is not None and not force_reinit:
            return
        # a view lives where its module's tensor is
        ctx = self._data.context if self._view else _one_ctx(ctx)
        init = self.init if init is None else init
        if isinstance(init, str):
            init = initializer.create(init)
        if isinstance(default_init, str):
            default_init = initializer.create(default_init)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has"
                f" invalid shape: {self.shape}. Set allow_deferred_init=True"
                " or specify in_units/in_channels.")
        self._allocate(init, ctx, default_init)

    def reset_ctx(self, ctx):
        ctx = _one_ctx(ctx)
        if self._data is None:
            if self._deferred_init:
                init, _, default_init = self._deferred_init
                self._deferred_init = (init, ctx, default_init)
            return
        if ctx == self._data.context:
            return
        if self._view:
            raise MXNetError(f"Parameter {self.name} views a module's "
                             "tensor: move the module instead")
        self._data = self._data.as_in_context(ctx).copy()
        if self._grad is not None:
            self._init_grad()

    def _apply_tensor(self, fn):
        """Replace the data by ``fn`` of its tensor (``Block._apply``:
        ``.to()``, ``.cuda()`` and the like), keeping ``grad_req``."""
        if self._data is None or self._view:
            return
        t = fn(self._data._data.detach())
        self._data = NDArray(t.detach().clone(), context_of(t.device))
        if self._grad is not None:
            self._init_grad()

    def set_data(self, data):
        """Replace the value (reference set_data)."""
        if not isinstance(data, NDArray):
            data = NDArray(torch.from_numpy(np.array(data)), cpu())
        if self._data is None:
            if self._deferred_init:
                self._load_init(data)
                return
            raise RuntimeError(f"Parameter {self.name} has not been "
                               "initialized")
        self._assign(data)

    def data(self, ctx=None):
        """The value as an NDArray: the global array, gathered over the
        mesh axes when the parameter is cut."""
        local = self._check_and_get(self._data)
        if self._cut is None:
            return local
        return NDArray(self._cut.gather(local._data.detach(), self.shape),
                       local.context)

    def local_data(self):
        """The NDArray this rank holds: its block when the parameter is
        cut, else the whole value."""
        return self._check_and_get(self._data)

    def cut(self, mesh):
        """Keep only this rank's block of the value, by ``sharding`` on
        ``mesh`` (nothing when no axis of the spec is larger than 1
        there, or when it is cut so already)."""
        if self.sharding is None or self._data is None:
            return
        layout = mesh.sharding(*self.sharding)
        if self._cut is not None:
            if self._cut != layout:
                raise MXNetError(f"Parameter {self.name} is already cut "
                                 f"by {self._cut}, not {layout}")
            return
        if not layout.is_split:
            return
        if self._view:
            raise MXNetError(f"Parameter {self.name} views a module's "
                             "tensor and cannot be cut")
        local = layout.cut(self._data._data.detach()).contiguous().clone()
        self._data = NDArray(local, self._data.context)
        self._cut = layout
        if self.grad_req != "null":
            self._init_grad()

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter {self.name} because"
                " grad_req='null'")
        return self._check_and_get(self._grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise RuntimeError(f"Parameter {self.name} has not been "
                               "initialized")
        return [self._data.context]

    def zero_grad(self):
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def var(self):
        """Symbol representation for the symbolic frontend (reference
        parameter.py:var): a variable named after the parameter, with
        its shape and multipliers as attributes; made once."""
        if self._var is None:
            from ..symbol import symbol as _sym
            self._var = _sym.var(self.name, shape=self.shape,
                                 dtype=self.dtype, lr_mult=self.lr_mult,
                                 wd_mult=self.wd_mult, init=self.init)
        return self._var

    @property
    def _fresh_grad(self):
        """True when backward has written the gradient since the last
        ``Trainer.step`` (reference parameter.py:_fresh_grad)."""
        return bool(self._data is not None and self._data._fresh_grad)

    @_fresh_grad.setter
    def _fresh_grad(self, value):
        if self._data is not None:
            self._data._fresh_grad = bool(value)

    def cast(self, dtype):
        if self._view:
            raise MXNetError(f"Parameter {self.name} views a module's "
                             "tensor: cast the module instead")
        self.dtype = dtype
        if self._data is None:
            return
        t = self._data._data.detach()
        t = t.to(torch.bfloat16 if _is_bf16(dtype) else torch_dtype(dtype))
        self._data = NDArray(t, self._data.context)
        if self._grad is not None:
            self._init_grad()


class Constant(Parameter):
    """A non-differentiable constant (reference
    gluon/parameter.py:Constant)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = np.asarray(value)
        self.value = value

        class _CInit(initializer.Initializer):
            def _init_weight(self, _, arr):
                arr[:] = value

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype.name, init=_CInit(),
                         differentiable=False)


class ParameterDict:
    """Prefix-scoped dict of Parameters, with a shared root for weight
    sharing (reference gluon/parameter.py:ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        items = "".join(f"\n  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' ({items}\n)" if items \
            else f"ParameterDict '{self._prefix}' (empty)"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create ``prefix + name`` (reference
        ParameterDict.get); a shape with 0s merges with a known one."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if hasattr(param, k) and getattr(param, k) is not None:
                existing = getattr(param, k)
                if k == "shape" and v is not None and \
                        len(v) == len(existing):
                    if all(a in (0, b) or b in (0, a)
                           for a, b in zip(v, existing)):
                        param.shape = tuple(max(a, b)
                                            for a, b in zip(v, existing))
                        continue
                if v is not None and v != existing:
                    raise AssertionError(
                        f"Cannot retrieve Parameter {name} because desired"
                        f" attribute does not match with stored for attribute"
                        f" {k}: desired {v} vs stored {existing}")
            elif v is not None:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named {name}")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"Cannot update self with other because they"
                                 f" have different Parameters with the same"
                                 f" name {k}")
            self._params[k] = v

    def initialize(self, init="uniform", ctx=None, verbose=False,
                   force_reinit=False):
        for v in self.values():
            v.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save to a ``.params`` file under the full names (reference
        ParameterDict.save)."""
        arg_dict = {}
        for param in self.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_utils.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        with cpu():
            loaded = nd_utils.load(filename)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError(
                        f"Parameter {name} is missing in file {filename}")
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(
                        f"Parameter {name} loaded from file {filename} is not"
                        " present in this ParameterDict")
                continue
            self[name]._load_init(v, ctx)

