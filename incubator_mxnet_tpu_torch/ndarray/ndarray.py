"""NDArray — the imperative tensor of the port (counterpart of
``incubator_mxnet_tpu/ndarray/ndarray.py``; reference
include/mxnet/ndarray.h:82, python/mxnet/ndarray/ndarray.py).

An NDArray wraps a ``torch.Tensor`` on its context's device.  Ops go
through ``invoke`` (the reference's MXImperativeInvoke): look up the
registered op, run it on the tensors — with autograd only under
``autograd.record()`` — and wrap the results.  Torch runs
asynchronously on the card's stream, as JAX dispatch does, so
``wait_to_read`` is a synchronise.

**Aliasing.**  A JAX array is immutable and every write rebinds it, so
in the JAX package no NDArray ever sees a later write to another: a
slice ``x[1:3]``, ``x.detach()``, ``NDArray(x)``, ``x.copy()`` and an
op's result (a reshape, a transpose, ``identity``) are all values of
their own.  A torch slice, reshape or ``detach()`` shares storage, so
the port copies wherever the JAX result would not alias: ``invoke``
copies any output that shares storage with an input, and the methods
above copy.  Writes go in place only where the JAX package rebinds the
same NDArray: ``__setitem__``, ``+=`` and the other in-place operators,
an op's ``out=``, and the arrays a ``rtc`` kernel is launched on.  The
first three rebind instead while a live recorded graph has saved the
array's tensor (``autograd.rebind``), so ``backward`` differentiates at
the recorded values, as the JAX tape does.
"""
from __future__ import annotations

import functools
import re

import numpy as np
import torch

from .. import autograd, telemetry
from ..base import MXNetError, mx_real_t, numpy_dtype, torch_dtype
from ..context import Context, context_of, cpu, current_context, gpu, tpu
from ..ops import get_op, normalize_attrs
from ..ops.matrix import read_key, write_key

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "invoke", "imperative_invoke",
           "waitall"]


def _shares(a, b):
    """True when tensors ``a`` and ``b`` share storage."""
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr() \
        and a.numel() > 0 and b.numel() > 0


def _own(t, sources):
    """``t`` as an NDArray's own dense row-major tensor: copied when it
    shares storage with any of ``sources`` or is not contiguous."""
    if not t.is_contiguous() or any(s is not None and _shares(t, s)
                                    for s in sources):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _key(key):
    """An index key with NDArrays replaced by their tensors (integer
    arrays as int64 indices)."""
    def one(k):
        if isinstance(k, NDArray):
            t = k._data
            return t if t.dtype == torch.bool else t.long()
        return k
    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


_live = []      # the ndarray.live.{bytes,count} gauges, once registered


def _live_gauges():
    """The live-array gauges: bytes (and arrays) that NDArray wrappers
    hold, by their size at creation (a rebinding write keeps it), so a
    trend shows a leak."""
    if not _live:
        _live[:] = [telemetry.gauge("ndarray.live.bytes"),
                    telemetry.gauge("ndarray.live.count")]
    return _live


class NDArray:
    """An n-dimensional array on a device, with MXNet semantics."""

    # _pipeline_stamp: set (only) by pipeline_io.DevicePrefetchIter on
    # the NDArrays it stages; _tel_nbytes: the bytes the live gauge
    # counted for this array (None: not counted)
    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_fresh_grad",
                 "_pipeline_stamp", "_tel_nbytes", "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            ctx = ctx if ctx is not None else data._ctx
            data = data._data.detach().clone()
        elif not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, not "
                             f"{type(data).__name__}; use nd.array()")
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data.device)
        self._grad = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._tel_nbytes = None
        if telemetry.enabled:
            nbytes, count = _live or _live_gauges()
            nb = self._tel_nbytes = data.nbytes
            nbytes.add_async(nb)
            count.add_async(1)

    def __del__(self):
        nb = getattr(self, "_tel_nbytes", None)
        if nb is not None:
            # the lock-free form (a garbage-collection pass can run this
            # inside Gauge.add() while its lock is held), as at creation
            nbytes, count = _live
            nbytes.add_async(-nb)
            count.add_async(-1)

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def grad(self):
        return self._grad

    @property
    def stype(self):
        """Storage type: ``"default"`` (dense)."""
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype``: itself for ``"default"``,
        else a ``sparse.RowSparseNDArray`` or ``sparse.CSRNDArray`` of
        its nonzeros."""
        if stype == "default":
            return self
        from . import sparse
        return sparse._from_dense(self, stype)

    @property
    def T(self):
        return invoke("transpose", [self], {})

    # ------------------------------------------------------------ conversion
    def asnumpy(self):
        """A host copy (ndarray.py:asnumpy — the sync point)."""
        return self._data.detach().to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def astype(self, dtype, copy=True):
        return invoke("Cast", [self], {"dtype": np.dtype(dtype).name})

    def copy(self):
        return NDArray(self)

    def copyto(self, other):
        """Copy into another NDArray (in place) or to a context
        (ndarray.py:copyto)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        other._write(self._data.detach().to(other._data.device,
                                            other._data.dtype))
        return other

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return NDArray(self._data.detach().to(ctx.torch_device(),
                                              copy=True), ctx)

    def as_in_ctx(self, ctx):
        return self.as_in_context(ctx)

    # ------------------------------------------------------------ engine sync
    def wait_to_read(self):
        """Engine::WaitForVar equivalent (ndarray.h:305)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # ------------------------------------------------------------ autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer (ndarray.py:attach_grad)."""
        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        autograd.mark_variables([self], [grad], grad_req)

    def detach(self):
        return NDArray(self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # ------------------------------------------------------------ mutation
    @torch.no_grad()
    def _write(self, value):
        """Write ``value`` (a tensor) into this array in place; an array
        of another shape or dtype is rebound, as the JAX package does,
        and so is one whose tensor a live recorded graph has saved."""
        if value.shape != self._data.shape or \
                value.dtype != self._data.dtype:
            self._data = value.detach().clone()
        elif autograd.is_saved(self._data):
            autograd.rebind(self, value)
        else:
            self._data.copy_(value)

    @torch.no_grad()
    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data.to(self._data.device)
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(np.asarray(value)).to(self._data.device)
        target = self._data
        if autograd.is_saved(target):
            target = target.detach().clone()
        target[write_key(target, _key(key))] = value
        if target is not self._data:
            autograd.rebind(self, target)

    def __getitem__(self, key):
        t, k = read_key(self._data, _key(key))
        with torch.set_grad_enabled(autograd.is_recording()):
            out = _own(t[k], [self._data])
        return NDArray(out, self._ctx)

    # ------------------------------------------------------------ arithmetic
    _SCALAR_OPS = {
        "broadcast_add": ("_plus_scalar", "_plus_scalar"),
        "broadcast_sub": ("_minus_scalar", "_rminus_scalar"),
        "broadcast_mul": ("_mul_scalar", "_mul_scalar"),
        "broadcast_div": ("_div_scalar", "_rdiv_scalar"),
        "broadcast_mod": ("_mod_scalar", "_rmod_scalar"),
        "broadcast_power": ("_power_scalar", "_rpower_scalar"),
        "broadcast_maximum": ("_maximum_scalar", "_maximum_scalar"),
        "broadcast_minimum": ("_minimum_scalar", "_minimum_scalar"),
        "broadcast_equal": ("_equal_scalar", "_equal_scalar"),
        "broadcast_not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
        "broadcast_greater": ("_greater_scalar", "_lesser_scalar"),
        "broadcast_greater_equal": ("_greater_equal_scalar",
                                    "_lesser_equal_scalar"),
        "broadcast_lesser": ("_lesser_scalar", "_greater_scalar"),
        "broadcast_lesser_equal": ("_lesser_equal_scalar",
                                   "_greater_equal_scalar"),
    }

    def _binop(self, opname, other, rev=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if rev else (self, other)
            return invoke(opname, [a, b], {})
        return invoke(self._SCALAR_OPS[opname][int(rev)], [self],
                      {"scalar": float(other)})

    def __add__(self, o): return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o)
    def __sub__(self, o): return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, rev=True)
    def __mul__(self, o): return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o)
    def __truediv__(self, o): return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __mod__(self, o): return self._binop("broadcast_mod", o)
    def __rmod__(self, o): return self._binop("broadcast_mod", o, rev=True)
    def __pow__(self, o): return self._binop("broadcast_power", o)
    def __rpow__(self, o): return self._binop("broadcast_power", o, True)
    def __neg__(self): return invoke("negative", [self], {})
    def __abs__(self): return invoke("abs", [self], {})
    def __eq__(self, o): return self._binop("broadcast_equal", o)
    def __ne__(self, o): return self._binop("broadcast_not_equal", o)
    def __gt__(self, o): return self._binop("broadcast_greater", o)
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o)
    def __lt__(self, o): return self._binop("broadcast_lesser", o)
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o)
    __hash__ = object.__hash__

    def _inplace(self, opname, o):
        self._write(self._binop(opname, o)._data)
        return self

    def __iadd__(self, o): return self._inplace("broadcast_add", o)
    def __isub__(self, o): return self._inplace("broadcast_sub", o)
    def __imul__(self, o): return self._inplace("broadcast_mul", o)
    def __itruediv__(self, o): return self._inplace("broadcast_div", o)

    # ------------------------------------------------------------ methods
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("Reshape", [self],
                      {"shape": shape, "reverse": kwargs.get("reverse",
                                                             False)})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def flatten(self):
        return invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def transpose(self, axes=None):
        return invoke("transpose", [self], {"axes": axes})

    def swapaxes(self, dim1, dim2):
        return invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("SliceChannel", [self],
                      {"num_outputs": num_outputs, "axis": axis,
                       "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        return invoke("slice", [self], {"begin": begin, "end": end,
                                        "step": step})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", [self, index], {"axis": axis,
                                              "keepdims": keepdims})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], dict(depth=depth, **kw))

    def sum(self, axis=None, keepdims=False, **kw):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", [self], {"axis": axis, "k": k,
                                       "ret_typ": ret_typ,
                                       "is_ascend": is_ascend})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self): return invoke("abs", [self], {})
    def sqrt(self): return invoke("sqrt", [self], {})
    def square(self): return invoke("square", [self], {})
    def exp(self): return invoke("exp", [self], {})
    def log(self): return invoke("log", [self], {})
    def sign(self): return invoke("sign", [self], {})
    def round(self): return invoke("round", [self], {})
    def floor(self): return invoke("floor", [self], {})
    def ceil(self): return invoke("ceil", [self], {})
    def sigmoid(self): return invoke("sigmoid", [self], {})
    def tanh(self): return invoke("tanh", [self], {})
    def relu(self): return invoke("relu", [self], {})

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def flip(self, axis):
        return invoke("reverse", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    # pickling (optimizer and trainer states rely on it): the values on
    # the host and the context's name, as the JAX package pickles them;
    # bf16, which numpy lacks, travels as fp32 with its dtype's name
    def __getstate__(self):
        data = self._data.detach()
        state = {"ctx": str(self._ctx)}
        if data.dtype == torch.bfloat16:
            data, state["dtype"] = data.float(), "bfloat16"
        state["data"] = data.to("cpu", copy=True).numpy()
        return state

    def __setstate__(self, state):
        m = re.fullmatch(r"(cpu|gpu|tpu)\((\d+)\)", state["ctx"])
        if m is None:
            raise MXNetError(f"cannot read the context {state['ctx']!r}")
        ctx = {"cpu": cpu, "gpu": gpu, "tpu": tpu}[m.group(1)](
            int(m.group(2)))
        t = torch.from_numpy(np.array(state["data"]))
        if state.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
        self.__init__(t.to(ctx.torch_device()), ctx)


# ------------------------------------------------------------------ invoke
def _as_input(value, device):
    """A non-NDArray op input (a number, list, numpy array or tensor)
    as a tensor on ``device``: a tensor keeps its dtype (a Gluon block
    called on a tensor, as ``BlockPredictor`` calls it); otherwise
    float64 becomes float32 and untyped integers int32, as JAX's
    ``asarray`` gives them."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64 and not isinstance(value, np.ndarray):
        arr = arr.astype(np.int32)
    return torch.as_tensor(arr).to(device, copy=True)


# ops whose outputs carry BatchNorm statistics, and their count of
# (mean, var) pairs
_BN_PAIRS = {"BatchNorm": 1, "_FusedBatchNormRelu": 1,
             "_FusedBNReluConv": 1, "_FusedBottleneckChain": 2}


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    """The Python float ``value`` rounded to ``dtype``."""
    return torch.tensor(value, dtype=dtype).item()


@torch.no_grad()
def _fold_moving_stats(inputs, result, n_pairs, momentum):
    """Move each pair of moving statistics (inputs ``3 + 5 * pair`` and
    ``4 + 5 * pair``) towards the batch's (outputs ``1 + 2 * pair`` and
    ``2 + 2 * pair``), in place."""
    for pair in range(n_pairs):
        for moving, batch in ((inputs[3 + 5 * pair], result[1 + 2 * pair]),
                              (inputs[4 + 5 * pair], result[2 + 2 * pair])):
            t = moving._data
            m, rest = (_rounded(v, t.dtype) for v in (momentum, 1 - momentum))
            moving._write(m * t + rest * batch._data.to(t.dtype))


def invoke(op_name, inputs, attrs, out=None, ctx=None):
    """The imperative dispatch path (== MXImperativeInvoke).  ``ctx``
    places an op without NDArray inputs (default: the current
    context); otherwise the first NDArray input's context is the
    result's."""
    op = get_op(op_name) if isinstance(op_name, str) else op_name
    if telemetry.enabled:      # one branch when MXNET_TELEMETRY=0
        telemetry.counter("op.dispatch.count").inc()
    attrs = normalize_attrs(attrs)
    if "is_train" in op.attr_names and "is_train" not in attrs:
        attrs["is_train"] = autograd.is_training()
    for i in inputs:
        if isinstance(i, NDArray):
            ctx = i._ctx
            break
    else:
        ctx = ctx if ctx is not None else current_context()
    device = None
    tensors = []
    for i in inputs:
        if isinstance(i, NDArray):
            tensors.append(i._data)
        elif i is None:
            tensors.append(None)
        else:
            device = device or ctx.torch_device()
            tensors.append(_as_input(i, device))
    if "device" in op.attr_names and "device" not in attrs:
        attrs["device"] = device or ctx.torch_device()
    prefix = ()
    if op.needs_rng:
        from .. import random as _random
        prefix = (_random.generator(device or ctx.torch_device()),)
    with torch.set_grad_enabled(autograd.is_recording()
                                and op.differentiable):
        with autograd.saving():
            raw = op.fn(*prefix, *tensors, **attrs)
        if isinstance(raw, (tuple, list)):
            result = [NDArray(_own(r, tensors), ctx) for r in raw]
        else:
            result = NDArray(_own(raw, tensors), ctx)
    n_pairs = _BN_PAIRS.get(op.name, 0)
    if n_pairs and isinstance(result, list) and \
            len(result) == 1 + 2 * n_pairs:
        if attrs.get("is_train", True) and \
                not attrs.get("use_global_stats", False) and \
                len(inputs) >= 5 * n_pairs:
            _fold_moving_stats(inputs, result, n_pairs,
                               attrs.get("momentum", 0.9))
        if not attrs.get("output_mean_var", False):
            result = result[0]
    if out is not None:
        outs = result if isinstance(result, list) else [result]
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, r in zip(targets, outs):
            t._write(r._data)
        return out
    return result


imperative_invoke = invoke


# ------------------------------------------------------------------ creation
def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array``
    (ndarray.py:array).  A numpy (or other typed) source keeps its
    dtype, except float64, which becomes float32; an untyped source
    (a list, a number) becomes float32 — the JAX package's rule."""
    ctx = ctx or current_context()
    device = ctx.torch_device()
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
    else:
        from_typed = isinstance(source_array, np.ndarray) or \
            hasattr(source_array, "dtype")
        data = np.asarray(source_array)
        if dtype is None and (not from_typed or data.dtype == np.float64):
            dtype = mx_real_t
        t = torch.as_tensor(data if data.flags.c_contiguous
                            else data.copy(order="C"))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to(device, copy=True), ctx)


def _new(fill, shape, ctx, dtype):
    ctx = ctx or current_context()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(fill(shape, dtype=torch_dtype(dtype or mx_real_t),
                        device=ctx.torch_device()), ctx)


def empty(shape, ctx=None, dtype=mx_real_t):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _new(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _new(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None, out=None):
    arr = _new(lambda s, **kw: torch.full(s, val, **kw), shape, ctx, dtype)
    if out is not None:
        out._write(arr._data)
        return out
    return arr


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=mx_real_t):
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": np.dtype(dtype).name}, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return invoke("Concat", list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    axes = list(range(tensor.ndim))
    axes.remove(source % tensor.ndim)
    axes.insert(destination % tensor.ndim, source % tensor.ndim)
    return tensor.transpose(axes)


def waitall():
    """Engine::WaitForAll equivalent: wait for every device's work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
