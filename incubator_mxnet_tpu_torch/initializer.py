"""Weight initializers (counterpart of ``incubator_mxnet_tpu/
initializer.py``; reference python/mxnet/initializer.py).

The same registry and descriptor API: an ``Initializer`` dispatches on
the parameter name's suffix (``InitDesc``) to fill a host numpy array.
Random fills come from ``random.named_sample``: a generator per
parameter name, seeded by ``mx.random.seed``, so a parameter's values do
not depend on creation order.  Their bits differ from the JAX package's
(as any sampling does); their distributions and scales are the same.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from .base import MXNetError, registry, torch_dtype
from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu",
           "Bilinear", "LSTMBias", "Mixed", "Load"]

_REG = registry("initializer")

register = _REG.register


class InitDesc(str):
    """Name + attrs descriptor handed to initializers
    (reference python/mxnet/initializer.py:InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer (reference python/mxnet/initializer.py:Initializer).

    Dispatches on name suffix exactly like the reference __call__: weights,
    biases, gammas/betas, and BatchNorm moving stats each get their
    conventional fill; ``__init_name__`` attrs override per-parameter.
    """

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func or (lambda x: None)
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    # -- fills ----------------------------------------------------------
    def _fill(self, arr, values):
        from .ndarray.ndarray import NDArray
        if isinstance(values, torch.Tensor):
            # a draw of named_sample, made where the array lives
            values = values.to(torch_dtype(arr.dtype)).expand(arr.shape)
            if isinstance(arr, NDArray):
                arr[:] = NDArray(values)
            else:
                arr[:] = values.cpu().numpy()
            return
        values = np.asarray(values, dtype=np.dtype(arr.dtype))
        if values.shape != tuple(arr.shape):
            values = np.broadcast_to(values, arr.shape)
        arr[:] = values

    def _init_zero(self, _, arr):
        self._fill(arr, np.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._fill(arr, np.ones(arr.shape))

    def _init_bias(self, _, arr):
        self._fill(arr, np.zeros(arr.shape))

    def _init_gamma(self, _, arr):
        self._fill(arr, np.ones(arr.shape))

    def _init_beta(self, _, arr):
        self._fill(arr, np.zeros(arr.shape))

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown initialization pattern for {name}. Default initialization"
            " only covers *weight/*bias/*gamma/*beta/running stats; pass"
            " init= explicitly for custom parameter names.")

    def _rand(self, name, kind, arr=None, **kw):
        """Per-parameter reproducible sampling: fold the parameter name into
        the global init seed (TPU-native replacement for the sequential
        legacy RNG); drawn on ``arr``'s device when it is an NDArray."""
        from .ndarray.ndarray import NDArray
        device = arr._data.device if isinstance(arr, NDArray) else None
        return _random.named_sample(str(name), kind, device=device, **kw)


@register("zeros", aliases=("zero",))
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, np.zeros(arr.shape))


@register("ones", aliases=("one",))
class One(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, np.ones(arr.shape))


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, np.full(arr.shape, self.value))


@register("uniform")
class Uniform(Initializer):
    """U(-scale, scale) (reference initializer.py:Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._fill(arr, self._rand(name, "uniform", arr, low=-self.scale,
                                   high=self.scale, shape=arr.shape))


@register("normal", aliases=("gaussian",))
class Normal(Initializer):
    """N(0, sigma^2) (reference initializer.py:Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._fill(arr, self._rand(name, "normal", arr, scale=self.sigma,
                                   shape=arr.shape))


@register("orthogonal")
class Orthogonal(Initializer):
    """(Scaled) orthogonal init via QR/SVD (reference initializer.py:Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = self._rand(name, "uniform", low=-1.0, high=1.0,
                             shape=(nout, nin))
        else:
            tmp = self._rand(name, "normal", scale=1.0, shape=(nout, nin))
        u, _, v = np.linalg.svd(np.asarray(tmp), full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        self._fill(arr, self.scale * q.reshape(arr.shape))


@register("xavier")
class Xavier(Initializer):
    """Xavier/Glorot (reference initializer.py:Xavier); factor_type in
    {avg, in, out}, rnd_type in {uniform, gaussian}."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier initializer cannot init {name} with shape {shape}:"
                " need >= 2D")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._fill(arr, self._rand(name, "uniform", arr, low=-scale,
                                       high=scale, shape=shape))
        elif self.rnd_type in ("gaussian", "normal"):
            self._fill(arr, self._rand(name, "normal", arr, scale=scale,
                                       shape=shape))
        else:
            raise MXNetError("Unknown random type")


@register("msraprelu", aliases=("msra",))
class MSRAPrelu(Xavier):
    """He/MSRA init for PReLU nets (reference initializer.py:MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("bilinear")
class Bilinear(Initializer):
    """Bilinear upsampling kernel (reference initializer.py:Bilinear)."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._fill(arr, weight.reshape(shape))


@register("lstmbias")
class LSTMBias(Initializer):
    """Init forget-gate bias to forget_bias, rest 0
    (reference initializer.py:LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = b.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._fill(arr, b)


class Mixed:
    """Patterns -> initializers router (reference initializer.py:Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same length")
        import re
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(
            f"Parameter name {name} did not match any pattern. Consider"
            " adding a \".*\" pattern at the end with default Initializer.")


@register("load")
class Load:
    """Init from a dict of arrays, fall back to default_init
    (reference initializer.py:Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        key = str(name)
        key = key[4:] if key.startswith(("arg:", "aux:")) else key
        if key in self.param:
            src = self.param[key]
            src_np = src.asnumpy() if hasattr(src, "asnumpy") else np.asarray(src)
            if tuple(src_np.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {tuple(arr.shape)} vs loaded "
                    f"{src_np.shape}")
            arr[:] = src_np.astype(np.dtype(arr.dtype))
        else:
            if self.default_init is None:
                raise MXNetError(
                    f"Cannot init parameter {name} from loading: not found and"
                    " no default initializer")
            self.default_init(name, arr)


def create(name, **kwargs):
    """Create initializer from name/instance/JSON string
    (reference registry._REGISTRY semantics)."""
    if isinstance(name, Initializer):
        return name
    if callable(name) and not isinstance(name, type):
        return name
    if isinstance(name, str) and name.startswith("["):
        klass_name, kw = json.loads(name)
        return _REG.get(klass_name)(**kw)
    klass = _REG.get(name)
    return klass(**kwargs)
