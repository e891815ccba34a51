"""Elementwise, broadcast and scalar operators (counterpart of
``incubator_mxnet_tpu/ops/elemwise.py``; reference
src/operator/tensor/elemwise_*.cc).

Each op is one torch expression; autograd gives its gradient.  Output
dtypes are the JAX package's: a float scalar applied to an integer
array gives float32 (``_sc``); comparisons return the left operand's
dtype.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register_op

__all__ = []


def _sc(x, scalar):
    """``(x, scalar)`` ready for a scalar op with the JAX package's
    dtype rule: the scalar takes x's dtype, except that a float scalar
    on an integer array computes in float32."""
    if isinstance(scalar, float) and not (x.is_floating_point()
                                          or x.is_complex()):
        x = x.to(torch.float32)
    return x, scalar


def _full(x, scalar):
    """The scalar as a 0-d tensor of x's dtype on x's device (for the
    ops without a Scalar overload)."""
    return torch.full((), scalar, dtype=x.dtype, device=x.device)


def _unbool(x, dtype=torch.int32):
    """A bool array as ``dtype`` (int32: JAX's integer promotion of
    bool), for the torch calls that refuse bool; other arrays as they
    are."""
    return x.to(dtype) if x.dtype == torch.bool else x


def _float(x):
    """x computing in float32 when it is an integer or bool array, as
    the JAX ops whose result is a float promote it."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _bool_kept(f):
    """``f`` with a bool array passed through, as the JAX ops that are
    the identity on bool (``abs``, ``ceil``, ``floor``, ``trunc``)
    give it back."""
    return lambda x: x.clone() if x.dtype == torch.bool else f(x)


class _Abs(torch.autograd.Function):
    """``|x|`` with ``jnp.abs``'s derivative: +1 at 0 (``x >= 0``),
    where ``torch.abs`` gives 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


abs_ = _Abs.apply


class _Cbrt(torch.autograd.Function):
    """Cube root with ``lax.cbrt``'s derivative ``g / (3 y^2)``: +inf at
    0, where autograd of ``sign(x) |x|^(1/3)`` gives NaN."""

    @staticmethod
    def forward(ctx, x):
        # |x| after the float cast (int8 -128 has no int8 abs); copysign
        # keeps -0 (cbrt(-0) = -0, so rcbrt(-0) = -inf)
        x = _float(x)
        y = torch.copysign(torch.abs(x).pow(1.0 / 3.0), x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * ((1.0 / 3.0) * torch.reciprocal(y * y))


_cbrt = _Cbrt.apply


def _sign(x):
    """``torch.sign`` with NaN kept, as ``jnp.sign`` keeps it (torch
    gives 0); no gradient, as the JAX op has none."""
    return torch.where(torch.isnan(x), x.detach(), torch.sign(x))


def _hypot(a, b):
    """``jnp.hypot``'s composition, so that autograd gives JAX's
    gradient: 0.5 for each input at (0, 0), where ``torch.hypot``'s is
    NaN.  Integer and bool inputs take ``abs`` after their float32 cast
    (int8 -128 has no int8 abs)."""
    a, b = abs_(_float(a)), abs_(_float(b))
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * torch.sqrt(1 + torch.square(r)))
    return torch.where(inf, torch.full_like(out, float("inf")), out)


# ---------------------------------------------------------------- unary math
_UNARY = {
    "negative": torch.neg,
    "reciprocal": torch.reciprocal,
    "abs": _bool_kept(abs_),
    "sign": _sign,
    "round": torch.round,
    "rint": lambda x: torch.round(x if x.is_floating_point()
                                  else x.to(torch.float32)),
    "ceil": _bool_kept(torch.ceil),
    "floor": _bool_kept(torch.floor),
    "trunc": _bool_kept(torch.trunc),
    "fix": _bool_kept(torch.trunc),
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: torch.reciprocal(_cbrt(x)),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: _unbool(x) / (torch.abs(_unbool(x)) + 1),
    "relu": lambda x: torch.relu(_unbool(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register_op(_name, (lambda f: lambda x: f(x))(_f))


def _identity(x):
    return x


register_op("identity", _identity, aliases=("_copy", "stop_gradient_off"))
register_op("BlockGrad", lambda x: x.detach(), aliases=("stop_gradient",))
register_op("make_loss", lambda x: x, aliases=("MakeLoss",))


@register_op("Cast", aliases=("cast",))
def _cast(x, *, dtype):
    """Differentiable cast: the gradient is cast back to x's dtype.  A
    float cast to an integer dtype saturates as XLA's does: NaN to 0,
    values past the range to its ends (torch wraps them)."""
    dt = torch_dtype(dtype)
    if not x.is_floating_point() or dt.is_floating_point or \
            dt == torch.bool:
        return x.to(dt)
    info = torch.iinfo(dt)
    out = x.to(dt)
    out = torch.where(x >= info.max, info.max, out)
    out = torch.where(x <= info.min, info.min, out)
    return torch.where(torch.isnan(x), 0, out)


@register_op("amp_cast")
def _amp_cast(x, *, dtype):
    return x.to(torch_dtype(dtype))


@register_op("clip")
def _clip(x, *, a_min, a_max):
    """``jnp.clip``'s form, maximum then minimum, so the gradient at
    ``a_min`` or ``a_max`` is 0.5 as there (``torch.clamp`` gives 1).
    An integer array with a float bound computes in float32, as JAX
    promotes it."""
    for bound in (a_min, a_max):
        x, _ = _sc(x, bound)
    if a_min is not None:
        x = torch.maximum(x, _full(x, a_min))
    if a_max is not None:
        x = torch.minimum(x, _full(x, a_max))
    return x


def _mod(a, b):
    """``torch.remainder`` with an integer modulo by zero giving 0, as
    MXNet's ``mshadow_op::mod`` and the JAX op do (torch raises on the
    CPU and leaves the value undefined on the card).  Bool operands
    compute in int32, as JAX promotes them."""
    a, b = _unbool(a), _unbool(b)
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


# ---------------------------------------------------------------- binary
# elemwise_* (same shape) and broadcast_* names map to the same
# broadcasting torch call, as in the JAX package.
_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": _mod,
    "broadcast_power": lambda a, b: torch.pow(_unbool(a), _unbool(b)),
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": _hypot,
}
_BINARY_ALIASES = {
    "broadcast_add": ("elemwise_add", "_plus", "_add", "_Plus"),
    "broadcast_sub": ("elemwise_sub", "_minus", "_sub", "_Minus"),
    "broadcast_mul": ("elemwise_mul", "_mul", "_Mul"),
    "broadcast_div": ("elemwise_div", "_div", "_Div"),
    "broadcast_mod": ("_mod",),
    "broadcast_power": ("_power", "_Power", "pow"),
    "broadcast_maximum": ("_maximum",),
    "broadcast_minimum": ("_minimum",),
    "broadcast_hypot": ("_hypot",),
}

for _name, _f in _BINARY.items():
    register_op(_name, (lambda f: lambda lhs, rhs: f(lhs, rhs))(_f),
                aliases=_BINARY_ALIASES.get(_name, ()))

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}
for _name, _f in _CMP.items():
    register_op(
        _name,
        (lambda f: lambda lhs, rhs: f(lhs, rhs).to(lhs.dtype))(_f),
        aliases=(_name.replace("broadcast_", "_"),), differentiable=False)


@register_op("_scatter_elemwise_div")
def _scatter_div(lhs, rhs):
    return lhs / rhs


# ---------------------------------------------------------------- scalar
_SCALAR = {
    "_plus_scalar": torch.add,
    "_minus_scalar": torch.sub,
    "_rminus_scalar": lambda x, s: torch.sub(s, x),
    "_mul_scalar": torch.mul,
    "_div_scalar": torch.div,
    "_rdiv_scalar": lambda x, s: torch.div(s, x),
    "_mod_scalar": lambda x, s: _mod(x, _full(x, s)),
    "_rmod_scalar": lambda x, s: _mod(_full(x, s), x),
    # a 0-d exponent, not the Python scalar: torch.pow's scalar 0.5
    # takes sqrt, which gives NaN at -inf where C's pow gives +inf
    "_power_scalar": lambda x, s: torch.pow(_unbool(x),
                                            _unbool(_full(x, s))),
    # on bool the scalar takes x's dtype first, as the JAX op's weak
    # scalar does (2 becomes True)
    "_rpower_scalar": lambda x, s: torch.pow(s, x) if x.dtype != torch.bool
    else torch.pow(_unbool(_full(x, s)), _unbool(x)),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full(x, s)),
    "_hypot_scalar": lambda x, s: _hypot(x, _full(x, s)),
}
for _name, _f in _SCALAR.items():
    register_op(_name,
                (lambda f: lambda x, *, scalar: f(*_sc(x, scalar)))(_f))

_SCALAR_CMP = {
    "_equal_scalar": torch.eq,
    "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt,
    "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt,
    "_lesser_equal_scalar": torch.le,
    "_logical_and_scalar": torch.logical_and,
    "_logical_or_scalar": torch.logical_or,
    "_logical_xor_scalar": torch.logical_xor,
}


def _scalar_cmp(f):
    def op(x, *, scalar):
        xs, s = _sc(x, scalar)
        return f(xs, _full(xs, s)).to(x.dtype)
    return op


for _name, _f in _SCALAR_CMP.items():
    register_op(_name, _scalar_cmp(_f), differentiable=False)


@register_op("smooth_l1")
def _smooth_l1(x, *, scalar=1.0):
    x = _unbool(x)
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


@register_op("where")
def _where(condition, x, y):
    cond = condition.bool()
    if condition.ndim != x.ndim:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond, x, y)


@register_op("_scatter_set_nd", differentiable=False)
def _scatter_set_nd(lhs, indices, rhs, *, shape=None):
    out = lhs.clone()
    out[tuple(indices.long())] = rhs.to(out.dtype)
    return out


@register_op("add_n", aliases=("ElementWiseSum", "_sum", "elemwise_sum"))
def _add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out

