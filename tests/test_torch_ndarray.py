"""Parity of the port's imperative front end (``mx.nd`` over
``torch.Tensor`` and the op registry) with the JAX package's.

Every ported op runs on the same inputs, drawn by a seeded numpy stream,
through the JAX package's ``mx.nd.<op>`` and the port's, on the CPU;
dtypes and shapes must be equal.  Tolerances, stated per kind:

* ``EXACT`` — arithmetic, rounding, comparisons, shape ops, indexing,
  init ops: bit-identical (both sides do the same IEEE operations).
* ``ULP`` — transcendental functions (exp, log, tanh, erf, ...):
  relative 2e-6 plus absolute 1e-7 (a few fp32 ulps), since XLA's and
  torch's CPU math libraries are different approximations of the same
  functions.
  ``_div_scalar`` too: XLA divides by a constant as a multiply by its
  reciprocal (1 ulp off a true division).  ``gammaln`` near its zeros
  at 1 and 2 has values far below its rounding error of about
  ulp(1): it is held to relative 2e-6 plus absolute 2e-6 (``LGAMMA``).
* ``RED`` — reductions, products (dot, FullyConnected) and softmax:
  relative 1e-5 plus absolute 1e-6 (other summation orders).

Gradients under ``record()`` / ``backward()`` of a seeded cotangent are
held to relative 1e-5 plus absolute 1e-6 for every differentiable op.
Then creation and dtype rules, in-place writes (``__setitem__``,
``+=``, ``out=``), the aliasing rule, and the default context.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

EXACT = ("exact", 0.0, 0.0)
ULP = ("ulp", 2e-6, 1e-7)
LGAMMA = ("ulp", 2e-6, 2e-6)
RED = ("red", 1e-5, 1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6

_RS = np.random.RandomState(20261017)


def _u(lo, hi, shape=(3, 4)):
    return _RS.uniform(lo, hi, shape).astype(np.float32)


def _ints(lo, hi, shape=(3, 4), dtype=np.float32):
    return _RS.randint(lo, hi, shape).astype(dtype)


def _signed(lo, hi, shape=(3, 4)):
    """Magnitudes in [lo, hi) with random signs (no values near 0)."""
    return (_u(lo, hi, shape) * np.where(_RS.rand(*shape) < 0.5, -1, 1)
            ).astype(np.float32)


class Case:
    """One op call: name, numpy inputs, attributes, tolerance kind,
    whether its gradient is compared, and an id suffix."""

    def __init__(self, op, inputs, attrs=None, tol=EXACT, grad=True,
                 tag=""):
        self.op, self.inputs, self.attrs = op, inputs, attrs or {}
        self.tol, self.grad, self.tag = tol, grad, tag

    @property
    def id(self):
        return self.op + (f"-{self.tag}" if self.tag else "")


CASES = []


def case(*a, **k):
    CASES.append(Case(*a, **k))


# ------------------------------------------------------------- elemwise
for name in ("negative", "abs", "square", "relu", "softsign"):
    case(name, [_u(-2, 2)])
for name in ("sign", "round", "rint", "ceil", "floor", "trunc", "fix"):
    case(name, [_u(-3, 3)])
case("logical_not", [_ints(-1, 2)], grad=False)
case("reciprocal", [_signed(0.5, 2)])
case("sqrt", [_u(0.1, 4)])
case("rsqrt", [_u(0.1, 4)], tol=ULP)
case("degrees", [_u(-3, 3)], tol=ULP)
case("radians", [_u(-180, 180)], tol=ULP)
for name in ("exp", "expm1", "sin", "cos", "tan", "arctan", "sinh", "cosh",
             "tanh", "arcsinh", "sigmoid", "erf"):
    case(name, [_u(-1.5, 1.5)], tol=ULP)
for name in ("log", "log10", "log2", "log1p", "gamma"):
    case(name, [_u(0.5, 3)], tol=ULP)
case("gammaln", [_u(0.5, 3)], tol=LGAMMA)
for name in ("cbrt", "rcbrt"):
    case(name, [_signed(0.2, 3)], tol=ULP)
for name in ("arcsin", "arccos", "arctanh", "erfinv"):
    case(name, [_u(-0.9, 0.9)], tol=ULP)
case("arccosh", [_u(1.1, 3)], tol=ULP)
case("identity", [_u(-1, 1)])
case("make_loss", [_u(-1, 1)])
case("BlockGrad", [_u(-1, 1)], grad=False)
case("Cast", [_u(-3, 3)], {"dtype": "float16"}, tag="f16")
case("Cast", [_u(-3, 3)], {"dtype": "int32"}, grad=False, tag="i32")
case("amp_cast", [_u(-3, 3)], {"dtype": "float16"})
case("clip", [_u(-3, 3)], {"a_min": -1.0, "a_max": 1.5})
case("smooth_l1", [_u(-2, 2)], {"scalar": 1.5})
case("where", [_ints(0, 2), _u(-1, 1), _u(-1, 1)])
case("where", [_ints(0, 2, (3,)), _u(-1, 1), _u(-1, 1)], tag="rows")
case("add_n", [_u(-1, 1), _u(-1, 1), _u(-1, 1)])
case("_scatter_elemwise_div", [_u(-1, 1), _signed(0.5, 2)])
case("_scatter_set_nd", [_u(-1, 1), np.array([[0, 2], [1, 3]], np.float32),
                         np.array([7.0, 8.0], np.float32)],
     {"shape": (3, 4)}, grad=False)
for name in ("broadcast_add", "broadcast_sub", "broadcast_mul",
             "broadcast_maximum", "broadcast_minimum"):
    case(name, [_u(-2, 2), _u(-2, 2, (1, 4))])
case("broadcast_div", [_u(-2, 2), _signed(0.5, 2, (1, 4))])
case("broadcast_mod", [_u(-4, 4), _signed(0.5, 2, (1, 4))])
case("broadcast_power", [_u(0.5, 2), _u(-1.5, 1.5, (1, 4))], tol=ULP)
case("broadcast_hypot", [_u(-2, 2), _u(-2, 2, (1, 4))], tol=ULP)
for name in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
             "broadcast_greater_equal", "broadcast_lesser",
             "broadcast_lesser_equal", "broadcast_logical_and",
             "broadcast_logical_or", "broadcast_logical_xor"):
    case(name, [_ints(0, 3), _ints(0, 3, (1, 4))], grad=False)
for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
             "_mul_scalar", "_maximum_scalar", "_minimum_scalar"):
    case(name, [_u(-2, 2)], {"scalar": 0.75})
case("_div_scalar", [_u(-2, 2)], {"scalar": 0.3}, tol=ULP)
case("_rdiv_scalar", [_signed(0.5, 2)], {"scalar": 0.3})
case("_mod_scalar", [_u(-4, 4)], {"scalar": 1.3})
case("_rmod_scalar", [_signed(0.5, 2)], {"scalar": 1.3})
case("_power_scalar", [_u(0.5, 2)], {"scalar": 1.7}, tol=ULP)
case("_rpower_scalar", [_u(-2, 2)], {"scalar": 1.7}, tol=ULP)
case("_hypot_scalar", [_u(-2, 2)], {"scalar": 0.75}, tol=ULP)
case("_plus_scalar", [_ints(-5, 5, dtype=np.int32)], {"scalar": 1.5},
     grad=False, tag="int-float-scalar")
case("_plus_scalar", [_ints(-5, 5, dtype=np.int32)], {"scalar": 2},
     grad=False, tag="int-int-scalar")
for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
             "_greater_equal_scalar", "_lesser_scalar",
             "_lesser_equal_scalar", "_logical_and_scalar",
             "_logical_or_scalar", "_logical_xor_scalar"):
    case(name, [_ints(0, 3)], {"scalar": 1.0}, grad=False)
case("_greater_scalar", [_ints(0, 3, dtype=np.int32)], {"scalar": 1.0},
     grad=False, tag="int")

# ------------------------------------------------------------- reduce
X3 = (2, 3, 4)
for name in ("sum", "mean", "max", "min", "prod", "nansum", "nanprod"):
    lo = 0.5 if name in ("prod", "nanprod") else -2
    case(name, [_u(lo, 2, X3)], tol=RED, tag="all")
    case(name, [_u(lo, 2, X3)], {"axis": 1}, tol=RED, tag="axis1")
    case(name, [_u(lo, 2, X3)], {"axis": (0, 2), "keepdims": True},
         tol=RED, tag="axes-keep")
    case(name, [_u(lo, 2, X3)], {"axis": 1, "exclude": True}, tol=RED,
         tag="exclude")
case("sum", [_ints(-5, 5, X3, np.int32)], {"axis": 1}, grad=False,
     tag="int")
case("mean", [_ints(-5, 5, X3, np.int32)], {"axis": 1}, tol=RED,
     grad=False, tag="int")
case("nansum", [np.where(_RS.rand(*X3) < 0.3, np.nan, _u(-2, 2, X3))
                .astype(np.float32)], {"axis": 2}, tol=RED, grad=False,
     tag="nan")
case("norm", [_u(-2, 2, X3)], tol=RED, tag="l2")
case("norm", [_u(-2, 2, X3)], {"ord": 1, "axis": 1}, tol=RED, tag="l1")
case("norm", [_u(-2, 2, X3)], {"axis": (1, 2), "keepdims": True}, tol=RED,
     tag="axes")
for name in ("argmax", "argmin"):
    case(name, [_u(-2, 2, X3)], grad=False, tag="flat")
    case(name, [_u(-2, 2, X3)], {"axis": 1, "keepdims": True}, grad=False,
         tag="axis")
case("argmax_channel", [_u(-2, 2, X3)], grad=False)
case("broadcast_to", [_u(-1, 1, (1, 4))], {"shape": (3, 4)})
case("broadcast_to", [_u(-1, 1, (2, 1))], {"shape": (0, 5)}, tag="keep0")
case("broadcast_axis", [_u(-1, 1, (2, 1, 1))], {"axis": (1, 2),
                                                 "size": (3, 4)})
case("broadcast_like", [_u(-1, 1, (1, 4)), _u(-1, 1, (3, 4))])
case("cumsum", [_u(-1, 1, X3)], {"axis": 1}, tol=RED)
case("cumsum", [_u(-1, 1, X3)], tol=RED, tag="flat")

# ------------------------------------------------------------- matrix
X4 = (2, 3, 4, 2)
for spec, tag in (((6, -1), "infer"), ((0, -1), "keep"),
                  ((-2,), "rest"), ((-3, 4, 2), "merge"),
                  ((0, -4, 3, 1, 8), "split"), ((-4, 1, 2, -2), "split-rest")):
    case("Reshape", [_u(-1, 1, X4)], {"shape": spec}, tag=tag)
case("Reshape", [_u(-1, 1, X4)], {"shape": (-1, 0), "reverse": True},
     tag="reverse")
case("Flatten", [_u(-1, 1, X4)])
case("transpose", [_u(-1, 1, X3)])
case("transpose", [_u(-1, 1, X3)], {"axes": (1, 0, 2)}, tag="axes")
case("expand_dims", [_u(-1, 1, X3)], {"axis": 1})
case("expand_dims", [_u(-1, 1, X3)], {"axis": -1}, tag="last")
case("squeeze", [_u(-1, 1, (2, 1, 3, 1))])
case("squeeze", [_u(-1, 1, (2, 1, 3, 1))], {"axis": 1}, tag="axis")
case("SwapAxis", [_u(-1, 1, X3)], {"dim1": 0, "dim2": 2})
case("slice", [_u(-1, 1, X3)], {"begin": (0, 1), "end": (2, 3)})
case("slice", [_u(-1, 1, X3)], {"begin": (None, 2, 3), "end": (None, 0, 0),
                                "step": (1, -1, -2)}, tag="negstep")
case("slice_axis", [_u(-1, 1, X3)], {"axis": 2, "begin": 1, "end": 3})
case("slice_axis", [_u(-1, 1, X3)], {"axis": -2, "begin": -2, "end": 3},
     tag="neg")
case("slice_like", [_u(-1, 1, X3), _u(-1, 1, (1, 2, 3))])
case("Crop", [_u(-1, 1, (1, 2, 6, 5))], {"h_w": (3, 2), "offset": (1, 2)})
case("Crop", [_u(-1, 1, (1, 2, 6, 5))], {"h_w": (3, 2), "center_crop": True},
     tag="center")
case("tile", [_u(-1, 1, (2, 3))], {"reps": (2, 1, 2)})
case("repeat", [_u(-1, 1, (2, 3))], {"repeats": 2, "axis": 1})
case("repeat", [_u(-1, 1, (2, 3))], {"repeats": 3}, tag="flat")
case("reverse", [_u(-1, 1, X3)], {"axis": 1})
case("flip", [_u(-1, 1, X3)], {"axis": (0, 2)}, tag="axes")
case("diag", [_u(-1, 1, (4, 4))])
case("diag", [_u(-1, 1, (4, 5))], {"k": 1}, tag="k")
case("diag", [_u(-1, 1, (4,))], tag="vector")
case("diag", [_u(-1, 1, (3, 3, 2))], {"k": -1}, tag="3d")
case("Concat", [_u(-1, 1, (2, 3)), _u(-1, 1, (2, 2))])
case("Concat", [_u(-1, 1, (2, 3)), _u(-1, 1, (1, 3))], {"dim": 0},
     tag="dim0")
case("stack", [_u(-1, 1, (2, 3)), _u(-1, 1, (2, 3))], {"axis": 1})
case("SliceChannel", [_u(-1, 1, (2, 6))], {"num_outputs": 3})
case("split", [_u(-1, 1, (4, 3))], {"num_outputs": 4, "axis": 0,
                                    "squeeze_axis": True}, tag="squeeze")
case("space_to_depth", [_u(-1, 1, (1, 2, 4, 6))], {"block_size": 2})
case("depth_to_space", [_u(-1, 1, (1, 8, 2, 3))], {"block_size": 2})
case("dot", [_u(-1, 1, (3, 4)), _u(-1, 1, (4, 5))], tol=RED)
case("dot", [_u(-1, 1, (4, 3)), _u(-1, 1, (5, 4))],
     {"transpose_a": True, "transpose_b": True}, tol=RED, tag="tt")
case("dot", [_u(-1, 1, (4,)), _u(-1, 1, (4,))], tol=RED, tag="vv")
case("dot", [_u(-1, 1, (2, 3, 4)), _u(-1, 1, (4, 5))], tol=RED, tag="3d")
case("batch_dot", [_u(-1, 1, (2, 3, 4)), _u(-1, 1, (2, 4, 5))], tol=RED)
case("batch_dot", [_u(-1, 1, (2, 4, 3)), _u(-1, 1, (2, 5, 4))],
     {"transpose_a": True, "transpose_b": True}, tol=RED, tag="tt")
case("khatri_rao", [_u(-1, 1, (2, 3)), _u(-1, 1, (4, 3))], tol=RED)
case("shape_array", [_u(-1, 1, X3)], grad=False)
case("size_array", [_u(-1, 1, X3)], grad=False)
case("reshape_like", [_u(-1, 1, (2, 6)), _u(-1, 1, (3, 4))])

# ------------------------------------------------------------- nn
case("FullyConnected", [_u(-1, 1, (4, 6)), _u(-1, 1, (5, 6)),
                        _u(-1, 1, (5,))], {"num_hidden": 5}, tol=RED)
case("FullyConnected", [_u(-1, 1, (4, 2, 3)), _u(-1, 1, (5, 6))],
     {"num_hidden": 5, "no_bias": True}, tol=RED, tag="flatten-nobias")
case("FullyConnected", [_u(-1, 1, (4, 2, 3)), _u(-1, 1, (5, 3)),
                        _u(-1, 1, (5,))],
     {"num_hidden": 5, "flatten": False}, tol=RED, tag="noflatten")
for act in ("relu", "softsign"):
    case("Activation", [_u(-2, 2)], {"act_type": act}, tag=act)
for act in ("sigmoid", "tanh", "softrelu", "gelu"):
    case("Activation", [_u(-2, 2)], {"act_type": act}, tol=ULP, tag=act)
case("softmax", [_u(-2, 2, X3)], tol=RED)
case("softmax", [_u(-2, 2, X3)], {"axis": 1, "temperature": 2.0}, tol=RED,
     tag="axis-temp")
case("log_softmax", [_u(-2, 2, X3)], tol=RED)
case("log_softmax", [_u(-2, 2, X3)], {"axis": 0}, tol=RED, tag="axis0")
case("softmax_cross_entropy", [_u(-2, 2, (5, 7)), _ints(0, 7, (5,))],
     tol=RED)

# ------------------------------------------------------------- indexing
case("pick", [_u(-1, 1, (4, 5)), _ints(0, 5, (4,))])
case("pick", [_u(-1, 1, (4, 5)), _ints(0, 4, (5,))], {"axis": 0},
     tag="axis0")
case("pick", [_u(-1, 1, X3), _ints(0, 4, (2, 3))],
     {"axis": 2, "keepdims": True}, tag="keep")
case("take", [_u(-1, 1, (5, 3)), _ints(0, 5, (2, 2))])
case("take", [_u(-1, 1, (3, 5)), _ints(-2, 8, (4,))], {"axis": 1},
     tag="clip")
case("take", [_u(-1, 1, (3, 5)), _ints(-7, 12, (4,))],
     {"axis": 1, "mode": "wrap"}, tag="wrap")
case("one_hot", [np.array([0, 3, 1, -1, 4], np.float32)], {"depth": 4},
     grad=False)
case("one_hot", [_ints(0, 3, (2, 2))],
     {"depth": 3, "on_value": 2.0, "off_value": -1.0}, grad=False,
     tag="values")
for ret in ("indices", "value", "both", "mask"):
    case("topk", [_u(-2, 2, X3)], {"k": 2, "ret_typ": ret}, grad=False,
         tag=ret)
case("topk", [_u(-2, 2, X3)], {"k": 2, "axis": 1, "is_ascend": True,
                               "ret_typ": "both"}, grad=False, tag="asc")
case("sort", [_u(-2, 2, X3)])
case("sort", [_u(-2, 2, X3)], {"axis": 0, "is_ascend": False}, tag="desc")
case("argsort", [_u(-2, 2, X3)], grad=False)
case("argsort", [_u(-2, 2, X3)], {"axis": 1, "is_ascend": False},
     grad=False, tag="desc")
case("zeros_like", [_u(-1, 1)], grad=False)
case("ones_like", [_u(-1, 1)], grad=False)
case("_zeros", [], {"shape": (2, 3)}, grad=False)
case("_ones", [], {"shape": (2, 3), "dtype": "int32"}, grad=False)
case("_full", [], {"shape": (2, 3), "value": 2.5}, grad=False)
case("_eye", [], {"N": 3}, grad=False)
case("_eye", [], {"N": 3, "M": 4, "k": 1}, grad=False, tag="k")
case("_arange", [], {"start": 2, "stop": 11, "step": 3}, grad=False)
case("_arange", [], {"start": 5, "repeat": 2, "dtype": "int32"}, grad=False,
     tag="repeat")

# ------------------------------------------------------------- optimizer
case("sgd_update", [_u(-1, 1), _u(-1, 1)], {"lr": 0.1, "wd": 0.01},
     tol=RED, grad=False)
case("sgd_update", [_u(-1, 1), _u(-3, 3)],
     {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 1.0}, tol=RED,
     grad=False, tag="clip")
case("sgd_mom_update", [_u(-1, 1), _u(-1, 1), _u(-1, 1)],
     {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, tol=RED, grad=False)
case("mp_sgd_update", [_u(-1, 1), _u(-3, 3), _u(-1, 1)],
     {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.0},
     tol=RED, grad=False)
case("mp_sgd_mom_update", [_u(-1, 1), _u(-1, 1), _u(-1, 1), _u(-1, 1)],
     {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, tol=RED, grad=False)


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _call(mod, c, ctx=None):
    arrays = [mod.nd.array(a, dtype=a.dtype, **({"ctx": ctx} if ctx
                                                 else {}))
              for a in c.inputs]
    return arrays, getattr(mod.nd, c.op)(*arrays, **c.attrs)


def _compare(got, want, tol, what):
    kind, rtol, atol = tol
    got, want = _outs(got), _outs(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = g.asnumpy(), w.asnumpy()
        assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
        if kind == "exact":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=what)


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(c):
    _, want = _call(jmx, c)
    with tmx.cpu():
        _, got = _call(tmx, c)
    _compare(got, want, c.tol, c.id)


GRAD_CASES = [c for c in CASES if c.grad]


def _grads(mod, c, cots):
    arrays, _ = _call(mod, c)
    params = [a for a in arrays if a.dtype.kind == "f"]
    for a in params:
        a.attach_grad()
    with mod.autograd.record():
        outs = _outs(getattr(mod.nd, c.op)(*arrays, **c.attrs))
        loss = None
        for o, cot in zip(outs, cots):
            term = (o.astype("float32") * mod.nd.array(cot)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [a.grad for a in params]


@pytest.mark.parametrize("c", GRAD_CASES, ids=[c.id for c in GRAD_CASES])
def test_op_gradient_matches_jax(c):
    shapes = [o.shape for o in _outs(_call(jmx, c)[1])]
    rs = np.random.RandomState(7)
    cots = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    want = _grads(jmx, c, cots)
    with tmx.cpu():
        got = _grads(tmx, c, cots)
    _compare(got, want, ("grad", GRAD_RTOL, GRAD_ATOL), c.id)


# ------------------------------------------------------------- operators
def test_ndarray_operators_match_jax():
    """The arithmetic operators route to the same ops (scalar and
    reversed forms included)."""
    a, b = _u(0.5, 2), _u(0.5, 2)

    def run(mod):
        x, y = mod.nd.array(a), mod.nd.array(b)
        return [x + y, x - 1.5, 2 - x, x * 3, 3 * x, x / y, 1 / x, x % 0.7,
                2.0 % x, x ** 2, 2 ** x, -x, abs(-x), x == y, x != 1.0,
                x > y, x >= 1.0, 1.0 > x, x < y, x <= 1.0, x.T, x.sum(),
                x.mean(axis=0), x.max(axis=1, keepdims=True), x.argmax(1),
                x.reshape((4, 3)), x.flatten(), x.expand_dims(0),
                x.square(), x.sqrt(), x.clip(0.7, 1.2), x.tile((1, 2)),
                x.repeat(2, axis=0), x.flip(1), x.dot(y.T),
                x.broadcast_to((2, 3, 4)), x.slice_axis(1, 1, 3),
                x.take(mod.nd.array([2, 0])), x.topk(k=2, ret_typ="value"),
                x.astype("float16"), x.norm(), x.softmax(),
                x.log_softmax(axis=0), x[1], x[1:3, ::2], x[:, -1],
                x[::-1, 1], x[2, 3:0:-2]]
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for i, (g, w) in enumerate(zip(got, want)):
        _compare(g, w, RED, f"expression {i}")


# ------------------------------------------------------------- creation
def test_creation_and_dtype_rules_match_jax():
    sources = [[1, 2, 3], [1.5, 2.5], 3.0, np.arange(4, dtype=np.float64),
               np.arange(4, dtype=np.int32), np.arange(4, dtype=np.uint8),
               np.ones((2, 2), np.float16), np.array([True, False])]
    for src in sources:
        want = jmx.nd.array(src)
        got = tmx.nd.array(src, ctx=tmx.cpu())
        _compare(got, want, EXACT, repr(src))
    with tmx.cpu():
        pairs = [(tmx.nd.zeros((2, 3)), jmx.nd.zeros((2, 3))),
                 (tmx.nd.ones((2,), dtype="int32"),
                  jmx.nd.ones((2,), dtype="int32")),
                 (tmx.nd.full((2, 2), 7.5), jmx.nd.full((2, 2), 7.5)),
                 (tmx.nd.empty((3,)), jmx.nd.empty((3,))),
                 (tmx.nd.arange(1, 10, 2), jmx.nd.arange(1, 10, 2)),
                 (tmx.nd.array(np.ones(3), dtype="float16"),
                  jmx.nd.array(np.ones(3), dtype="float16")),
                 (tmx.nd.concatenate([tmx.nd.ones((1, 2)),
                                      tmx.nd.zeros((2, 2))]),
                  jmx.nd.concatenate([jmx.nd.ones((1, 2)),
                                      jmx.nd.zeros((2, 2))]))]
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        pairs.append((tmx.nd.moveaxis(tmx.nd.array(x), 0, -1),
                      jmx.nd.moveaxis(jmx.nd.array(x), 0, -1)))
    for i, (g, w) in enumerate(pairs):
        _compare(g, w, EXACT, f"creation {i}")
    got = tmx.nd.ones((2,), ctx=tmx.cpu())
    assert got.context == tmx.cpu() and got._data.device.type == "cpu"
    tmx.nd.waitall()


def test_setitem_iadd_and_out_match_jax_and_write_in_place():
    base = _u(-1, 1, (4, 5))
    upd = _u(-1, 1, (5,))

    def run(mod, keep_ptr):
        x = mod.nd.array(base)
        ptr = x._data.data_ptr() if keep_ptr else None
        x[1] = 5.0
        x[:, 2] = mod.nd.array(upd[:4])
        x[2:4] = upd
        x[mod.nd.array(np.array([0, 3], np.int32))] = -1.0
        x[0, ::-2] = 9.0
        x += mod.nd.array(upd)
        x -= 2
        x *= mod.nd.array(upd)
        x /= 4
        w, g = mod.nd.array(base), mod.nd.array(upd)
        out = mod.nd.broadcast_add(w, g, out=w)
        mod.nd.sgd_update(w, mod.nd.ones(w.shape) * 0.5, lr=0.1, out=w)
        if keep_ptr:
            assert x._data.data_ptr() == ptr, "in-place write rebound x"
            assert out is w
        return [x, w]

    want = run(jmx, False)
    with tmx.cpu():
        got = run(tmx, True)
    for g, w in zip(got, want):
        _compare(g, w, RED, "in-place")


# ------------------------------------------------------------- aliasing
def _aliasing(mod):
    """Views and copies taken from x, then x written in place: what each
    one holds afterwards."""
    x = mod.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    taken = [x[1:3], x[0], x.detach(), x.copy(), x.reshape((4, 3)),
             x.T, mod.nd.identity(x), mod.nd.broadcast_to(x[0:1], shape=(2, 4)),
             x.as_in_context(x.context), x.astype("float32"),
             mod.nd.array(x), mod.nd.split(x, num_outputs=2, axis=1)[1]]
    x[:] = -1.0
    x += 5
    return taken


def test_aliasing_matches_jax():
    """No array sees a later write to another (a slice, detach(), a
    copy, a reshape), as in the JAX package; as_in_context of the same
    context is the same array, so it sees the write."""
    want = _aliasing(jmx)
    with tmx.cpu():
        got = _aliasing(tmx)
    for i, (g, w) in enumerate(zip(got, want)):
        _compare(g, w, EXACT, f"aliasing case {i}")
    assert np.all(got[8].asnumpy() == 4.0)     # the same NDArray as x
    np.testing.assert_array_equal(got[0].asnumpy(),
                                  np.arange(4, 12).reshape(2, 4))


def test_slice_under_record_is_differentiable_and_owned():
    with tmx.cpu():
        x = tmx.nd.array(np.arange(6, dtype=np.float32))
        x.attach_grad()
        with tmx.autograd.record():
            y = x[1:4] * 2
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [0, 2, 2, 2, 0, 0])
        s = x[2:5]
        x[:] = 0
        np.testing.assert_array_equal(s.asnumpy(), [2, 3, 4])


# ------------------------------------------------------------- contexts
def test_default_context_is_gpu_and_raises_without_one(monkeypatch):
    """The port's default context is gpu(0): without a GPU the first
    array raises MXNetError (the JAX package's default is cpu(0)); under
    ``with mx.cpu():`` it runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.gpu(0)
    assert jmx.current_context() == jmx.cpu(0)
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.ones((2,))
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.ones((2,), ctx=tmx.tpu(0))
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu(0)
        y = tmx.nd.ones((2,))
        np.testing.assert_array_equal(y.asnumpy(), [1, 1])
        assert y.context == tmx.cpu(0)
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.num_gpus() == 0


def test_gpu_index_out_of_range_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(MXNetError, match="cuda:3"):
        tmx.gpu(3).torch_device()
    assert tmx.tpu(0).torch_device() == torch.device("cuda", 0)
    assert tmx.cpu(0).torch_device() == torch.device("cpu")
    with pytest.raises(MXNetError, match="unknown device type"):
        tmx.Context("npu", 0)


def test_unknown_attribute_names_the_kwarg():
    with tmx.cpu():
        a = tmx.nd.ones((2, 2))
        with pytest.raises(TypeError, match="bogus"):
            tmx.nd.dot(a, a, bogus=1)
        with pytest.raises(MXNetError, match="scalar"):
            tmx.nd.ones((2,)).asscalar()
        with pytest.raises(MXNetError, match="ambiguous"):
            bool(tmx.nd.ones((2,)))
        with pytest.raises(MXNetError, match="unknown op"):
            tmx.nd.invoke("no_such_op", [a], {})


def test_registry_lists_every_ported_op_once():
    from incubator_mxnet_tpu.ops import list_ops as jax_list
    from incubator_mxnet_tpu_torch.ops import get_op, list_ops
    names = set(list_ops())
    assert {c.op for c in CASES} <= names
    assert names <= set(jax_list()), sorted(names - set(jax_list()))
    assert get_op("elemwise_add") is get_op("broadcast_add")
    assert get_op("random_uniform").needs_rng
    assert not get_op("argmax").differentiable


# ------------------------------------------------------------- faults
def _copyto(mod, target):
    """``copyto`` of float32 values into int32 zeros, into an array or
    a context (the CPU, the one context both packages have here)."""
    src = mod.nd.array([1.5, 2.5])
    if target == "array":
        dst = mod.nd.zeros((2,), dtype="int32")
        out = src.copyto(dst)
        assert out is dst
        return dst
    return src.copyto(mod.cpu())


@pytest.mark.parametrize("target", ["array", "context"])
def test_copyto_keeps_target_dtype_and_context_like_jax(target):
    want = _copyto(jmx, target)
    with tmx.cpu():
        got = _copyto(tmx, target)
    _compare(got, want, EXACT, f"copyto {target}")
    assert got.context == tmx.cpu() and got._data.device.type == "cpu"


KINKS = {
    "abs": (lambda nd, x: nd.abs(x), [-1.0, 0.0, 2.0]),
    "abs-method": (lambda nd, x: abs(x), [0.0, -0.0, 3.0]),
    "clip": (lambda nd, x: nd.clip(x, a_min=-1.0, a_max=1.5),
             [-2.0, -1.0, 0.0, 1.5, 2.0]),
    "clip-method": (lambda nd, x: x.clip(0.0, 0.0), [-1.0, 0.0, 1.0]),
    "norm-ord1": (lambda nd, x: nd.norm(x, ord=1), [0.0, -2.0, 3.0]),
    "log-abs": (lambda nd, x: nd.log(nd.abs(x)), [0.0, -2.0, 0.5]),
}


def _kink_grad(mod, name):
    f, values = KINKS[name]
    x = mod.nd.array(np.array(values, np.float32))
    x.attach_grad()
    with mod.autograd.record():
        y = f(mod.nd, x)
    y.backward()
    return [y, x.grad]


@pytest.mark.parametrize("name", sorted(KINKS))
def test_kink_gradient_matches_jax(name):
    """abs and clip at their kinks (0; a_min and a_max): the JAX
    package's derivatives (1; 0.5), also inside compositions."""
    want = _kink_grad(jmx, name)
    with tmx.cpu():
        got = _kink_grad(tmx, name)
    for g, w, what in zip(got, want, ("value", "gradient")):
        _compare(g, w, EXACT, f"{name} {what}")


def _write_saved(mod, case):
    """A write to an array that a recorded op saved, then ``backward``:
    the gradient is taken at the recorded values."""
    v = mod.nd.array([1.0, 2.0, 3.0])
    v.attach_grad()
    with mod.autograd.record():
        if case == "variable":
            head = v * v
        else:
            u = v * 2
            a = u * u
            if case == "setitem":
                u[0] = 5
            else:
                u += 1
            head = a + u * 3
    if case == "variable":
        v[:] = 0
    head.backward()
    return [v.grad, head, v]


@pytest.mark.parametrize("case", ["setitem", "iadd", "variable"])
def test_write_to_saved_array_matches_jax(case):
    want = _write_saved(jmx, case)
    with tmx.cpu():
        got = _write_saved(tmx, case)
    for i, (g, w) in enumerate(zip(got, want)):
        _compare(g, w, EXACT, f"{case} {i}")
    expect = [2, 4, 6] if case == "variable" else [14, 22, 30]
    np.testing.assert_array_equal(got[0].asnumpy(), expect)


def test_write_after_backward_stays_in_place():
    """Once ``backward`` has freed the graph, a write to a variable goes
    in place again (the SGD update, rtc launches on its storage)."""
    with tmx.cpu():
        w = tmx.nd.array([0.5, -1.5])
        w.attach_grad()
        with tmx.autograd.record():
            loss = (w * w).sum()
        ptr = w._data.data_ptr()
        loss.backward()
        w -= 0.1 * w.grad
        w[:] = w * 2
        assert w._data.data_ptr() == ptr
        np.testing.assert_allclose(w.asnumpy(), [0.8, -2.4], rtol=1e-6)
        with tmx.autograd.record():
            loss = (w * w).sum()
        loss.backward()
        np.testing.assert_allclose(w.grad.asnumpy(), [1.6, -4.8], rtol=1e-6)
