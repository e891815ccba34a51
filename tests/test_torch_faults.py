"""The port's faults C1-C7 (ROADMAP §C), each held to the JAX package's
value on the same inputs, on the CPU.  One parametrised case per fault
input; every case failed before its repair.

* C1 ``topk`` breaks ties by the lower index (``jax.lax.top_k``).
* C2 ``sum``/``prod`` widen bool, int8 and int16 to int32 and uint8 to
  uint32.
* C3 ``clip`` of an integer array with float bounds, and ``softmax`` /
  ``log_softmax`` of an integer array, compute in float32.
* C4 ``BatchNorm(scale=False)`` / ``center=False``: gamma / beta take no
  gradient, so a ``TrainStep`` runs and leaves them where they were,
  weight decay included; both still travel in the ``state_dict``.
* C5 the gradients of ``broadcast_hypot`` / ``_hypot_scalar`` at (0, 0)
  (0.5 each) and of ``cbrt`` / ``rcbrt`` at 0 (+inf / -inf).
* C6 ``sign(NaN)`` is NaN.
* C7 ``Cast`` of out-of-range floats to integers saturates, NaN to 0.
* C8 ``ServingConfig`` takes JAX's arguments in JAX's order
  (``max_batch, linger_us, queue_depth, buckets, full_policy,
  timeout_ms, watchdog_s``): the port took ``timeout_ms`` fifth, so
  ``ServingConfig(8, 100, 16, None, "block")`` set ``timeout_ms="block"``
  without an error, and refused ``full_policy``/``watchdog_s``.

* C9 ``SoftmaxActivation``, ``Activation("softrelu")`` and average
  pooling of an integer array compute in float32 (torch raised).
* C10 ``nansum`` and ``norm(ord=1)`` of integers keep JAX's widened
  integer dtype; ``rint`` of an integer array gives float32.
* C11 an integer modulo by zero gives 0 (torch raised).
* C12 ``x ** 0.5`` at -inf is +inf (and ``x ** -0.5`` there is 0), as
  C's ``pow`` gives.
* C13 ``axis=()`` reduces nothing: ``L2Normalization(mode="spatial")``
  of a 2-D input and ``norm(x, axis=())``.
* C14 an integer beside index arrays, split from them by a slice, joins
  them as numpy's rule says (read and write).
* C15 ``mx.random.seed`` reaches the initializers: a Gluon net's initial
  weights differ between two seeds, and equal the JAX package's for the
  same seed and names (uniform draws to an ulp, normal ones through
  ``erfinv``: 1e-6 of max).
* C16 ``resolve_device(None)`` under a process group is the rank's own
  card, ``(LOCAL_RANK or DMLC_WORKER_ID) % device_count()`` (every
  rank of an N-card launch took ``cuda:0``); without a process group it
  stays ``cuda:0``, and without a GPU it raises.
* C17 ``parallel.flash_attention`` has a gradient on both devices: one
  ``torch.autograd.Function`` whose backward is the VJP of the plain
  fp32 ``attention`` (JAX ``_flash_bwd``); on the card its forward
  wrote the kernel's output into a fresh tensor with no ``grad_fn``.
  dq, dk and dv equal ``jax.grad`` of the JAX ``flash_attention``
  (``interpret=True``) within 1e-5 of their max.
* C18 ``moe_ffn`` breaks tied gate probabilities toward the lower
  expert, as ``lax.top_k`` does (``torch.topk`` took the higher ones):
  with a zero gate its output, aux loss and gradients equal JAX's
  within 1e-5 of their max (they were 19.96 apart).
* C19 (in ``tests/test_torch_model_parallel.py``, whose four-rank world
  runs it): a ``ShardedEmbedding`` block with no rows joins the
  collectives with a zero lookup.
* C20 a step the loss scaler skips leaves the optimizer's counters
  where the JAX step leaves them: ``num_update`` counts applied updates
  only, and Adam's, Adamax's and FTML's bias corrections with it; the
  weights after one overflowed and three clean steps within 1e-6 of
  JAX's ``TrainStep`` for SGD, Adam, Adamax and FTML.
* C21 ``axis=()`` keeps each reduction's dtype and NaN rules: ``sum`` /
  ``prod`` widen small integers and bool, ``mean`` of integers is
  float32, ``nansum`` / ``nanprod`` replace NaN by 0 / 1; ``norm`` of a
  float is ``|x|`` (1e30 stays finite).
* C22 ``cbrt`` / ``rcbrt`` / ``hypot`` take ``abs`` after the float cast
  (int8 -128), and ``rcbrt(-0.0)`` is -inf (signs exactly, values to
  1e-6 relative: ``|x| ** (1/3)`` and XLA's cbrt are an ulp apart).
* C23 bool computes where JAX computes (``abs``, ``ceil``, ``floor``,
  ``trunc``, ``fix``, ``relu``, ``cbrt``, ``rcbrt``, ``softsign``,
  ``smooth_l1``, the ``hypot``s, the ``mod``s, the ``power``s,
  ``argmax`` / ``argmin`` / ``argmax_channel``), and ``cumsum`` keeps an
  int8 / uint8 / int16 dtype; bool subtraction raises on both sides.

The A4.6 names ride along: ``mx.random.poisson`` ... ``shuffle`` draw
through the ``nd.random`` ops, ``autograd.set_recording`` /
``set_training`` return the previous flag, ``autograd.get_symbol``
raises, and ``cpu_pinned`` / ``num_devices`` / ``num_tpus`` exist.

Tolerances: exact (value and dtype) for C1-C3 and C5-C7 (the same IEEE
operations on both sides), except softmax (relative 1e-6, other
exponentials); C4's parameters and statistics after a step 1e-6 of each
tensor's max, and the fixed ones exactly; C9's softmax and softplus
relative 1e-6 (torch's ``softplus`` is ``log1p(exp(x))``, JAX's
``logaddexp(x, 0)``), its pools and C10-C14 exact.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu_torch.gluon.nn._modules import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.nn._modules import BatchNorm, BNReLU
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import TrainStep
from incubator_mxnet_tpu.serving import ServingConfig as JaxServingConfig
from incubator_mxnet_tpu_torch.serving import ServingConfig


def _both(f):
    """``f(mod)`` on the JAX package, then on the port on the CPU, each
    result as a list of numpy arrays."""
    def run(mod):
        out = f(mod)
        out = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in out]
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    return got, want


def _exact(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=what)


# ------------------------------------------------------------------ C1
TIES = np.array([[2, 2, 2, 2], [1, 3, 3, 0]], np.float32)


@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("ret_typ", ["indices", "both", "mask"])
def test_c1_topk_ties_take_the_lower_index(ret_typ, is_ascend):
    got, want = _both(lambda m: m.nd.topk(
        m.nd.array(TIES), k=2, ret_typ=ret_typ, is_ascend=is_ascend))
    _exact(got, want, f"topk {ret_typ} ascend={is_ascend}")


def test_c1_topk_ties_along_axis_0():
    got, want = _both(lambda m: m.nd.topk(
        m.nd.array(TIES.T.copy()), axis=0, k=3, ret_typ="both"))
    _exact(got, want, "topk axis 0")


# ------------------------------------------------------------------ C2
@pytest.mark.parametrize("op", ["sum", "prod"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "uint8"])
def test_c2_small_integer_reductions_widen(op, dtype):
    x = np.array([100, 100, 100] if op == "sum" else [100, 3, 2])
    x = x.astype(dtype)
    got, want = _both(lambda m: getattr(m.nd, op)(m.nd.array(x,
                                                             dtype=dtype)))
    _exact(got, want, f"{op} {dtype}")


# ------------------------------------------------------------------ C3
@pytest.mark.parametrize("bounds", [(0.5, 2.5), (-0.5, 1.5), (0.25, 7.0)])
def test_c3_clip_integers_with_float_bounds(bounds):
    x = np.array([-2, 0, 1, 3], np.int32)
    got, want = _both(lambda m: m.nd.clip(m.nd.array(x, dtype="int32"),
                                          a_min=bounds[0], a_max=bounds[1]))
    _exact(got, want, f"clip {bounds}")


@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
def test_c3_softmax_of_integers(op):
    x = np.array([[1, 2, 3], [0, -4, 2]], np.int32)
    got, want = _both(lambda m: getattr(m.nd, op)(m.nd.array(x,
                                                             dtype="int32")))
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)


# ------------------------------------------------------------------ C4
BN_KEYS = ("gamma", "beta", "running_mean", "running_var")


def _bn_values(seed):
    rs = np.random.RandomState(seed)
    return {"gamma": rs.uniform(0.5, 1.5, 4).astype(np.float32),
            "beta": (0.1 * rs.randn(4)).astype(np.float32),
            "running_mean": (0.1 * rs.randn(4)).astype(np.float32),
            "running_var": rs.uniform(0.5, 1.5, 4).astype(np.float32),
            "x": rs.randn(8, 4).astype(np.float32),
            "y": rs.randint(0, 4, 8).astype(np.float32)}


def _jax_step(layer_cls, scale, center, v, wd):
    net = layer_cls(scale=scale, center=center, in_channels=4)
    net.initialize()
    for k in BN_KEYS:
        getattr(net, k).set_data(jmx.nd.array(v[k]))
    step = jparallel.TrainStep(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jmx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=wd))
    loss = float(step(jmx.nd.array(v["x"]), jmx.nd.array(v["y"]))
                 .asscalar())
    step.sync_params()
    return loss, {k: getattr(net, k).data().asnumpy() for k in BN_KEYS}


@pytest.mark.parametrize("scale,center", [(False, True), (True, False),
                                          (False, False)])
@pytest.mark.parametrize("layer", ["BatchNorm", "BNReLU"])
def test_c4_fixed_gamma_beta_train_like_jax(layer, scale, center):
    """One SGD step (lr 0.1, momentum 0.9, wd 1e-2) over a lone
    BatchNorm / BNReLU: the port's step runs, its loss, parameters and
    moving statistics equal JAX's, and the fixed gamma / beta keep their
    exact values, weight decay notwithstanding."""
    v = _bn_values(3)
    wd = 1e-2
    jloss, want = _jax_step(getattr(jgluon.nn, layer), scale, center, v,
                            wd)
    cls = {"BatchNorm": BatchNorm, "BNReLU": BNReLU}[layer]
    net = cls(4, scale=scale, center=center, device="cpu")
    assert set(net.state_dict()) == set(BN_KEYS)
    net.load_state_dict({k: torch.from_numpy(v[k]) for k in BN_KEYS})
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     SGD(learning_rate=0.1, momentum=0.9, wd=wd),
                     device="cpu")
    loss = float(step(v["x"], v["y"]))
    assert abs(loss - jloss) <= 1e-6 * max(abs(jloss), 1.0)
    for k in BN_KEYS:
        got = getattr(net, k).detach().numpy()
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=1e-6 * np.abs(want[k]).max(),
                                   err_msg=k)
    if not scale:
        np.testing.assert_array_equal(net.gamma.detach().numpy(),
                                      v["gamma"])
    if not center:
        np.testing.assert_array_equal(net.beta.detach().numpy(),
                                      v["beta"])


def test_c4_bnrelu_fixed_gamma_stays_one_under_weight_decay():
    net = BNReLU(4, scale=False, device="cpu")
    v = _bn_values(5)
    v["gamma"] = np.ones(4, np.float32)
    net.load_state_dict({k: torch.from_numpy(v[k]) for k in BN_KEYS})
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     SGD(learning_rate=0.1, wd=1e-2), device="cpu")
    step(v["x"], v["y"])
    assert torch.equal(net.gamma, torch.ones(4))
    assert not net.beta.eq(torch.from_numpy(v["beta"])).all()


# ------------------------------------------------------------------ C5
def _grad_at(mod, f, values):
    xs = [mod.nd.array(np.array(v, np.float32)) for v in values]
    for x in xs:
        x.attach_grad()
    with mod.autograd.record():
        y = f(mod, *xs)
    y.backward()
    return [y] + [x.grad for x in xs]


ZERO_GRADS = {
    "broadcast_hypot": (lambda m, a, b: m.nd.broadcast_hypot(a, b),
                        [[0.0, 3.0, 0.0], [0.0, 4.0, -2.0]]),
    "_hypot_scalar": (lambda m, a: m.nd._hypot_scalar(a, scalar=0.0),
                      [[0.0, -3.0]]),
    "cbrt": (lambda m, a: m.nd.cbrt(a), [[0.0, 8.0, -8.0]]),
    "rcbrt": (lambda m, a: m.nd.rcbrt(a), [[0.0, 8.0, -8.0]]),
}


@pytest.mark.parametrize("name", sorted(ZERO_GRADS))
def test_c5_gradient_at_zero_matches_jax(name):
    f, values = ZERO_GRADS[name]
    got, want = _both(lambda m: _grad_at(m, f, values))
    for g, w, what in zip(got, want, ("value", "grad a", "grad b")):
        assert not np.isnan(g).any(), f"{name} {what}: {g}"
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                   err_msg=f"{name} {what}")


# ------------------------------------------------------------------ C6
def test_c6_sign_keeps_nan():
    x = np.array([np.nan, -1.5, 0.0, -0.0, 2.0], np.float32)
    got, want = _both(lambda m: m.nd.sign(m.nd.array(x)))
    _exact(got, want, "sign")


# ------------------------------------------------------------------ C7
@pytest.mark.parametrize("dtype,value", [
    ("int32", 1e10), ("int32", np.nan), ("int32", np.inf),
    ("uint8", 300.0), ("uint8", -5.0), ("int8", 200.0), ("int8", -200.0),
    ("int16", 1e6)])
def test_c7_cast_saturates_like_xla(dtype, value):
    x = np.array([value, 1.5], np.float32)
    got, want = _both(lambda m: m.nd.Cast(m.nd.array(x), dtype=dtype))
    _exact(got, want, f"Cast {value} to {dtype}")


def test_c2_c7_values_the_repairs_leave_alone():
    """What was right before the repairs stays right: bool sums and
    products (int32), and casts at the ends of the range and inside it
    (truncation toward 0)."""
    b = np.array([True, True, False])
    for op in ("sum", "prod"):
        _exact(*_both(lambda m: getattr(m.nd, op)(m.nd.array(b,
                                                              dtype="bool"))),
               f"{op} bool")
    for dtype, vals in (("int32", [-1e10, 2147483520.0, -3.7, 3.7]),
                        ("uint8", [np.nan, 255.5, 0.5, 254.0])):
        x = np.array(vals, np.float32)
        _exact(*_both(lambda m: m.nd.Cast(m.nd.array(x), dtype=dtype)),
               f"Cast {vals} to {dtype}")


# ------------------------------------------------------------------ C8
SERVING_ATTRS = ("max_batch", "linger_us", "queue_depth", "buckets",
                 "full_policy", "timeout_ms", "watchdog_s")


@pytest.mark.parametrize("args,kwargs", [
    ((8, 100, 16, None, "block"), {}),
    ((8, 100, 16, [2, 8], "reject", 250.0, 1.5), {}),
    ((8,), dict(full_policy="block")),
    ((8,), dict(full_policy="block", timeout_ms=5, watchdog_s=0.5)),
    ((), dict(max_batch=4, buckets=[1, 4], watchdog_s=2))])
def test_c8_serving_config_takes_jax_arguments(args, kwargs):
    got, want = ServingConfig(*args, **kwargs), \
        JaxServingConfig(*args, **kwargs)
    for attr in SERVING_ATTRS:
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("kwargs", [
    dict(full_policy="drop"), dict(watchdog_s=-1.0)])
def test_c8_serving_config_validates_like_jax(kwargs):
    with pytest.raises(jmx.MXNetError):
        JaxServingConfig(8, **kwargs)
    with pytest.raises(tmx.MXNetError):
        ServingConfig(8, **kwargs)


def test_c8_serving_watchdog_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_WATCHDOG_S", "0.25")
    assert ServingConfig().watchdog_s == JaxServingConfig().watchdog_s \
        == 0.25


# ------------------------------------------------------------------ C9
INTS = np.array([[1, 2, 3, 4], [-3, 0, 5, 2]], np.int32)
POOL_INTS = np.arange(-8, 17, dtype=np.int32).reshape(1, 1, 5, 5)


@pytest.mark.parametrize("call", [
    lambda m: m.nd.SoftmaxActivation(m.nd.array(INTS, dtype="int32")),
    lambda m: m.nd.SoftmaxActivation(m.nd.array(INTS, dtype="int32"),
                                     mode="channel"),
    lambda m: m.nd.Activation(m.nd.array(INTS, dtype="int32"),
                              act_type="softrelu")],
    ids=["softmax_instance", "softmax_channel", "softrelu"])
def test_c9_float_only_ops_of_integers(call):
    got, want = _both(call)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(2, 2), stride=(1, 1), pool_type="sum"),
    dict(kernel=(1, 1), global_pool=True, pool_type="avg"),
    dict(kernel=(1, 1), global_pool=True, pool_type="sum")],
    ids=["avg", "avg_nopad", "avg_full", "sum", "global_avg", "global_sum"])
def test_c9_average_pooling_of_integers(kwargs):
    got, want = _both(lambda m: m.nd.Pooling(
        m.nd.array(POOL_INTS, dtype="int32"), **kwargs))
    _exact(got, want, f"Pooling {kwargs}")


# ------------------------------------------------------------------ C10
@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8"])
@pytest.mark.parametrize("axis", [None, 1])
def test_c10_nansum_of_integers(dtype, axis):
    got, want = _both(lambda m: m.nd.nansum(
        m.nd.array(np.abs(INTS), dtype=dtype), axis=axis))
    _exact(got, want, f"nansum {dtype} axis={axis}")


@pytest.mark.parametrize("call", [
    lambda m: m.nd.norm(m.nd.array(INTS, dtype="int32"), ord=1, axis=1),
    lambda m: m.nd.norm(m.nd.array(INTS, dtype="int32"), ord=1),
    lambda m: m.nd.rint(m.nd.array(INTS, dtype="int32"))],
    ids=["norm1_axis", "norm1_all", "rint"])
def test_c10_integer_norm_and_rint_dtypes(call):
    got, want = _both(call)
    _exact(got, want, "integer norm / rint")


# ------------------------------------------------------------------ C11
MOD_A = np.array([5, -5, 7, 0, -7], np.int32)
MOD_B = np.array([0, 0, 3, 0, 2], np.int32)


@pytest.mark.parametrize("call", [
    lambda m: m.nd.broadcast_mod(m.nd.array(MOD_A, dtype="int32"),
                                 m.nd.array(MOD_B, dtype="int32")),
    lambda m: m.nd.array(MOD_A, dtype="int32") %
    m.nd.array(MOD_B, dtype="int32"),
    lambda m: m.nd.broadcast_mod(m.nd.array(MOD_A[:, None], dtype="int32"),
                                 m.nd.array(MOD_B[None], dtype="int32")),
    lambda m: m.nd._mod_scalar(m.nd.array(MOD_A, dtype="int32"), scalar=0),
    lambda m: m.nd._rmod_scalar(m.nd.array(MOD_B, dtype="int32"),
                                scalar=7)],
    ids=["broadcast_mod", "operator", "broadcast", "mod_scalar",
         "rmod_scalar"])
def test_c11_integer_modulo_by_zero_is_zero(call):
    got, want = _both(call)
    _exact(got, want, "integer mod")


# ------------------------------------------------------------------ C12
POW_X = np.array([-np.inf, 4.0, 0.0, np.inf, 2.25], np.float32)


@pytest.mark.parametrize("exponent", [0.5, -0.5, 2.0, 3.0])
def test_c12_power_scalar_at_infinity(exponent):
    got, want = _both(lambda m: m.nd.array(POW_X) ** exponent)
    _exact(got, want, f"x ** {exponent}")


# ------------------------------------------------------------------ C13
@pytest.mark.parametrize("call", [
    lambda m: m.nd.L2Normalization(
        m.nd.array(np.array([[3, -4], [0.5, 2]], np.float32)),
        mode="spatial"),
    lambda m: m.nd.norm(m.nd.array(np.array([[3, -4]], np.float32)),
                        axis=()),
    lambda m: m.nd.norm(m.nd.array(np.array([[3, -4]], np.float32)),
                        ord=1, axis=())],
    ids=["l2norm_spatial_2d", "norm2", "norm1"])
def test_c13_empty_axes_reduce_nothing(call):
    got, want = _both(call)
    _exact(got, want, "axis=()")


# ------------------------------------------------------------------ C14
CUBE = np.arange(60, dtype=np.float32).reshape(3, 4, 5)


@pytest.mark.parametrize("key", [
    (1, slice(None), np.array([4, 0])),
    (slice(None), 2, np.array([1, 3, 1])),
    (np.array([2, 0]), slice(1, 3), 4),
    (np.array([2, 0]), 1, np.array([4, 3]))],
    ids=["int_slice_idx", "slice_int_idx", "idx_slice_int", "adjacent"])
def test_c14_mixed_advanced_indexing_reads_like_numpy(key):
    got, want = _both(lambda m: m.nd.array(CUBE)[key])
    _exact(got, want, f"read {key}")
    assert got[0].shape == CUBE[key].shape


def test_c14_mixed_advanced_indexing_writes_like_numpy():
    key = (1, slice(None), np.array([4, 0]))
    value = np.arange(8, dtype=np.float32).reshape(2, 4)

    def write(m):
        x = m.nd.array(CUBE)
        x[key] = m.nd.array(value)
        return x
    got, want = _both(write)
    _exact(got, want, "write")
    ref = CUBE.copy()
    ref[key] = value
    np.testing.assert_array_equal(got[0], ref)


@pytest.mark.parametrize("init", ["uniform", "xavier_gaussian"])
def test_c15_seed_reaches_the_initializers(init):
    def build(mx, seed):
        mx.random.seed(seed)
        net = mx.gluon.nn.HybridSequential(prefix="c15_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(7, in_units=5),
                    mx.gluon.nn.Embedding(11, 3))
        net.initialize(mx.init.Uniform(0.3) if init == "uniform" else
                       mx.init.Xavier(rnd_type="gaussian"))
        return {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}
    want = build(jmx, 3)
    with tmx.cpu():
        got, other = build(tmx, 3), build(tmx, 4)
    assert set(got) == set(want)
    for name in want:
        w = want[name]
        if not w.any():
            continue              # the biases start at 0
        scale = np.abs(w).max()
        assert np.abs(got[name] - w).max() <= 1e-6 * scale, name
        assert not np.array_equal(other[name], got[name]), name


@pytest.mark.parametrize("env,group,want", [
    ({"LOCAL_RANK": "3", "DMLC_WORKER_ID": "0"}, True, 1),
    ({"DMLC_WORKER_ID": "2"}, True, 0),
    ({"DMLC_WORKER_ID": "5"}, True, 1),
    ({"LOCAL_RANK": "1"}, False, 0)])
def test_c16_default_device_is_the_rank_card(monkeypatch, env, group, want):
    import torch.distributed as dist
    from incubator_mxnet_tpu_torch.context import resolve_device
    for name in ("LOCAL_RANK", "DMLC_WORKER_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(dist, "is_initialized", lambda: group)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device(None) == torch.device("cuda", want)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        resolve_device(None)


@pytest.mark.parametrize("causal", [False, True])
def test_c17_flash_attention_has_the_plain_vjp(causal):
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel.flash_attention import (
        flash_attention as jax_flash)
    from incubator_mxnet_tpu_torch.parallel.flash_attention import (
        _Flash, flash_attention)
    rs = np.random.RandomState(17 + causal)
    q, k, v, do = (rs.randn(2, 3, 32, 16).astype(np.float32)
                   for _ in range(4))

    def jloss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=16, block_k=16,
                        interpret=True)
        return (out * do).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, block_q=16, block_k=16)
    # the Function's node: the CUDA route builds the same graph
    assert type(out.grad_fn).__name__ == _Flash.__name__ + "Backward"
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------------------ C18
def test_c18_moe_zero_gate_breaks_ties_toward_the_lower_expert():
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel.moe import moe_ffn as jax_moe
    from incubator_mxnet_tpu_torch.parallel.moe import moe_ffn
    rs = np.random.RandomState(18)
    n, d, e, h = 12, 8, 4, 16
    f = np.float32
    args = [rs.randn(n, d).astype(f), np.zeros((d, e), f),
            (0.3 * rs.randn(e, d, h)).astype(f),
            (0.1 * rs.randn(e, h)).astype(f),
            (0.3 * rs.randn(e, h, d)).astype(f),
            (0.1 * rs.randn(e, d)).astype(f)]
    cot = rs.randn(n, d).astype(f)
    kw = dict(top_k=2, capacity_factor=1.0)

    def jloss(*a):
        y, aux = jax_moe(*a, **kw)
        return (y * cot).sum() + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
            *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, aux = moe_ffn(*ts, **kw)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    pairs = [(y.detach().numpy(), np.asarray(jy)),
             (np.float32(aux.detach()), np.asarray(jaux))]
    pairs += [(t.grad.numpy(), np.asarray(g)) for t, g in zip(ts, jgrads)]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1))


# ------------------------------------------------------------------ C20
def _c20_batches():
    rs = np.random.RandomState(20)
    xs = [rs.randn(4, 5).astype(np.float32) for _ in range(4)]
    ys = [rs.randn(4, 3).astype(np.float32) for _ in range(4)]
    xs[0] = xs[0] * 1e6             # its scaled gradient overflows
    return xs, ys


def _c20_run(m, opt, step_cls, place):
    m.random.seed(0)
    net = m.gluon.nn.Dense(3, in_units=5, prefix="c20_")
    net.initialize(m.init.Xavier())
    net.weight.set_data(m.nd.array(np.linspace(
        -1, 1, 15, dtype=np.float32).reshape(3, 5)))
    net.bias.set_data(m.nd.array(np.array([0.1, -0.2, 0.3], np.float32)))
    optimizer = m.optimizer.create(opt, learning_rate=0.01)
    step = step_cls(net, m.gluon.loss.L2Loss(), optimizer,
                    loss_scaler=m.numerics.LossScaler(
                        init_scale=3e38, backoff_factor=1e-36), **place)
    for x, y in zip(*_c20_batches()):
        step(m.nd.array(x), m.nd.array(y))
    step.sync_params()
    return optimizer, [net.weight.data().asnumpy(),
                       net.bias.data().asnumpy()]


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamax", "ftml"])
def test_c20_skipped_step_rewinds_the_update_counters(opt):
    jopt, want = _c20_run(jmx, opt, jparallel.TrainStep, {})
    with tmx.cpu():
        topt, got = _c20_run(tmx, opt, TrainStep, {"device": "cpu"})
    assert jopt.num_update == 3
    assert topt.num_update == 3
    assert set(topt._index_update_count.values()) == {3}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_c20_rewind_updates_stops_at_begin_num_update():
    for m in (jmx, tmx):
        opt = m.optimizer.SGD(begin_num_update=5)
        opt.num_update = 7
        opt.rewind_updates(1)
        assert opt.num_update == 6
        opt.rewind_updates(4)
        assert opt.num_update == 5


# ------------------------------------------------------------- C21-C23
EDGE = {"float32": np.array([[np.nan, 1e30], [-0.0, -3.0]], np.float32),
        "int8": np.array([[-128, 3], [127, -5]], np.int8),
        "uint8": np.array([[200, 3], [255, 0]], np.uint8),
        "int16": np.array([[-300, 3], [32000, 5]], np.int16),
        "bool": np.array([[True, False], [False, True]])}


def _edge(m, dtype):
    return m.nd.array(EDGE[dtype], dtype=dtype)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("dtype", list(EDGE))
@pytest.mark.parametrize("op", ["sum", "prod", "mean", "nansum", "nanprod",
                                "max", "min", "norm"])
def test_c21_empty_axis_keeps_the_reduction_rules(op, dtype, keepdims):
    got, want = _both(lambda m: getattr(m.nd, op)(
        _edge(m, dtype), axis=(), keepdims=keepdims))
    _exact(got, want, f"{op} {dtype} axis=()")


@pytest.mark.parametrize("call", [
    lambda m: m.nd.cbrt(_edge(m, "int8")),
    lambda m: m.nd.rcbrt(_edge(m, "int8")),
    lambda m: m.nd.cbrt(m.nd.array(np.array([-0.0, 0.0, -8.0], np.float32))),
    lambda m: m.nd.rcbrt(m.nd.array(np.array([-0.0, 0.0, -8.0],
                                             np.float32))),
    lambda m: m.nd.broadcast_hypot(
        m.nd.array(np.array([-0.0, 3.0], np.float32)),
        m.nd.array(np.array([-128, 4], np.int8), dtype="int8")),
    lambda m: m.nd.broadcast_hypot(_edge(m, "int8"), _edge(m, "int8")),
    lambda m: m.nd._internal._hypot_scalar(_edge(m, "int8"), scalar=0)],
    ids=["cbrt_int8", "rcbrt_int8", "cbrt_zero", "rcbrt_zero",
         "hypot_mixed", "hypot_int8", "hypot_scalar_int8"])
def test_c22_cube_root_and_hypot_at_the_edges(call):
    """Signs, infinities and dtypes exactly; values to 1e-6 relative
    (the port's cube root is ``|x| ** (1/3)``, XLA's a cbrt: an ulp
    apart)."""
    got, want = _both(call)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


_C23_UNARY = ["abs", "ceil", "floor", "trunc", "fix", "relu", "cbrt",
              "rcbrt", "softsign", "argmax_channel"]
_C23_BINARY = ["broadcast_mod", "_mod", "broadcast_power", "_power",
               "broadcast_hypot", "_hypot"]
_C23_SCALAR = ["_mod_scalar", "_rmod_scalar", "_power_scalar",
               "_rpower_scalar", "_hypot_scalar"]


def _c23_call(op):
    def call(m):
        x = _edge(m, "bool")
        f = getattr(m.nd, op, None) or getattr(m.nd._internal, op)
        if op in _C23_BINARY:
            return f(x, m.nd.array(EDGE["bool"][::-1].copy(), dtype="bool"))
        if op in _C23_SCALAR:
            # 7, not 2: the JAX registry caches an op by its attributes,
            # and C12's ``** 2.0`` (== 2) would hand this call its
            # float program
            return f(x, scalar=7)
        if op == "smooth_l1":
            return f(x, scalar=1.0)
        if op in ("argmax", "argmin"):
            return f(x, axis=1)
        return f(x)
    return call


@pytest.mark.parametrize("op", _C23_UNARY + _C23_BINARY + _C23_SCALAR +
                         ["smooth_l1", "argmax", "argmin"])
def test_c23_bool_computes_where_jax_computes(op):
    got, want = _both(_c23_call(op))
    _exact(got, want, f"{op} bool")


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "bool"])
@pytest.mark.parametrize("axis", [None, 1])
def test_c23_cumsum_keeps_narrow_integer_dtypes(dtype, axis):
    got, want = _both(lambda m: m.nd.cumsum(_edge(m, dtype), axis=axis))
    _exact(got, want, f"cumsum {dtype}")


@pytest.mark.parametrize("op", ["broadcast_sub", "elemwise_sub", "_minus"])
def test_c23_bool_subtraction_raises_on_both_sides(op):
    for m in (jmx, tmx):
        with m.cpu():
            x = _edge(m, "bool")
            f = getattr(m.nd, op, None) or getattr(m.nd._internal, op)
            with pytest.raises((TypeError, RuntimeError)):
                f(x, x).asnumpy()


# ---------------------------------------------------------- A4.6 names
@pytest.mark.parametrize("name,kwargs", [
    ("poisson", dict(lam=4.0)), ("exponential", dict(scale=2.0)),
    ("gamma", dict(alpha=3.0, beta=0.5)),
    ("negative_binomial", dict(k=3, p=0.4)),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.3))])
def test_a46_random_samplers_are_the_nd_random_ops(name, kwargs):
    """``mx.random.<name>`` draws what ``nd.random.<name>`` draws from
    the same seed, with JAX's shape and dtype, and the mean within 6
    standard errors of the JAX package's draw."""
    shape = (4000,)
    want = getattr(jmx.random, name)(shape=shape, **kwargs).asnumpy()
    with tmx.cpu():
        tmx.random.seed(11)
        got = getattr(tmx.random, name)(shape=shape, **kwargs).asnumpy()
        tmx.random.seed(11)
        op_kw = {"lam": 0.5} if name == "exponential" else kwargs
        op = getattr(tmx.nd.random, name)(shape=shape, **op_kw).asnumpy()
    np.testing.assert_array_equal(got, op)
    assert got.shape == want.shape and got.dtype == want.dtype
    se = np.sqrt(want.var() / shape[0] + got.var() / shape[0])
    assert abs(got.mean() - want.mean()) <= 6 * se


def test_a46_multinomial_and_shuffle():
    probs = np.array([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]], np.float32)
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    for m in (jmx, tmx):
        with m.cpu():
            draw, logp = m.random.multinomial(m.nd.array(probs), shape=5,
                                              get_prob=True)
            mixed = m.random.shuffle(m.nd.array(data)).asnumpy()
        draw = draw.asnumpy()
        assert draw.shape == (2, 5) and draw.dtype == np.int32
        assert (draw[0] == 1).all() and set(draw[1]) <= {0, 2}
        assert logp.shape == (2, 5)
        assert sorted(map(tuple, mixed)) == sorted(map(tuple, data))


def test_a46_autograd_flags_and_get_symbol():
    for m in (jmx, tmx):
        ag = m.autograd
        assert ag.set_recording(True) is False
        assert ag.is_recording()
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.is_training()
        assert ag.set_training(False) is True
        assert not ag.is_recording() and not ag.is_training()
        with pytest.raises(NotImplementedError):
            ag.get_symbol(None)


def test_a46_context_names():
    for m in (jmx, tmx):
        pinned = m.cpu_pinned(1)
        assert (pinned.device_type, pinned.device_id) == ("cpu_pinned", 1)
        assert str(pinned) == "cpu_pinned(1)"
        assert m.num_tpus() == m.num_gpus() == 0
        assert m.num_devices("cpu") >= 1
    assert tmx.num_devices() == 1
    with tmx.cpu_pinned():
        assert tmx.nd.ones((2,)).asnumpy().tolist() == [1.0, 1.0]
