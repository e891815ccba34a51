"""``mx.rtc`` of the port: ``CudaModule`` over NVRTC (the port of the
JAX package's ``rtc.PallasModule``, TPU kernel B6).

The CUDA path runs only on the card (``chip_smoke.py`` phase
``kernels_rtc``).  Here: the signature parser over the reference's
type table, the launch's argument checks, the named ``MXNetError``
without libnvrtc, and the plain ``mx.nd`` versions of the smoke's user
kernels (``chip_smoke.axpy_plain``, ``row_sum_plain``,
``scale_add_plain``) against the JAX ``PallasModule`` running the same
functions in interpret mode, at the JAX package's own test shape
(8, 128): scale_add exactly (2x is exact, so one rounding either way);
axpy within one fp32 rounding of each of its two steps, eps * (|a x| +
|y + a x|), since XLA's CPU backend contracts y + a x into one fused
multiply-add where the plain version (like the smoke's kernels, built
with --fmad=false) rounds twice; the row sums within relative 1e-5 of
the row's mass (another summation order)."""
import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _build, rtc
from incubator_mxnet_tpu_torch.base import MXNetError

TYPES = {"float": torch.float32, "double": torch.float64,
         "__half": torch.float16, "uint8_t": torch.uint8,
         "int": torch.int32, "int32_t": torch.int32, "int8_t": torch.int8,
         "char": torch.int8, "int64_t": torch.int64}


@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_signature_parses_every_reference_type(ctype):
    params = rtc._parse_signature(
        f"const {ctype} *x, {ctype}* y,{ctype} alpha , {ctype}*,int n")
    assert [(p.const, p.ctype, p.pointer, p.name) for p in params] == [
        (True, ctype, True, "x"), (False, ctype, True, "y"),
        (False, ctype, False, "alpha"), (False, ctype, True, None),
        (False, "int", False, "n")]
    assert params[0].dtype == TYPES[ctype]


@pytest.mark.parametrize("sig", ["const", "float **x", "unsigned int n",
                                 "float x y", "const *x", "float x,",
                                 "size_t n", "float &x"])
def test_bad_signatures_raise(sig):
    with pytest.raises(MXNetError, match="kernel parameter"):
        rtc._parse_signature(sig)


def test_empty_signature_is_no_parameters():
    assert rtc._parse_signature("") == []
    assert rtc._parse_signature(" void ") == []


def _value(sig, arg):
    (p,) = rtc._parse_signature(sig)
    return p.value(arg, torch.device("cpu"), 0)


def test_scalar_arguments_take_their_exact_c_type():
    v = _value("float alpha", 0.1)
    assert type(v) is ctypes.c_float and v.value == np.float32(0.1)
    assert type(_value("double a", 0.1)) is ctypes.c_double
    assert _value("double a", 0.1).value == 0.1
    assert _value("int n", 7).value == 7
    assert _value("int64_t n", 2 ** 40).value == 2 ** 40
    assert _value("char c", -5).value == -5
    assert _value("__half h", 1.5).value == int(
        np.float16(1.5).view(np.uint16))
    assert _value("float a", np.float32(2.0)).value == 2.0


@pytest.mark.parametrize("sig, arg, match", [
    ("int n", 1.5, "integer"),
    ("int n", 2 ** 31, "out of range"),
    ("uint8_t n", -1, "out of range"),
    ("float a", "x", "Python number"),
    ("float a", True, "Python number"),
    ("float *x", 1.0, "NDArray"),
])
def test_bad_scalar_and_pointer_arguments_raise(sig, arg, match):
    with pytest.raises(MXNetError, match=match):
        _value(sig, arg)


def test_pointer_arguments_are_checked():
    with tmx.cpu():
        x = tmx.nd.ones((4,))
        xi = tmx.nd.ones((4,), dtype="int32")
    with pytest.raises(MXNetError, match="float"):
        _value("float *x", xi)
    with pytest.raises(MXNetError, match="takes a Python number"):
        _value("float a", x)
    (p,) = rtc._parse_signature("float *x")
    with pytest.raises(MXNetError, match="is on cpu"):
        p.value(x, torch.device("cuda", 0), 0)
    strided = tmx.nd.NDArray(torch.zeros(4, 3).t())
    with pytest.raises(MXNetError, match="contiguous"):
        p.value(strided, torch.device("cpu"), 0)
    assert p.value(x, torch.device("cpu"), 0).value == x._data.data_ptr()


def test_launch_refuses_a_cpu_context_and_a_wrong_count():
    k = rtc.Kernel(None, "axpy", rtc._parse_signature(chip_smoke.AXPY_SIG))
    with tmx.cpu():
        x, y = tmx.nd.ones((4,)), tmx.nd.ones((4,))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, y, 1.0, 4], tmx.cpu(), (1,), (4,))
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        k.launch([x, y, 1.0], tmx.gpu(0), (1,), (4,))
    with pytest.raises(MXNetError, match="grid_dims"):
        rtc._dims((1, 2, 3, 4), "grid_dims")
    with pytest.raises(MXNetError, match="block_dims"):
        rtc._dims((0,), "block_dims")
    assert rtc._dims(5, "grid_dims") == (5, 1, 1)
    assert k.launches == 0 and rtc.CudaKernel is rtc.Kernel


def test_construction_without_libnvrtc_raises_a_named_error(monkeypatch):
    monkeypatch.setattr(rtc, "_bound", {})
    monkeypatch.setattr(_build.glob, "glob", lambda pattern: [])
    with pytest.raises(MXNetError, match="libnvrtc not found"):
        rtc.CudaModule(chip_smoke.AXPY_SRC)


def test_arch_names_the_real_hopper_target(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i: (9, 0))
    assert rtc._arch(0) == "sm_90a"
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i: (8, 0))
    assert rtc._arch(0) == "sm_80"


# ------------------------------------------------- plain versions vs JAX
SHAPE = (8, 128)


def _jax_kernel(source, name, out_shape):
    return jmx.rtc.PallasModule(source).get_kernel(name, out_shapes=out_shape)


def test_axpy_plain_matches_jax_pallas():
    rs = np.random.RandomState(0)
    x, y = (rs.randn(*SHAPE).astype(np.float32) for _ in range(2))
    k = _jax_kernel("""
def axpy(x_ref, y_ref, o_ref):
    o_ref[...] = y_ref[...] + (-0.1) * x_ref[...]
""", "axpy", SHAPE)
    want = k.launch([jmx.nd.array(x), jmx.nd.array(y)])[0].asnumpy()
    with tmx.cpu():
        got = chip_smoke.axpy_plain(tmx.nd.array(x), tmx.nd.array(y),
                                    -0.1).asnumpy()
    bound = np.finfo(np.float32).eps * (np.abs(-0.1 * x) + np.abs(want))
    assert np.all(np.abs(got - want) <= bound)


def test_scale_add_plain_matches_jax_pallas():
    """o = 2x + y, the JAX package's own rtc test kernel."""
    rs = np.random.RandomState(1)
    x, y = (rs.randn(*SHAPE).astype(np.float32) for _ in range(2))
    k = _jax_kernel("""
def scale_add(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]
""", "scale_add", SHAPE)
    want = k.launch([jmx.nd.array(x), jmx.nd.array(y)])[0].asnumpy()
    with tmx.cpu():
        got = chip_smoke.scale_add_plain(tmx.nd.array(x), tmx.nd.array(y),
                                         2.0).asnumpy()
    np.testing.assert_array_equal(got, want)
    with tmx.cpu():
        wide = chip_smoke.scale_add_plain(
            tmx.nd.array(x, dtype="float64"), tmx.nd.array(y, dtype="float64"),
            2.0)
    assert wide.dtype == np.float64
    np.testing.assert_array_equal(wide.asnumpy(),
                                  2.0 * x.astype(np.float64) + y)


def test_row_sum_plain_matches_jax_pallas():
    rs = np.random.RandomState(2)
    x = rs.randn(*SHAPE).astype(np.float32)
    k = _jax_kernel("""
def row_sum(x_ref, o_ref):
    o_ref[...] = jnp.sum(x_ref[...], axis=1, keepdims=True)
""", "row_sum", (SHAPE[0], 1))
    want = k.launch([jmx.nd.array(x)])[0].asnumpy()[:, 0]
    with tmx.cpu():
        got = chip_smoke.row_sum_plain(tmx.nd.array(x)).asnumpy()
    mass = np.abs(x).sum(axis=1)
    assert np.all(np.abs(got - want) <= chip_smoke.ROW_SUM_RTOL * mass)
    assert chip_smoke.row_sum_shared_bytes(16384) > 48 * 1024
