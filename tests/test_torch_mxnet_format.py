"""``nd.save`` / ``nd.load`` between the two packages.  The port writes
MXNet's binary ``.params`` format and reads it and the JAX package's
own ``.npz`` container, so arrays cross in both directions bit for bit:
every comparison here is exact, dtype included."""
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ndarray import mxnet_format as jax_format
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ndarray import mxnet_format

_RS = np.random.RandomState(3)
ARRAYS = {
    "weight": _RS.randn(5, 7).astype(np.float32),
    "bias": _RS.randn(7).astype(np.float32),
    "steps": np.arange(6, dtype=np.int32).reshape(2, 3),
    "half": _RS.randn(4).astype(np.float16),
    "bytes": _RS.randint(0, 255, (3, 3)).astype(np.uint8),
    "scalar": np.array([3.5], np.float32),
}


def _same(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("as_list", [False, True], ids=["dict", "list"])
def test_jax_save_loads_bit_identical_in_the_port(tmp_path, as_list):
    path = str(tmp_path / "jax.npz")
    data = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in ARRAYS.items()}
    jmx.nd.save(path, list(data.values()) if as_list else data)
    with tmx.cpu():
        back = tmx.nd.load(path)
    if as_list:
        assert isinstance(back, list) and len(back) == len(ARRAYS)
        for got, want in zip(back, ARRAYS.values()):
            _same(got, want)
    else:
        assert sorted(back) == sorted(ARRAYS)
        for k, want in ARRAYS.items():
            _same(back[k], want)
            assert back[k].context == tmx.cpu()


@pytest.mark.parametrize("as_list", [False, True], ids=["dict", "list"])
def test_port_save_loads_bit_identical_in_jax(tmp_path, as_list):
    path = str(tmp_path / "port.params")
    with tmx.cpu():
        data = {k: tmx.nd.array(v, dtype=v.dtype) for k, v in ARRAYS.items()}
        tmx.nd.save(path, list(data.values()) if as_list else data)
    back = jmx.nd.load(path)
    if as_list:
        for got, want in zip(back, ARRAYS.values()):
            _same(got, want)
    else:
        for k, want in ARRAYS.items():
            _same(back[k], want)


def test_reference_binary_written_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref.params")
    jax_format.save(path, {k: jmx.nd.array(v, dtype=v.dtype)
                           for k, v in ARRAYS.items()})
    with tmx.cpu():
        back = tmx.nd.load(path)
    for k, want in ARRAYS.items():
        _same(back[k], want)


def test_port_roundtrip_keeps_float64_and_bytes_equal_jax_writer(tmp_path):
    data = dict(ARRAYS, wide=_RS.randn(3).astype(np.float64))
    p1, p2 = str(tmp_path / "a.params"), str(tmp_path / "b.params")
    with tmx.cpu():
        tmx.nd.save(p1, {k: tmx.nd.array(v, dtype=v.dtype)
                         for k, v in data.items()})
        back = tmx.nd.load(p1)
        single = tmx.nd.array([1.0, 2.0])
        tmx.nd.save(p2, single)
        assert len(tmx.nd.load(p2)) == 1
    for k, want in data.items():
        _same(back[k], want)
    p3 = str(tmp_path / "c.params")
    jax_format.save(p3, {k: jmx.nd.array(v, dtype=v.dtype)
                         for k, v in ARRAYS.items()})
    p4 = str(tmp_path / "d.params")
    with tmx.cpu():
        tmx.nd.save(p4, {k: tmx.nd.array(v, dtype=v.dtype)
                         for k, v in ARRAYS.items()})
    assert open(p3, "rb").read() == open(p4, "rb").read()


def test_bad_files_raise(tmp_path):
    good = str(tmp_path / "g.params")
    with tmx.cpu():
        tmx.nd.save(good, [tmx.nd.ones((4, 4))])
    blob = open(good, "rb").read()
    with pytest.raises(MXNetError, match="truncated"):
        mxnet_format.load(blob[:-9])
    with pytest.raises(MXNetError, match="bad magic"):
        mxnet_format.load_bytes(b"\0" * 32)
    sparse = bytearray(blob)
    struct.pack_into("<i", sparse, 28, 1)       # storage type row_sparse
    with pytest.raises(MXNetError, match="sparse"):
        mxnet_format.load(bytes(sparse))
    with pytest.raises(MXNetError, match="save expects"):
        tmx.nd.save(str(tmp_path / "x"), 3)
