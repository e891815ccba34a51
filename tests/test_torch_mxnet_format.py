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
    unknown = bytearray(blob)
    struct.pack_into("<i", unknown, 28, 7)      # no such storage type
    with pytest.raises(MXNetError, match="unknown storage type 7"):
        mxnet_format.load(bytes(unknown))
    with pytest.raises(MXNetError, match="save expects"):
        tmx.nd.save(str(tmp_path / "x"), 3)


def test_sparse_records_read_like_jax(tmp_path):
    """A row_sparse and a csr record (storage types 1 and 2, the layout
    of MXNet's ndarray.cc) read by both packages into sparse arrays of
    the same components; the writer stays dense."""
    a = np.zeros((4, 3), np.float32)
    a[1] = [1.5, 0, -2]
    a[3] = [0, 4, 0]
    rows = np.array([1, 3], np.int64)
    indptr = np.array([0, 0, 2, 2, 3], np.int64)
    cols = np.array([0, 2, 1], np.int64)

    def shape(s):
        return struct.pack("<I", len(s)) + struct.pack(f"<{len(s)}q", *s)

    def record(stype, values, aux):
        out = struct.pack("<Ii", 0xF993FAC9, stype) + shape(values.shape)
        out += shape(a.shape) + struct.pack("<iii", 1, 0, 0)
        out += b"".join(struct.pack("<i", 6) for _ in aux)
        out += b"".join(shape(x.shape) for x in aux)
        return out + values.tobytes() + b"".join(x.tobytes() for x in aux)

    blob = struct.pack("<QQQ", 0x112, 0, 2) + record(1, a[rows], [rows]) + \
        record(2, a[a != 0], [indptr, cols]) + struct.pack("<Q", 0)
    path = str(tmp_path / "s.params")
    with open(path, "wb") as f:
        f.write(blob)
    want = jmx.nd.load(path)
    with tmx.cpu():
        got = tmx.nd.load(path)
        assert [g.stype for g in got] == ["row_sparse", "csr"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
            np.testing.assert_array_equal(g.indices.asnumpy(),
                                          w.indices.asnumpy())
        np.testing.assert_array_equal(got[1].indptr.asnumpy(), indptr)
        np.testing.assert_array_equal(got[0].asnumpy(), a)
        tmx.nd.save(str(tmp_path / "d.params"), [got[0].todense()])
    back = jmx.nd.load(str(tmp_path / "d.params"))
    np.testing.assert_array_equal(back[0].asnumpy(), a)
