"""The port's ``recordio`` and ``io`` iterators against the JAX package's,
on the CPU, on the same files and seeded numpy data.

* RecordIO files written by either package are read back by the other,
  and the two writers produce the same bytes (records, split records,
  the ``.idx`` text, ``pack``/``pack_img`` payloads).
* ``NDArrayIter``, ``CSVIter``, ``MNISTIter``, ``ResizeIter``,
  ``PrefetchingIter`` and ``ImageRecordIter`` give the same batches:
  data, labels, pad and index.  ``ImageRecordIter`` runs with OpenCV and
  with ``decoder="python"`` (PIL), in float32 NCHW and uint8 NHWC, with
  and without an ``.idx``, sharded with ``part_index``/``num_parts``,
  and with random crops and mirrors at ``preprocess_threads=1`` (the
  draws come from one RandomState in both packages; with more threads
  their order races, in both).
* The port's batches are host NDArrays.

Tolerance: exact everywhere (the same numpy, OpenCV and PIL operations
on the same bytes).
"""
import os
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio as trec

cv2 = pytest.importorskip("cv2")


def _batches(it, n=None):
    """(data, label, pad, index) of each batch, as numpy; the port's
    arrays must be on the host."""
    out = []
    for i, b in enumerate(it):
        if n is not None and i == n:
            break
        for a in (b.data or []) + (b.label or []):
            if isinstance(a, tmx.nd.NDArray):
                assert a.context == tmx.cpu(), a.context
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in (b.label or [])], b.pad,
                    None if b.index is None else np.asarray(b.index)))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype, \
                (g.shape, g.dtype, w.shape, w.dtype)
            np.testing.assert_array_equal(g, w)
        assert (gp or 0) == (wp or 0)
        if wi is not None:
            np.testing.assert_array_equal(gi, wi)


# ------------------------------------------------------------------ recordio
def _blobs():
    rs = np.random.RandomState(0)
    return [rs.bytes(n) for n in (0, 1, 3, 4, 5, 1023, 65537)] + \
        [b"record_text"]


def _write(mod, path, blobs, indexed=False):
    if indexed:
        rec = mod.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
        for i, b in enumerate(blobs):
            rec.write_idx(i * 3, b)
    else:
        rec = mod.MXRecordIO(path + ".rec", "w")
        for b in blobs:
            rec.write(b)
    rec.close()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_recordio_files_cross_both_ways(tmp_path, writer, reader):
    path = str(tmp_path / "r")
    blobs = _blobs()
    _write(writer, path, blobs)
    rec = reader.MXRecordIO(path + ".rec", "r")
    assert [rec.read() for _ in blobs] == blobs
    assert rec.read() is None
    rec.reset()
    assert rec.read() == blobs[0]
    rec.close()
    _write(writer, path + "i", blobs, indexed=True)
    idx = reader.MXIndexedRecordIO(path + "i.idx", path + "i.rec", "r")
    assert idx.keys == [i * 3 for i in range(len(blobs))]
    for i in reversed(range(len(blobs))):
        assert idx.read_idx(i * 3) == blobs[i]
    idx.close()


def test_recordio_writers_write_the_same_bytes(tmp_path):
    blobs = _blobs()
    for indexed in (False, True):
        _write(jrec, str(tmp_path / "j"), blobs, indexed)
        _write(trec, str(tmp_path / "t"), blobs, indexed)
        for ext in (".rec", ".idx") if indexed else (".rec",):
            with open(tmp_path / ("j" + ext), "rb") as a, \
                    open(tmp_path / ("t" + ext), "rb") as b:
                assert a.read() == b.read(), ext
    raw = open(tmp_path / "t.rec", "rb").read()
    magic, lrec = struct.unpack("<II", raw[:8])
    assert magic == 0xCED7230A and lrec & ((1 << 29) - 1) == 0


def test_recordio_split_records_cross(tmp_path, monkeypatch):
    """A record longer than a chunk is written as first/middle/last
    chunks (cflag 1/2/3) and reassembled, with a small chunk limit."""
    monkeypatch.setattr(trec, "_MAX_CHUNK", 7)
    blob = bytes(range(23))
    path = str(tmp_path / "s.rec")
    rec = trec.MXRecordIO(path, "w")
    rec.write(blob)
    rec.close()
    raw = open(path, "rb").read()
    flags = []
    pos = 0
    while pos < len(raw):
        _, lrec = struct.unpack("<II", raw[pos:pos + 8])
        n = lrec & ((1 << 29) - 1)
        flags.append(lrec >> 29)
        pos += 8 + n + (4 - n % 4) % 4
    assert flags == [1, 2, 2, 3]
    for mod in (jrec, trec):
        assert mod.MXRecordIO(path, "r").read() == blob


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_pack_unpack_match(label):
    header = (0, label, 17, 0)
    got, want = trec.pack(header, b"payload"), jrec.pack(header, b"payload")
    assert got == want
    gh, gs = trec.unpack(got)
    wh, ws = jrec.unpack(want)
    assert gs == ws == b"payload" and gh.flag == wh.flag
    np.testing.assert_array_equal(np.asarray(gh.label), np.asarray(wh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_match(fmt):
    img = (np.random.RandomState(1).rand(20, 24, 3) * 255).astype(np.uint8)
    header = jrec.IRHeader(0, 2.0, 5, 0)
    got, want = trec.pack_img(header, img, img_fmt=fmt), \
        jrec.pack_img(header, img, img_fmt=fmt)
    assert got == want
    (gh, gi), (wh, wi) = trec.unpack_img(got), jrec.unpack_img(want)
    assert gh == wh
    np.testing.assert_array_equal(gi, wi)


# ---------------------------------------------------------------- iterators
def _data(n=17, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 3, 2).astype(np.float32), \
        rs.randint(0, 5, n).astype(np.float32)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(handle, shuffle):
    x, y = _data()

    def run(mod):
        np.random.seed(3)
        it = mod.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                             last_batch_handle=handle)
        out = _batches(it)
        it.reset()
        return out + _batches(it)

    _same(run(tio), run(jio))
    it = tio.NDArrayIter({"a": x, "b": x[:, 0]}, batch_size=4)
    assert [d.name for d in it.provide_data] == ["a", "b"]


def test_csv_iter_matches(tmp_path):
    x, y = _data(11)
    np.savetxt(tmp_path / "d.csv", x.reshape(11, -1), delimiter=",")
    np.savetxt(tmp_path / "l.csv", y, delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(3, 2),
                  label_csv=str(tmp_path / "l.csv"), batch_size=4,
                  round_batch=round_batch)
        _same(_batches(tio.CSVIter(**kw)), _batches(jio.CSVIter(**kw)))


def test_mnist_iter_matches(tmp_path):
    rs = np.random.RandomState(0)
    imgs = (rs.rand(20, 28, 28) * 255).astype(np.uint8)
    lbls = np.arange(20, dtype=np.uint8) % 10
    with open(tmp_path / "img", "wb") as f:
        f.write(struct.pack(">IIII", 0x00000803, 20, 28, 28))
        f.write(imgs.tobytes())
    with open(tmp_path / "lbl", "wb") as f:
        f.write(struct.pack(">II", 0x00000801, 20))
        f.write(lbls.tobytes())
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=4),
               dict(flat=True, shuffle=False)):
        kw = dict(kw, image=str(tmp_path / "img"),
                  label=str(tmp_path / "lbl"), batch_size=6)
        _same(_batches(tio.MNISTIter(**kw)), _batches(jio.MNISTIter(**kw)))


def test_resize_and_prefetching_iters_match():
    x, y = _data(10)

    def run(mod):
        out = _batches(mod.ResizeIter(mod.NDArrayIter(x, y, batch_size=4),
                                      7))
        pf = mod.PrefetchingIter([mod.NDArrayIter(x, y, batch_size=5),
                                  mod.NDArrayIter(x * 2, y, batch_size=5)])
        out += _batches(pf)
        pf.reset()
        return out + _batches(pf)

    _same(run(tio), run(jio))


def test_libsvm_iter_names_its_roadmap_item(tmp_path):
    """LibSVMIter (sparse storage's item of the roadmap, now ported)
    gives the JAX package's CSR batches, a wrapped last batch included."""
    (tmp_path / "d.libsvm").write_text("1 0:1.5 3:2\n0 1:1\n1 2:-1\n")
    got, want = [], []
    for mod, out in ((tio, got), (jio, want)):
        it = mod.LibSVMIter(str(tmp_path / "d.libsvm"), (4,), batch_size=2)
        for b in it:
            out.append((b.data[0].asnumpy(), b.data[0].indptr.asnumpy(),
                        b.label[0].asnumpy(), b.pad))
    assert len(got) == len(want) == 2 and got[1][3] == 1
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------- ImageRecordIter
def _make_rec(tmp_path, n=11, fmt=".jpg", seed=0):
    """n seeded RGB images of varied sizes (some below the crop) packed
    by the JAX package, with an .idx; labels 0..2."""
    prefix = str(tmp_path / f"imgs{fmt}")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rs = np.random.RandomState(seed)
    for i in range(n):
        h, w = (40, 48) if i % 4 else (28, 30)
        img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 3), i, 0),
                                       img, img_fmt=fmt))
    rec.close()
    return prefix


RECORD_CASES = [
    dict(),
    dict(dtype="uint8", layout="NHWC"),
    dict(decoder="python"),
    dict(decoder="python", dtype="uint8", layout="NHWC"),
    dict(rand_crop=True, rand_mirror=True, shuffle=True, seed=5),
    dict(resize=36, mean_r=10.0, mean_g=20.0, mean_b=30.0, std_r=2.0,
         std_g=4.0, std_b=8.0, scale=0.5, layout="NHWC"),
    dict(round_batch=False),
    dict(num_parts=2, part_index=1, no_idx=True),
]


@pytest.mark.parametrize("case", RECORD_CASES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in
                                                c.items()) or "default")
def test_image_record_iter_matches(tmp_path, case):
    case = dict(case)
    prefix = _make_rec(tmp_path)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
              batch_size=4, preprocess_threads=1)
    if not case.pop("no_idx", False):
        kw["path_imgidx"] = prefix + ".idx"
    kw.update(case)

    def run(mod):
        it = mod.ImageRecordIter(**kw)
        out = _batches(it)
        it.reset()
        out += _batches(it)
        it.close()
        return out

    got, want = run(tio), run(jio)
    _same(got, want)
    assert len(got) == 2 * (2 if "num_parts" in kw else
                            (2 if kw.get("round_batch") is False else 3))


def test_image_record_iter_threads_give_the_same_batches(tmp_path):
    """Deterministic crops decode in parallel into the same batches."""
    prefix = _make_rec(tmp_path, n=9)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 24, 24), batch_size=4, dtype="uint8",
              layout="NHWC")
    serial = _batches(tio.ImageRecordIter(preprocess_threads=1, **kw))
    _same(_batches(tio.ImageRecordIter(preprocess_threads=4, **kw)), serial)
    _same(_batches(jio.ImageRecordIter(preprocess_threads=4, **kw)), serial)


def test_image_record_iter_contract(tmp_path):
    prefix = _make_rec(tmp_path, n=4)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 16, 16),
              batch_size=2)
    it = tio.ImageRecordIter(dtype="uint8", layout="NHWC", **kw)
    assert it.provide_data[0].shape == (2, 16, 16, 3)
    assert it.provide_data[0].dtype == np.uint8
    b = next(it)
    assert b.data[0].dtype == np.uint8 and b.label[0].shape == (2,)
    it.close()
    for bad, match in ((dict(dtype="uint8", mean_r=1.0), "uint8"),
                       (dict(dtype="float16"), "dtype"),
                       (dict(layout="HWC"), "layout"),
                       (dict(decoder="turbo"), "decoder")):
        for mod in (tio, jio):
            with pytest.raises(mod.MXNetError if mod is tio
                               else jmx.MXNetError, match=match):
                mod.ImageRecordIter(**dict(kw, **bad))
    assert os.path.exists(prefix + ".idx")
