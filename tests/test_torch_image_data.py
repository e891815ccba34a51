"""The port's ``mx.image``, ``gluon.data`` (datasets, samplers,
``DataLoader``), ``gluon.data.vision`` (datasets over local files,
transforms) and ``gluon.contrib.data`` against the JAX package's, on the
CPU, on the same seeded numpy images and files.

Random augmenters and transforms draw from Python's ``random`` and
``np.random`` in both packages, so each comparison seeds both streams
before each side runs.  The port's samples and batches are host
NDArrays.

Tolerance: exact (the same numpy and OpenCV operations on the same
bytes), except where a float32 value passes through NDArray creation on
one side and numpy on the other: none does here.
"""
import os
import random
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.contrib import data as jcdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf
from incubator_mxnet_tpu_torch import image as timage
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.contrib import data as tcdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf

cv2 = pytest.importorskip("cv2")


def _np(x):
    if isinstance(x, tmx.nd.NDArray):
        assert x.context == tmx.cpu(), x.context
        return x.asnumpy()
    if isinstance(x, jmx.nd.NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _flat(item)]
    return [_np(x)]


def _same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def _seeded(f, seed=0):
    """``f`` run after seeding Python's and numpy's random streams."""
    random.seed(seed)
    np.random.seed(seed)
    return f()


def _img(h=30, w=40, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# ------------------------------------------------------------------ mx.image
def test_decode_and_resize_match(tmp_path):
    img = _img()
    ok, buf = cv2.imencode(".png", img)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    for mod in (timage, jimage):
        assert mod.imdecode(buf.tobytes()).shape == (30, 40, 3)

    def run(m):
        arr = m.imdecode(buf.tobytes())
        gray = m.imdecode(buf.tobytes(), flag=0)
        bgr = m.imdecode(buf.tobytes(), to_rgb=False)
        return [arr, gray, bgr, m.imread(path), m.imresize(arr, 20, 15),
                m.resize_short(arr, 20), m.resize_short(_img(40, 30), 12),
                m.fixed_crop(arr, 3, 4, 10, 8),
                m.fixed_crop(arr, 3, 4, 10, 8, size=(5, 6)),
                m.center_crop(arr, (20, 10))[0],
                m.center_crop(arr, (50, 50))[0],
                m.color_normalize(arr, np.array([1.0, 2.0, 3.0]),
                                  np.array([2.0, 4.0, 8.0]))]

    _same(run(timage), run(jimage))
    with pytest.raises(tmx.MXNetError):
        timage.imdecode(b"not an image")


def test_random_crops_match():
    img = _img()

    def run(m):
        return [m.random_crop(img, (16, 12))[0],
                np.array(m.random_crop(img, (16, 12))[1]),
                m.random_crop(img, (50, 35))[0],
                m.random_size_crop(img, (8, 8), (0.3, 0.8), (0.7, 1.4))[0],
                m.random_size_crop(img, (8, 8), 0.5, (0.7, 1.4))[0]]

    _same(_seeded(lambda: run(timage)), _seeded(lambda: run(jimage)))


AUG_KW = [
    dict(resize=28, rand_crop=True, rand_mirror=True, mean=True, std=True,
         brightness=0.1, contrast=0.1, saturation=0.1, pca_noise=0.05),
    dict(rand_crop=True, rand_resize=True, hue=0.1, rand_gray=0.5),
    dict(mean=np.array([1.0, 2.0, 3.0]), std=np.array([2.0])),
]


@pytest.mark.parametrize("kw", AUG_KW, ids=["jitter", "resize_hue", "norm"])
def test_create_augmenter_matches(kw):
    img = _img(40, 36)

    def run(m):
        augs = m.CreateAugmenter((3, 24, 24), **kw)
        outs = []
        for _ in range(3):
            x = img
            for aug in augs:
                x = aug(x)
            outs.append(x)
        return outs, [a.dumps() for a in augs]

    (got, gd), (want, wd) = _seeded(lambda: run(timage)), \
        _seeded(lambda: run(jimage))
    _same(got, want)
    assert gd == wd


def test_each_augmenter_matches():
    img = _img(40, 36)
    augs = [lambda m: m.ResizeAug(20), lambda m: m.ForceResizeAug((21, 17)),
            lambda m: m.RandomCropAug((20, 20)),
            lambda m: m.RandomSizedCropAug((20, 20), 0.3, (0.75, 1.33)),
            lambda m: m.CenterCropAug((20, 20)),
            lambda m: m.HorizontalFlipAug(1.0),
            lambda m: m.CastAug(), lambda m: m.BrightnessJitterAug(0.3),
            lambda m: m.ContrastJitterAug(0.3),
            lambda m: m.SaturationJitterAug(0.3),
            lambda m: m.HueJitterAug(0.2),
            lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
            lambda m: m.LightingAug(0.1, [55.46, 4.794, 1.148],
                                    np.eye(3) * 0.5),
            lambda m: m.ColorNormalizeAug([1, 2, 3], [3, 2, 1]),
            lambda m: m.RandomGrayAug(1.0),
            lambda m: m.SequentialAug([m.CastAug(), m.RandomGrayAug(1.0)]),
            lambda m: m.RandomOrderAug([m.BrightnessJitterAug(0.2),
                                        m.ContrastJitterAug(0.2)])]
    for make in augs:
        _same(_seeded(lambda: make(timage)(img)),
              _seeded(lambda: make(jimage)(img)))


def _write_images(tmp_path, n=5, size=30):
    files = []
    rs = np.random.RandomState(2)
    for i in range(n):
        img = (rs.rand(size, size + 4, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"im{i}.png"), img)
        files.append(([float(i)], f"im{i}.png"))
    return files


def test_image_iter_matches(tmp_path):
    files = _write_images(tmp_path)
    with open(tmp_path / "list.lst", "w") as f:
        for i, (label, name) in enumerate(files):
            f.write(f"{i}\t{label[0]}\t{name}\n")
    prefix = str(tmp_path / "recs")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(5):
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0),
                                       _img(30, 34, i), img_fmt=".png"))
    rec.close()
    cases = [dict(imglist=files, path_root=str(tmp_path)),
             dict(path_imglist=str(tmp_path / "list.lst"),
                  path_root=str(tmp_path), shuffle=True),
             dict(path_imgrec=prefix + ".rec", rand_crop=True,
                  rand_mirror=True, shuffle=True)]
    for kw in cases:
        def run(m):
            it = m.ImageIter(batch_size=2, data_shape=(3, 24, 24), **kw)
            out = [(b.data[0], b.label[0], np.array(b.pad)) for b in it]
            it.reset()
            return out + [(b.data[0], b.label[0]) for b in it]
        _same(_seeded(lambda: run(timage)), _seeded(lambda: run(jimage)))
    os.remove(prefix + ".idx")       # sequential .rec without an index
    kw = dict(path_imgrec=prefix + ".rec")
    _same(run(timage), run(jimage))


# -------------------------------------------------------------- gluon.data
def test_datasets_and_samplers_match():
    x = np.random.RandomState(0).rand(17, 5).astype("float32")
    y = np.arange(17).astype("float32")

    def run(d):
        ds = d.ArrayDataset(x, y)
        simple = d.SimpleDataset(list(range(10))).transform(lambda v: v * 2)
        first = d.ArrayDataset(x, y).transform_first(lambda v: v + 1)
        eager = d.ArrayDataset(x, y).transform(lambda a, b: (b, a),
                                               lazy=False)
        samplers = [list(d.SequentialSampler(5)), list(d.RandomSampler(9))]
        for last in ("keep", "discard", "rollover"):
            bs = d.BatchSampler(d.SequentialSampler(7), 3, last)
            samplers += [list(bs), list(bs), [len(bs)]]
        return [ds[3], len(ds), simple[4], first[2], eager[5],
                np.array(samplers, dtype=object).tolist()]

    got, want = _seeded(lambda: run(tdata)), _seeded(lambda: run(jdata))
    assert got[-1] == want[-1]
    _same(got[:-1], want[:-1])


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=5, last_batch="discard"),
    dict(batch_size=5, last_batch="rollover", shuffle=True),
    dict(batch_size=3, num_workers=3), dict(batch_size=4, num_workers=2,
                                            shuffle=True, prefetch=1)])
def test_dataloader_matches(kw):
    x = np.arange(60).reshape(20, 3).astype("float32")
    y = np.arange(20).astype("float32")

    def run(d):
        loader = d.DataLoader(d.ArrayDataset(x, y), **kw)
        return [b for b in loader] + [b for b in loader], len(loader)

    (got, gn), (want, wn) = _seeded(lambda: run(tdata)), \
        _seeded(lambda: run(jdata))
    assert gn == wn
    _same(got, want)


def test_dataloader_workers_equal_serial_and_stop_early():
    ds = tdata.ArrayDataset(np.arange(90).reshape(30, 3).astype("float32"))
    serial = [b.asnumpy() for b in tdata.DataLoader(ds, batch_size=4)]
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=3, prefetch=1)
    _same([b for b in loader], serial)
    it = iter(loader)
    next(it)
    it.close()          # the workers finish; nothing is left blocked
    with pytest.raises(ValueError):
        tdata.DataLoader(ds, batch_size=4, sampler=tdata.SequentialSampler(
            30), shuffle=True)


def test_record_file_dataset_matches(tmp_path):
    prefix = str(tmp_path / "r")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(6):
        rec.write_idx(i, f"x{i}".encode())
    rec.close()
    got = tdata.RecordFileDataset(prefix + ".rec")
    want = jdata.RecordFileDataset(prefix + ".rec")
    assert len(got) == len(want) == 6
    assert [got[i] for i in range(6)] == [want[i] for i in range(6)]


# ---------------------------------------------------------- vision datasets
def _idx_file(path, arr, gz=False):
    import gzip
    head = struct.pack(">I", 0x0800 | arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open(path + ".gz", "wb") if gz else open(path, "wb")) as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("cls,gz", [("MNIST", False), ("FashionMNIST", True)])
def test_mnist_datasets_match(tmp_path, cls, gz):
    rs = np.random.RandomState(0)
    for split, n in (("train", 10), ("t10k", 4)):
        _idx_file(str(tmp_path / f"{split}-images-idx3-ubyte"),
                  (rs.rand(n, 28, 28) * 255).astype(np.uint8), gz)
        _idx_file(str(tmp_path / f"{split}-labels-idx1-ubyte"),
                  (np.arange(n) % 10).astype(np.uint8), gz)
    for train in (True, False):
        got = getattr(tdata.vision, cls)(root=str(tmp_path), train=train)
        want = getattr(jdata.vision, cls)(root=str(tmp_path), train=train)
        assert len(got) == len(want)
        _same([got[i] for i in range(len(got))],
              [want[i] for i in range(len(want))])
    with pytest.raises(IOError):
        tdata.vision.MNIST(root=str(tmp_path / "absent"))
    assert not os.path.exists(tmp_path / "absent")


@pytest.mark.parametrize("cls", ["CIFAR10", "CIFAR100"])
def test_cifar_datasets_match(tmp_path, cls):
    rs = np.random.RandomState(1)
    labels = 1 if cls == "CIFAR10" else 2
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)],
             ["test_batch.bin"]) if cls == "CIFAR10" else \
        (["train.bin"], ["test.bin"])
    for name in names[0] + names[1]:
        rec = rs.randint(0, 256, (3, 3072 + labels)).astype(np.uint8)
        rec[:, :labels] %= 10
        (tmp_path / name).write_bytes(rec.tobytes())
    kws = [dict(train=True), dict(train=False)]
    if cls == "CIFAR100":
        kws.append(dict(train=True, fine_label=False))
    for kw in kws:
        got = getattr(tdata.vision, cls)(root=str(tmp_path), **kw)
        want = getattr(jdata.vision, cls)(root=str(tmp_path), **kw)
        _same([got[i] for i in range(len(got))],
              [want[i] for i in range(len(want))])


def test_image_record_and_folder_datasets_match(tmp_path):
    prefix = str(tmp_path / "imgs")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(4):
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 3), i, 0),
                                       _img(20, 24, i), img_fmt=".png"))
    rec.close()
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / cls)
        for i in range(2):
            cv2.imwrite(str(tmp_path / "folder" / cls / f"{i}.png"),
                        _img(16, 18, i + (cls == "dog")))
    (tmp_path / "folder" / "notes.txt").write_text("ignored")

    def run(d, tf):
        recs = d.vision.ImageRecordDataset(prefix + ".rec")
        folder = d.vision.ImageFolderDataset(str(tmp_path / "folder"))
        loader = d.DataLoader(recs.transform_first(tf.ToTensor()),
                              batch_size=3)
        return ([recs[i] for i in range(len(recs))] +
                [folder[i] for i in range(len(folder))] + list(loader),
                folder.synsets)

    with pytest.warns(UserWarning):
        (got, gs) = run(tdata, ttf)
    with pytest.warns(UserWarning):
        (want, ws) = run(jdata, jtf)
    assert gs == ws == ["cat", "dog"]
    _same(got, want)


# -------------------------------------------------------------- transforms
def test_transforms_match():
    img = _img(32, 36)
    pipes = [
        lambda t: t.Compose([t.Resize(28), t.CenterCrop(24),
                             t.RandomFlipLeftRight(), t.ToTensor(),
                             t.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]),
        lambda t: t.Compose([t.Resize((20, 18), keep_ratio=False),
                             t.RandomFlipTopBottom(), t.Cast("float16")]),
        lambda t: t.Resize(20, keep_ratio=True),
        lambda t: t.CenterCrop((40, 40)),
        lambda t: t.RandomResizedCrop(16),
        lambda t: t.RandomResizedCrop((12, 10), scale=(0.9, 1.0),
                                      ratio=(3.0, 4.0)),
        lambda t: t.Compose([t.RandomBrightness(0.3), t.RandomContrast(0.3),
                             t.RandomSaturation(0.3)]),
        lambda t: t.RandomHue(0.2),
        lambda t: t.RandomColorJitter(0.1, 0.2, 0.3, 0.1),
        lambda t: t.RandomLighting(0.1),
        lambda t: t.Compose([t.ToTensor(), t.Normalize(0.5, 0.25)]),
    ]
    for make in pipes:
        got = _seeded(lambda: [make(ttf)(img) for _ in range(3)])
        want = _seeded(lambda: [make(jtf)(img) for _ in range(3)])
        _same(got, want)
    batch = np.stack([img, img[::-1]])
    _same(ttf.ToTensor()(batch), jtf.ToTensor()(batch))


# ---------------------------------------------------------- contrib.data
@pytest.mark.parametrize("rollover", [True, False])
def test_interval_sampler_matches(rollover):
    got = tcdata.IntervalSampler(13, 4, rollover=rollover)
    want = jcdata.IntervalSampler(13, 4, rollover=rollover)
    assert list(got) == list(want) and len(got) == len(want)
    with pytest.raises(ValueError):
        tcdata.IntervalSampler(3, 3)


def test_wikitext_matches(tmp_path):
    rs = np.random.RandomState(0)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"]
    for seg in ("train", "valid"):
        lines = [" ".join(rs.choice(words, rs.randint(0, 9)))
                 for _ in range(30)]
        (tmp_path / f"wiki.{seg}.tokens").write_text("\n".join(lines))
    for cls in ("WikiText2", "WikiText103"):
        got = getattr(tcdata.text, cls)(root=str(tmp_path), seq_len=5)
        want = getattr(jcdata.text, cls)(root=str(tmp_path), seq_len=5)
        assert got.vocabulary.idx_to_token == want.vocabulary.idx_to_token
        _same([got[i] for i in range(len(got))],
              [want[i] for i in range(len(want))])
        val = getattr(tcdata.text, cls)(root=str(tmp_path), segment="valid",
                                        vocab=got.vocabulary, seq_len=5)
        jval = getattr(jcdata.text, cls)(root=str(tmp_path),
                                         segment="valid",
                                         vocab=want.vocabulary, seq_len=5)
        _same([val[i] for i in range(len(val))],
              [jval[i] for i in range(len(jval))])
    with pytest.raises(tmx.MXNetError, match="not found"):
        tcdata.text.WikiText2(root=str(tmp_path / "absent"))
