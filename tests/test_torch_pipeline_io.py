"""The port's ``pipeline_io`` on the CPU: ``DevicePrefetchIter``'s
threaded stage (order and identity, reset, bounded backpressure, early
close, the producer's error, depth 0, stamps), ``MetricDrain`` (depth,
callables, ``MXNET_METRIC_DRAIN_DEPTH``), ``TrainStep.run_steps(drain=)``
and the steps' stamped fast path; and the slice's training path at a
small size: three ``TrainStep`` steps of a small ResNet V1 fed by
``io.ImageRecordIter(dtype="uint8", layout="NHWC")`` through the
prefetcher, normalised on the device by ``uint8_input_prep``, drained,
against the JAX package's ``TrainStep`` on the same batches.  The CUDA
side of the prefetcher (pinned ring, side stream, events) runs only on
the card (``chip_smoke.py`` phase ``data_train``).

Tolerances: the prefetched and drained values exactly (copies); the
three steps against JAX as in tests/test_torch_train.py — every final
parameter and moving statistic within 1e-4 of that tensor's largest
magnitude plus 1e-6, the losses within 1e-4 relative (fp32 on both
sides, ~50 convolutions summed in other orders, compounded over three
updates at lr 0.1).
"""
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BottleneckV1 as JaxBottleneckV1)
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import pipeline_io
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    Dense, SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.io import DataBatch, DataIter
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import (EvalStep, TrainStep,
                                                uint8_input_prep)
from incubator_mxnet_tpu_torch.pipeline_io import (DevicePrefetchIter,
                                                   MetricDrain)
from torch_port_helpers import jax_resnet_of, port_state

cv2 = pytest.importorskip("cv2")

NET = dict(classes=10, thumbnail=True, layout="NHWC", fuse_block="chain")
SPEC = ([1, 2, 1, 1], [16, 32, 64, 128, 256])
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-4
MEAN, SCALE = [123.68, 116.28, 103.53], 1.0 / 58.0


class _CountingIter(DataIter):
    """n fixed host batches; counts next() calls; an optional delay or a
    failure at one batch; the last batch ``ragged`` rows short."""

    def __init__(self, n, delay_s=0.0, fail_at=None, batch_size=4,
                 ragged=0):
        super().__init__(batch_size)
        rs = np.random.RandomState(0)
        self._batches = []
        for i in range(n):
            rows = batch_size - (ragged if i == n - 1 else 0)
            self._batches.append((rs.rand(rows, 6).astype("float32"),
                                  rs.rand(rows, 3).astype("float32")))
        self._n = n
        self._delay = delay_s
        self._fail_at = fail_at
        self.calls = 0
        self._i = 0

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self._n:
            raise StopIteration
        if self._fail_at is not None and self._i == self._fail_at:
            raise RuntimeError("injected decode failure")
        self.calls += 1
        if self._delay:
            time.sleep(self._delay)
        x, y = self._batches[self._i]
        self._i += 1
        return DataBatch(data=[tmx.nd.array(x, ctx=tmx.cpu())],
                         label=[tmx.nd.array(y, ctx=tmx.cpu())])


def _prefetch(src, **kw):
    return DevicePrefetchIter(src, device="cpu", **kw)


def _no_producer():
    return not any(t.name == "mxnet-device-prefetch" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------ device prefetch
def test_prefetch_order_identity_and_stamps():
    ref = [(b.data[0].asnumpy(), b.label[0].asnumpy())
           for b in _CountingIter(5, ragged=1)]
    pf = _prefetch(_CountingIter(5, ragged=1), depth=2)
    got = list(pf)
    assert len(got) == 5
    for (rx, ry), b in zip(ref, got):
        assert b.data[0].context == tmx.cpu()
        np.testing.assert_array_equal(rx, b.data[0].asnumpy())
        np.testing.assert_array_equal(ry, b.label[0].asnumpy())
    stamp, sig = pipeline_io.match_stamp([got[0].data[0], got[0].label[0]])
    assert sig == (((4, 6), "float32"), ((4, 3), "float32"))
    # one stamp per geometry: the ragged last batch mints a fresh one
    stamps = [pipeline_io.match_stamp([b.data[0]])[0] for b in got]
    assert stamps[0] is stamp and len({id(s) for s in stamps[:4]}) == 1
    assert stamps[4] is not stamp and stamps[4].signature[0] == \
        ((3, 6), "float32")
    # mixed stamps, or an unstamped array, match nothing
    assert pipeline_io.match_stamp([got[0].data[0], got[4].label[0]]) == \
        (None, None)
    assert pipeline_io.match_stamp([got[0].data[0], tmx.nd.array(
        ref[0][0], ctx=tmx.cpu())]) == (None, None)
    assert pf.hits + pf.stalls == 5
    with pytest.raises(StopIteration):
        pf.next()
    pf.close()
    assert _no_producer()


def test_prefetch_copies_the_source_batch():
    """A staged batch does not see a later write to the source's array."""
    src = _CountingIter(2)
    first = src._batches[0][0]
    pf = _prefetch(src, depth=1)
    b = pf.next()
    first[:] = -1.0
    assert (b.data[0].asnumpy() != -1.0).all()
    pf.close()


def test_prefetch_reset_replays_and_each_generation_has_its_own_stop():
    src = _CountingIter(6, delay_s=0.001)
    pf = _prefetch(src, depth=2)
    first = [b.data[0].asnumpy() for b in pf]
    pf.reset()
    gen_stop, gen_queue = pf._stop, pf._queue
    pf.next()
    pf.reset()
    assert gen_stop.is_set() and pf._stop is not gen_stop
    assert pf._queue is not gen_queue
    second = [b.data[0].asnumpy() for b in pf]
    assert len(first) == len(second) == 6
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    pf.close()


def test_prefetch_bounded_backpressure():
    """With depth=2 and nothing consumed, at most depth + 1 of the 64
    source batches may be pulled (the queue and the producer's hands)."""
    src = _CountingIter(64)
    pf = _prefetch(src, depth=2)
    deadline = time.time() + 5
    while src.calls < 2 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert src.calls <= 3, src.calls
    pf.next()
    time.sleep(0.2)
    assert src.calls <= 4, src.calls
    pf.close()


def test_prefetch_clean_close_and_producer_error():
    pf = _prefetch(_CountingIter(1000, delay_s=0.001), depth=2)
    pf.next()
    pf.close()
    pf.close()
    assert _no_producer()
    with pytest.raises(tmx.MXNetError, match="closed"):
        pf.next()
    pf = _prefetch(_CountingIter(10, fail_at=2), depth=2)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        for _ in range(10):
            pf.next()
    pf.close()


def test_prefetch_depth_zero_is_passthrough(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    pipeline_io._reset()
    try:
        assert pipeline_io.enabled is False
        src = _CountingIter(3)
        pf = DevicePrefetchIter(src)          # no device resolved: no thread
        assert pf.passthrough and _no_producer()
        b = pf.next()
        assert getattr(b.data[0], "_pipeline_stamp", None) is None
        pf.reset()
        assert len(list(pf)) == 3
    finally:
        monkeypatch.delenv("MXNET_DEVICE_PREFETCH")
        pipeline_io._reset()
    assert pipeline_io.enabled is True


def test_prefetch_refuses_sharding_and_needs_a_gpu_by_default():
    """A mesh sharding is ported (a one-rank mesh stages the whole batch,
    stamped with it, on the mesh's device); anything else is refused."""
    with pytest.raises(tmx.MXNetError, match="Sharding"):
        DevicePrefetchIter(_CountingIter(1), sharding=object())
    sharding = tmx.parallel.make_mesh(dp=1, device="cpu").sharding("dp")
    src = _CountingIter(1)
    pf = DevicePrefetchIter(src, sharding=sharding, depth=1)
    try:
        b = pf.next()
        np.testing.assert_array_equal(b.data[0].asnumpy(),
                                      src._batches[0][0])
        assert b.data[0]._pipeline_stamp[0].sharding == sharding
        assert pf.device == torch.device("cpu")
    finally:
        pf.close()
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError):
            DevicePrefetchIter(_CountingIter(1), depth=1)


def test_device_prefetch_method_wraps_any_iterator():
    it = tio.NDArrayIter(np.arange(12, dtype=np.float32).reshape(6, 2),
                         np.arange(6, dtype=np.float32), batch_size=2)
    pf = it.device_prefetch(device="cpu", depth=1)
    assert isinstance(pf, DevicePrefetchIter)
    assert [b.label[0].asnumpy().tolist() for b in pf] == \
        [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    pf.close()


# ------------------------------------------------------------ MetricDrain
def test_metric_drain_matches_eager_readback():
    vals = [tmx.nd.array(np.full((2,), float(i)), ctx=tmx.cpu())
            for i in range(5)]
    eager = [v.asnumpy() for v in vals]
    drain = MetricDrain(depth=1)
    out = []
    for v in vals:
        out += drain.push(v)
        assert len(drain) <= 1
    out += drain.flush()
    assert len(out) == 5 and len(drain) == 0
    for a, b in zip(eager, out):
        np.testing.assert_array_equal(a, b)


def test_metric_drain_depth_callables_lists_and_env(monkeypatch):
    drain = MetricDrain(depth=3)
    fired = []
    for i in range(3):
        assert drain.push(lambda i=i: fired.append(i)) == []
    assert fired == []
    drain.push(lambda: fired.append(3))
    assert fired == [0]
    drain.flush()
    assert fired == [0, 1, 2, 3]
    pair = (torch.ones(2), torch.zeros(1, dtype=torch.bfloat16))
    out = MetricDrain(depth=0).push(pair)[0]
    assert isinstance(out, tuple) and out[1].dtype == np.float32
    assert MetricDrain(depth=0).push([torch.ones(1), 2.5])[0][1] == 2.5
    monkeypatch.setenv("MXNET_METRIC_DRAIN_DEPTH", "0")
    eager = MetricDrain()
    assert eager.depth == 0
    assert eager.push(tmx.nd.array(np.ones(2), ctx=tmx.cpu()))[0].tolist() \
        == [1.0, 1.0]
    monkeypatch.setenv("MXNET_METRIC_DRAIN_DEPTH", "2")
    assert MetricDrain().depth == 2


def _dense_step():
    net = Dense(3, 6, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        net.weight.normal_(0, 0.3, generator=gen)
        net.bias.zero_()

    def l2(out, y):
        return ((out - y) ** 2).sum(1) / 2
    return net, TrainStep(net, l2, SGD(learning_rate=0.01), device="cpu")


def test_run_steps_drain_defers_the_window():
    _, step = _dense_step()
    drain = MetricDrain(depth=1)
    x, y = np.zeros((4, 6), "float32"), np.zeros((4, 3), "float32")
    assert step.run_steps(x, y, num_steps=2, drain=drain) == []
    second = step.run_steps(x, y, num_steps=2, drain=drain)
    assert len(second) == 1 and second[0].shape == (2,)
    rest = drain.flush()
    assert len(rest) == 1 and rest[0].shape == (2,)


def test_stamped_batches_take_the_resident_fast_path():
    """A prefetched batch goes in as it is (counted); the loss trajectory
    equals the same net fed the host batches."""
    net1, step1 = _dense_step()
    host = [float(step1(b.data[0], b.label[0])) for b in _CountingIter(4)]
    assert step1.resident_fastpath == 0
    net2, step2 = _dense_step()
    pf = _prefetch(_CountingIter(4), depth=2)
    fed = [float(step2(b.data[0], b.label[0])) for b in pf]
    pf.close()
    assert step2.resident_fastpath == 4
    assert host == fed
    ev = EvalStep(net2, device="cpu")
    b = next(iter(_prefetch(_CountingIter(1), depth=1)))
    torch.testing.assert_close(ev(b.data[0]), ev(b.data[0].asnumpy()),
                               rtol=0, atol=0)
    assert ev.resident_fastpath == 1


def test_uint8_input_prep_matches_jax():
    x = (np.random.RandomState(0).rand(2, 4, 5, 3) * 255).astype(np.uint8)
    for layout in ("NHWC", "NCHW"):
        got = uint8_input_prep(MEAN, SCALE, layout)(torch.from_numpy(x))
        want = jparallel.uint8_input_prep(MEAN, SCALE, layout)(
            jmx.nd.array(x)._data)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = torch.ones(2, 3)
    assert uint8_input_prep(MEAN, SCALE)(f) is f


# ---------------------------------------------------- the fed training path
def _records(tmp_path, n=12):
    prefix = str(tmp_path / "train")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rs = np.random.RandomState(7)
    for i in range(n):
        img = (rs.rand(20, 22, 3) * 255).astype(np.uint8)
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 10), i, 0),
                                       img, quality=90))
    rec.close()
    return dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                data_shape=(3, 16, 16), batch_size=4, dtype="uint8",
                layout="NHWC", rand_crop=True, rand_mirror=True,
                shuffle=True, preprocess_threads=1, seed=3)


def test_fed_training_matches_jax(tmp_path):
    kw = _records(tmp_path)
    jnet = jax_resnet_of(JaxBottleneckV1, SPEC, 0, (4, 16, 16, 3), **NET)
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    net.load_state_dict(port_state(jnet))
    jstep = jparallel.TrainStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jmx.optimizer.SGD(**SGD_KW),
        input_prep=jparallel.uint8_input_prep(MEAN, SCALE, "NHWC"))
    jit = jio.ImageRecordIter(**kw)
    want = [float(jstep(b.data[0], b.label[0]).asscalar()) for b in jit]
    jit.close()
    jstep.sync_params()
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                     input_prep=uint8_input_prep(MEAN, SCALE, "NHWC"),
                     device="cpu")
    pf = tio.ImageRecordIter(**kw).device_prefetch(device="cpu", depth=2)
    drain = MetricDrain(depth=1)
    got = []
    for b in pf:
        assert b.data[0].dtype == np.uint8
        got += step.run_steps(b.data[0], b.label[0], num_steps=1,
                              drain=drain)
    got += drain.flush()
    pf.close()
    assert len(want) == 3 and step.resident_fastpath == 3
    got = [float(v[0]) for v in got]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    ref = port_state(jnet)
    for k, t in net.state_dict().items():
        r = ref[k].numpy()
        err = np.abs(t.numpy() - r).max()
        assert err <= STEP_RTOL * np.abs(r).max() + STEP_ATOL, (k, err)
