"""The port's telemetry registry (``incubator_mxnet_tpu_torch/
telemetry.py``) against the JAX package's, on the CPU.

The first half is the port's counterpart of ``tests/test_telemetry.py``:
metric semantics, the reservoir bound, thread safety, ``reset``, the
report shapes, the window ring and Prometheus text, the disabled
registry staying at zero, and the enable/disable round trip.  The
second half runs the same small programs on both packages after a
reset of both registries and holds the port's counts to the JAX
package's, exactly: an ``mx.nd`` program (``op.dispatch.count``,
``ndarray.live.*``), a local kvstore push/pull, an ``NDArrayIter``
epoch, three ``TrainStep`` steps, a ``ModelServer`` burst and a paged
generation engine with the prefix cache, speculative decoding and
chunked prefill (the counters both schedules share; histograms by
count).  ``MXNET_TELEMETRY=0`` leaves every metric at zero and
registers no ``gen.*`` entry.
"""
import gc
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import telemetry
from torch_port_helpers import fresh_port_telemetry  # noqa: F401
from torch_port_helpers import jax_decoder, torch_twin


# ----------------------------------------------------------- metric kinds
def test_counter_semantics():
    c = telemetry.counter("t.c")
    assert c.value == 0
    c.inc()
    c.inc(5)
    assert c.value == 6
    assert telemetry.counter("t.c") is c          # get-or-create
    with pytest.raises(tmx.MXNetError):
        telemetry.gauge("t.c")                    # kind mismatch


def test_gauge_semantics_and_async_fold():
    g = telemetry.gauge("t.g")
    g.set(10)
    g.add(-3)
    g.add(1)
    assert g.value == 8
    g.add_async(-2)                               # the finaliser path
    g.add_async(-1)
    assert g.value == 5
    assert len(g._pending) == 0
    # unread, the deque stays bounded: add_async folds it in once
    # _FOLD_AT are pending, unless the lock is held (a finaliser run
    # inside a locked add), where it never waits
    fold = telemetry.Gauge._FOLD_AT
    with g._lock:
        for _ in range(fold + 5):
            g.add_async(1)
        assert len(g._pending) == fold + 5
    for _ in range(2 * fold):
        g.add_async(1)
    assert len(g._pending) < fold
    assert g.value == 5 + 3 * fold + 5


def test_histogram_semantics_and_bounded_reservoir():
    h = telemetry.histogram("t.h")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100 and h.max == 100.0
    assert abs(h.mean - 50.5) < 1e-9
    assert 45 <= h.percentile(50) <= 55
    assert 90 <= h.percentile(95) <= 100
    assert set(h._snapshot()) == {"count", "mean", "p50", "p95", "max"}
    big = telemetry.histogram("t.h.bounded")
    for v in range(3 * telemetry.Histogram._CAP):
        big.observe(float(v))
    assert len(big._buf) == telemetry.Histogram._CAP
    assert big.count == 3 * telemetry.Histogram._CAP


def test_thread_safety_under_concurrent_updates():
    """16 threads (more than cores) with a short switch interval: no
    update of a counter, gauge or histogram is lost."""
    import sys
    c, g, h = (telemetry.counter("t.mt.c"), telemetry.gauge("t.mt.g"),
               telemetry.histogram("t.mt.h"))
    n_threads, per_thread = 16, 500

    def work():
        for i in range(per_thread):
            c.inc()
            g.add(1)
            h.observe(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c.value == g.value == h.count == n_threads * per_thread


def test_reset_zeroes_but_keeps_registration():
    c = telemetry.counter("t.reset")
    c.inc(7)
    telemetry.reset()
    assert c.value == 0
    assert telemetry.get("t.reset") is c


def test_report_shapes_windows_and_prometheus():
    telemetry.counter("t.rep").inc(3)
    telemetry.histogram("t.rep.h").observe(2.0)
    as_dict = telemetry.report(as_dict=True)
    assert as_dict["t.rep"] == 3 and as_dict["t.rep.h"]["count"] == 1
    assert as_dict == telemetry.snapshot()
    text = telemetry.report()
    assert "t.rep" in text and "counter" in text and "enabled" in text
    telemetry._reset_windows()
    telemetry.record_window(now=100.0)
    telemetry.counter("t.rep").inc(4)
    telemetry.record_window(now=102.0)
    (d,) = telemetry.window_deltas()
    assert d["deltas"]["t.rep"] == 4 and d["rates"]["t.rep"] == 2.0
    assert telemetry.rates()["t.rep"] == 2.0
    prom = telemetry.prometheus()
    assert "# TYPE mxnet_t_rep counter\nmxnet_t_rep 7" in prom
    assert 'mxnet_t_rep_h{quantile="0.5"} 2.0' in prom
    assert "mxnet_t_rep_h_count 1" in prom


def test_sampler_records_windows_and_stops():
    telemetry._reset_windows()
    t = telemetry.start_sampler(period_s=0.01)
    try:
        assert telemetry.start_sampler(period_s=0.01) is t   # idempotent
        for _ in range(200):
            if len(telemetry.windows()) >= 3:
                break
            t.join(timeout=0.01)
        assert len(telemetry.windows()) >= 3
    finally:
        telemetry.stop_sampler()
    assert not telemetry.sampler_running() and not t.is_alive()


def test_disabled_stays_zero_and_roundtrips():
    c = telemetry.counter("t.toggle")
    telemetry.disable()
    try:
        assert not telemetry.is_enabled()
        c.inc()
        telemetry.histogram("t.toggle.h").observe(1.0)
        with tmx.cpu():
            (tmx.nd.ones((3,)) + 1).asnumpy()
        snap = telemetry.report(as_dict=True)
        assert c.value == 0 and snap["t.toggle.h"]["count"] == 0
        assert snap.get("op.dispatch.count", 0) == 0
        assert "DISABLED" in telemetry.report()
    finally:
        telemetry.enable()
    c.inc()
    assert c.value == 1


# -------------------------------------------------- parity with the JAX package
def _both(program):
    """``program(m)`` on the JAX package, then on the port on the CPU,
    each after a reset of its own registry; the two snapshots."""
    out = []
    for m in (jmx, tmx):
        gc.collect()
        m.telemetry.reset()
        with m.cpu():
            program(m)
        out.append(m.telemetry.report(as_dict=True))
    return out


def _same(want, got, names):
    assert {n: got.get(n) for n in names} == {n: want.get(n) for n in names}


def test_nd_program_dispatch_and_live_arrays_equal_jax():
    def program(m):
        a = m.nd.ones((4, 4))
        b = m.nd.array(np.arange(16, dtype=np.float32).reshape(4, 4))
        c = m.nd.dot(a + b, a + b)
        d = m.nd.relu(c - 100).reshape((2, 8))
        e = d[1].sum()
        e.asnumpy()
        program.kept = [a, b, c, d]
    want, got = _both(program)
    names = ("op.dispatch.count", "ndarray.live.bytes", "ndarray.live.count")
    _same(want, got, names)
    assert got["op.dispatch.count"] > 0 and got["ndarray.live.count"] >= 4
    del program.kept
    gc.collect()
    assert telemetry.get("ndarray.live.count").value <= 0


def test_kvstore_push_pull_equal_jax():
    def program(m):
        kv = m.kv.create("local")
        kv.init("w", m.nd.ones((4,)))
        kv.init(3, m.nd.ones((2,)))
        m.telemetry.reset()
        kv.push("w", m.nd.ones((4,)))
        kv.push(3, [m.nd.ones((2,)), m.nd.ones((2,))])
        kv.pull("w", out=m.nd.zeros((4,)))
        kv.pull(3, out=m.nd.zeros((2,)))
    want, got = _both(program)
    _same(want, got, ("kvstore.push.count", "kvstore.pull.count"))
    assert got["kvstore.push.count"] == got["kvstore.pull.count"] == 2


def test_ndarray_iter_epoch_equals_jax():
    def program(m):
        data = np.arange(40, dtype=np.float32).reshape(10, 4)
        it = m.io.NDArrayIter(data, np.zeros(10, np.float32), batch_size=3,
                              last_batch_handle="pad")
        m.telemetry.reset()
        assert sum(1 for _ in it) == 4
    want, got = _both(program)
    _same(want, got, ("io.batch.count",))
    assert got["io.batch.count"] == 4


def test_three_train_steps_equal_jax():
    def program(m):
        m.random.seed(0)
        net = m.gluon.nn.Dense(4, in_units=8, prefix="tel_")
        net.initialize()
        kw = {"device": "cpu"} if m is tmx else {}
        step = m.parallel.TrainStep(net, m.gluon.loss.L2Loss(),
                                    m.optimizer.SGD(learning_rate=0.1), **kw)
        x, y = np.ones((2, 8), np.float32), np.ones((2, 4), np.float32)
        m.telemetry.reset()
        for _ in range(3):
            step(x, y).asnumpy()
    want, got = _both(program)
    _same(want, got, ("step.count", "transfer.h2d.bytes"))
    assert got["step.count"] == 3
    assert got["step.dispatch.us"]["count"] == \
        want["step.dispatch.us"]["count"] == 3


def test_model_server_burst_equals_jax():
    """Six single requests one after another, a batch of two, a request
    whose predictor raises, and one refused after close: the serving.*
    counters equal the JAX server's."""
    def program(m):
        def pred(x):
            if float(np.asarray(x).ravel()[0]) < 0:
                raise RuntimeError("negative input")
            return np.asarray(x) * 2
        kw = {"device": "cpu"} if m is tmx else {}
        server = m.serving.ModelServer(pred, max_batch=4, linger_us=0,
                                       input_shapes=[(3,)], **kw)
        for i in range(6):
            server.submit(np.full(3, i, np.float32)).result(timeout=30)
        server.submit_batch(np.ones((2, 3), np.float32)).result(timeout=30)
        with pytest.raises(RuntimeError):
            server.submit(np.full(3, -1, np.float32)).result(timeout=30)
        server.close()
        with pytest.raises(m.serving.ServerClosedError):
            server.submit(np.ones(3, np.float32))
        program.stats[m] = server.stats()
    program.stats = {}
    want, got = _both(program)
    names = [n for n in want if n.startswith("serving.") and
             isinstance(want[n], int) and n != "serving.worker.heartbeat"]
    assert "serving.batch.count" in names
    _same(want, got, names)
    assert got["serving.request.count"] == 8
    assert got["serving.batch.count"] == 7
    assert got["serving.error.count"] == 1
    for h in ("serving.e2e.us", "serving.queue_wait.us",
              "serving.batch_fill.ratio", "serving.exec.us"):
        assert got[h]["count"] == want[h]["count"], h
    # stats() is the serving.* slice, as in JAX
    assert set(program.stats[tmx]) == {n for n in got
                                      if n.startswith("serving.")}
    assert set(program.stats[tmx]) == set(program.stats[jmx])


GEN = dict(slots=2, max_len=64, block_size=8, prefill_buckets=[32],
           max_new_tokens=6, prefill_chunk=8, spec_k=2, spec_draft_layers=1)
#: the gen.* counters the two engines' schedules share
GEN_SHARED = ("gen.request.count", "gen.token.count", "gen.prefill.count",
              "gen.retire.max_tokens", "gen.retire.eos", "gen.prefix.hit",
              "gen.prefix.miss", "gen.prefix.saved_tokens")


def test_generation_engine_counts_equal_jax():
    """Prompts one after another through a paged engine with the prefix
    cache, spec (K=2) and chunked prefill (8): a cold prompt, another,
    the first again (a terminal hit), and one that shares its first
    block (a partial hit).  The counters both schedules share equal the
    JAX engine's, and each histogram holds as many observations."""
    from incubator_mxnet_tpu.serving.generation import \
        GenerationEngine as JaxEngine
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    rs = np.random.RandomState(4)
    first = rs.randint(1, 32, 12).tolist()
    ps = [first, rs.randint(1, 32, 9).tolist(), first,
          first[:8] + rs.randint(1, 32, 5).tolist()]
    jnet = jax_decoder(seed=0)
    tnet = torch_twin(jnet)
    stats = {}
    for m, make in ((jmx, lambda: JaxEngine(jnet, **GEN)),
                    (tmx, lambda: GenerationEngine(tnet, device="cpu",
                                                   **GEN))):
        m.telemetry.reset()
        with make() as eng:
            for p in ps:
                eng.submit(p).result(timeout=240)
            stats[m] = eng.stats()
    want, got = stats[jmx], stats[tmx]
    _same(want, got, GEN_SHARED)
    assert got["gen.request.count"] == 4 and got["gen.prefix.hit"] == 1
    assert got["gen.token.count"] == 4 * GEN["max_new_tokens"]
    for h in ("gen.ttft.us", "gen.e2e.us"):
        assert got[h]["count"] == want[h]["count"] == 4, h
    assert got["gen.prefill.chunk.count"] > 0
    assert got["gen.spec.proposed.count"] == \
        got["gen.spec.accepted.count"] + got["gen.spec.rollback.count"]
    # the slices of this engine's stages, all of them gen.*
    assert {n.split(".")[1] for n in got} >= {"kv", "prefix", "spec"}
    assert all(n.startswith("gen.") for n in got)


def test_disabled_registers_no_generation_metric(monkeypatch):
    """With MXNET_TELEMETRY=0 an engine serves as before, every metric
    stays at zero and no gen.* entry is registered."""
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    monkeypatch.setattr(telemetry, "_metrics", {})
    telemetry.enabled = telemetry._default_enabled()
    assert not telemetry.enabled
    jnet = jax_decoder(seed=0)
    with GenerationEngine(torch_twin(jnet), device="cpu", **GEN) as eng:
        out = eng.submit([3, 4, 5]).result(timeout=120)
        assert eng.stats() == {}
    assert out.shape == (GEN["max_new_tokens"],)
    with tmx.cpu():
        (tmx.nd.ones((2,)) * 3).asnumpy()
    assert all(v == 0 for v in telemetry.report(as_dict=True).values()
               if not isinstance(v, dict))
    assert not any(n.startswith("gen.") for n in telemetry.metrics())
