"""The port's ModelServer, DynamicBatcher, ServingConfig and
BlockPredictor on the CPU: the cases of the JAX package's
tests/test_serving.py that apply to the Block backend, plus the slice's
path — a port ResNet-50 v1 (``fuse_block=True``, NHWC) served to
concurrent clients, each result equal to a direct BlockPredictor
forward of the same image.  (The same path against the JAX logits is in
test_torch_resnet.py.)

Tolerance of served vs direct: 1e-5 absolute on O(1) logits — the same
fp32 forward, but at another batch size (the bucket), which may change
oneDNN's summation order."""
import concurrent.futures
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn._modules import Dense
from incubator_mxnet_tpu_torch.predict import BlockPredictor
from incubator_mxnet_tpu_torch.serving import (DeadlineExceededError,
                                               DynamicBatcher, ModelServer,
                                               QueueFullError, Request,
                                               ServerClosedError,
                                               ServingConfig,
                                               WorkerCrashedError,
                                               pow2_buckets)
from torch_port_helpers import fresh_port_telemetry  # noqa: F401


def _dense(seed=0, in_units=12, units=8):
    net = Dense(units, in_units, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        net.weight.normal_(0, 0.3, generator=gen)
        net.bias.normal_(0, 0.1, generator=gen)
    return net


def _server(net=None, **kw):
    net = net if net is not None else _dense()
    kw.setdefault("input_shapes", [(12,)])
    return ModelServer(BlockPredictor(net, device="cpu"), device="cpu", **kw)


# ------------------------------------------------------------- config
def test_config_defaults_and_buckets():
    cfg = ServingConfig(max_batch=32)
    assert cfg.buckets == [1, 2, 4, 8, 16, 32]
    assert pow2_buckets(24) == [1, 2, 4, 8, 16, 24]
    assert [cfg.bucket_for(n) for n in (1, 5, 32)] == [1, 8, 32]
    with pytest.raises(MXNetError):
        cfg.bucket_for(33)
    assert ServingConfig(max_batch=8, buckets=[4, 8, 4, 1]).buckets == \
        [1, 4, 8]


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(linger_us=-1),
                                dict(queue_depth=0),
                                dict(max_batch=8, buckets=[1, 2, 4]),
                                dict(buckets=[0, 32])])
def test_config_validation(kw):
    with pytest.raises(MXNetError):
        ServingConfig(**kw)


def test_config_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "16")
    monkeypatch.setenv("MXNET_SERVING_LINGER_US", "777")
    monkeypatch.setenv("MXNET_SERVING_QUEUE_DEPTH", "9")
    cfg = ServingConfig()
    assert (cfg.max_batch, cfg.linger_us, cfg.queue_depth) == (16, 777, 9)
    assert cfg.buckets[-1] == 16


# ------------------------------------------------------------ batcher
def _req(n=1, deadline=None):
    return Request([np.zeros((n, 3), "float32")], n,
                   concurrent.futures.Future(), deadline=deadline)


def _batcher(**kw):
    kw = dict(dict(max_batch=4, linger_us=0, queue_depth=16), **kw)
    return DynamicBatcher(ServingConfig(**kw))


def test_batcher_coalesces_up_to_max_batch():
    b = _batcher()
    reqs = [_req() for _ in range(6)]
    for r in reqs:
        b.submit(r)
    first, second = b.next_batch(), b.next_batch()
    assert first == reqs[:4] and second == reqs[4:]     # size trigger, FIFO
    assert b.accepted == 6


def test_batcher_keeps_multi_example_requests_whole():
    b = _batcher()
    b.submit(_req(n=3))
    b.submit(_req(n=3))
    assert sum(r.n for r in b.next_batch()) == 3        # 3+3 > 4: not split
    assert sum(r.n for r in b.next_batch()) == 3


def test_batcher_expired_request_never_occupies_a_slot():
    b = _batcher()
    dead, live = _req(deadline=time.perf_counter() - 0.001), _req()
    b.submit(dead)
    b.submit(live)
    assert b.next_batch() == [live]
    assert isinstance(dead.future.exception(), DeadlineExceededError)
    assert b.expired == 1


def test_batcher_skips_cancelled_requests():
    b = _batcher()
    gone, live = _req(), _req()
    b.submit(gone)
    b.submit(live)
    assert gone.future.cancel()
    assert b.next_batch() == [live]
    assert not live.future.cancel()          # popped: running now


def test_batcher_queue_full_fast_reject():
    b = _batcher(queue_depth=2)
    b.submit(_req())
    b.submit(_req())
    with pytest.raises(QueueFullError):
        b.submit(_req())
    assert b.rejected == 1


def test_batcher_close_wakes_and_drains():
    b = _batcher(queue_depth=4)
    b.submit(_req())
    b.close()
    assert len(b.next_batch()) == 1                    # drained after close
    assert b.next_batch() is None                      # then terminal
    with pytest.raises(ServerClosedError):
        b.submit(_req())


# ---------------------------------------------------- the slice's path
def test_concurrent_resnet_serving_matches_direct_forwards():
    """4 threads x 6 single-image submits plus two submit_batch calls
    of 3 against a port ResNet-50 v1 (fuse_block=True, NHWC) on the
    CPU: every result equals a direct forward of the same images."""
    net = vision.resnet50_v1(classes=10, layout="NHWC", thumbnail=True,
                             fuse_block=True, device="cpu", seed=0)
    pred = BlockPredictor(net, device="cpu")
    server = ModelServer(pred, device="cpu", max_batch=4, linger_us=2000,
                         input_shapes=[(16, 16, 3)])
    server.warmup()
    X = np.random.RandomState(0).rand(30, 16, 16, 3).astype(np.float32)
    direct = pred(X).numpy()
    results, errors = {}, []

    def client(i):
        try:
            futs = [server.submit(X[6 * i + j]) for j in range(6)]
            results[i] = np.stack([f.result(timeout=120) for f in futs])
        except Exception as exc:            # pragma: no cover - diagnostics
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    batches = [server.submit_batch(X[24:27]), server.submit_batch(X[27:30])]
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    got = np.concatenate([results[i] for i in range(4)] +
                         [f.result(timeout=120) for f in batches])
    server.close()
    assert not errors, errors
    np.testing.assert_allclose(got, direct, atol=1e-5, rtol=0)
    stats, own = server.stats(), server._counters()
    assert stats["serving.request.count"] == 26 and own["examples"] == 30
    assert 0 < own["mean_fill"] <= 1 and stats["serving.error.count"] == 0
    assert stats["serving.batch.count"] >= 30 // 4 and own["exec_s"] > 0
    assert stats["serving.batch.count"] == own["batches"]


def test_many_clients_lose_no_request_or_count():
    """16 client threads (more than cores) x 20 submits with a short
    switch interval: every future resolves to its own example's output,
    and the counters, updated from client and worker threads, lose no
    update."""
    net = _dense()
    server = _server(net, max_batch=8, linger_us=100)
    X = np.random.RandomState(3).rand(16, 20, 12).astype("float32")
    with torch.inference_mode():
        direct = net(torch.from_numpy(X.reshape(-1, 12))).numpy()
    got = np.zeros((16, 20, 8), np.float32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(i):
            futs = [server.submit(X[i, j]) for j in range(20)]
            for j, f in enumerate(futs):
                got[i, j] = f.result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    server.close()
    np.testing.assert_allclose(got.reshape(-1, 8), direct, rtol=1e-6,
                               atol=1e-7)
    stats, own = server.stats(), server._counters()
    assert stats["serving.request.count"] == own["examples"] == 320
    assert stats["serving.reject.count"] == stats["serving.expire.count"] \
        == stats["serving.error.count"] == 0


# ------------------------------------------------- deadlines and close
def test_server_deadline_expires_queued_work():
    server = _server(max_batch=32, linger_us=300_000)
    x = np.random.RandomState(1).rand(12).astype("float32")
    doomed = server.submit(x, timeout_ms=30)    # expires inside the linger
    live = server.submit(x)
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=60)
    assert live.result(timeout=60).shape == (8,)
    server.close()
    assert server.stats()["serving.expire.count"] == 1


def test_server_close_drains_and_rejects_new_work():
    net = _dense()
    server = _server(net, max_batch=8, linger_us=200_000)
    X = np.random.RandomState(2).rand(20, 12).astype("float32")
    futs = [server.submit(X[i]) for i in range(20)]
    server.close()                              # drain=True default
    assert all(f.done() for f in futs)
    with torch.inference_mode():
        direct = net(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(np.stack([f.result() for f in futs]),
                               direct, rtol=1e-6, atol=1e-7)
    with pytest.raises(ServerClosedError):
        server.submit(X[0])
    server.close()                              # idempotent


def test_server_close_without_drain_fails_pending():
    server = _server(max_batch=64, linger_us=500_000)
    futs = [server.submit(np.zeros(12, "float32")) for _ in range(10)]
    server.close(drain=False)
    assert all(f.done() for f in futs)
    # the worker may have raced a batch out before close; the rest fail
    failed = sum(isinstance(f.exception(timeout=0), ServerClosedError)
                 for f in futs)
    assert failed + sum(f.exception(timeout=0) is None for f in futs) == 10


def test_server_backend_failure_fails_batch_not_loop():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return torch.as_tensor(x)[:, :1]

    server = ModelServer(flaky, device="cpu", max_batch=4, linger_us=0,
                         input_shapes=[(3,)])
    with pytest.raises(RuntimeError, match="boom"):
        server.submit(np.zeros(3, "float32")).result(timeout=60)
    good = server.submit(np.ones(3, "float32"))
    assert good.result(timeout=60).shape == (1,)       # loop survived
    server.close()
    assert server.stats()["serving.error.count"] == 1


def test_worker_crash_fails_pending_and_refuses_new_work():
    """A worker that dies outside the per-batch handler fails what is
    queued with WorkerCrashedError and refuses later submits."""
    gate = threading.Event()

    def stuck(x):
        gate.wait(10)
        return torch.as_tensor(x)

    server = ModelServer(stuck, device="cpu", max_batch=1, linger_us=0,
                         input_shapes=[(3,)])
    first = server.submit(np.zeros(3, "float32"))      # occupies the worker
    time.sleep(0.05)
    pending = server.submit(np.zeros(3, "float32"))

    def broken():
        raise SystemError("batcher bug")

    server._batcher.next_batch = broken
    gate.set()
    assert first.result(timeout=60).shape == (3,)
    with pytest.raises(WorkerCrashedError):
        pending.result(timeout=60)
    with pytest.raises(WorkerCrashedError):
        server.submit(np.zeros(3, "float32"))


# ------------------------------------------------------ submit contract
@pytest.mark.parametrize("call", [
    lambda s: s.submit(np.zeros((5, 12), "float32")),     # example shape
    lambda s: s.submit_batch(np.zeros((5, 12), "float32")),   # > max_batch
    lambda s: s.submit_batch(np.zeros((0, 12), "float32")),   # empty
    lambda s: s.submit(),                                     # no input
    lambda s: s.submit(np.zeros(12), np.zeros(12))])          # two inputs
def test_submit_validation(call):
    server = _server(max_batch=4, linger_us=0)
    with pytest.raises(MXNetError):
        call(server)
    server.close()


def test_warmup_requires_shapes_for_block_backend():
    server = _server(max_batch=4, linger_us=0, input_shapes=None)
    with pytest.raises(MXNetError, match="input_shapes"):
        server.warmup()
    # the first request defines the contract; warmup works afterwards
    server.submit(np.zeros(12, "float32")).result(timeout=60)
    server.warmup()
    server.close()


def test_context_manager():
    with _server(max_batch=4, linger_us=0) as server:
        assert server.submit(np.zeros(12, "float32")).result(
            timeout=60).shape == (8,)
    with pytest.raises(ServerClosedError):
        server.submit(np.zeros(12, "float32"))


def test_server_and_predictor_must_share_a_device():
    def elsewhere(x):
        return x

    elsewhere.device = torch.device("cuda", 0)
    with pytest.raises(MXNetError, match="predictor runs on"):
        ModelServer(elsewhere, device="cpu")


# ------------------------------------------------------ BlockPredictor
def test_block_predictor_eval_and_device_rules():
    net = _dense().train()
    pred = BlockPredictor(net, device="cpu")
    assert not net.training                            # put in eval()
    out = pred(np.zeros((2, 12), "float32"))
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    with pytest.raises(MXNetError, match="parameters are on"):
        BlockPredictor(_dense().to("meta"), device="cpu")
    with pytest.raises(MXNetError, match="takes a parallel.DeviceMesh"):
        BlockPredictor(_dense(), device="cpu", mesh=object())
    # bf16_compute is ported: bf16 copies of the fp32 weights and input,
    # a bf16 output within bf16's rounding of the fp32 one, the module
    # left in eval() with fp32 parameters; the CPU default stays fp32
    net = _dense()
    x = np.random.RandomState(0).rand(3, 12).astype("float32")
    bf16 = BlockPredictor(net, device="cpu", bf16_compute=True)
    got = bf16(x)
    assert bf16.bf16_compute and got.dtype == torch.bfloat16
    assert not net.training and net.weight.dtype == torch.float32
    ref = BlockPredictor(net, device="cpu")(x)
    assert not BlockPredictor(net, device="cpu").bf16_compute
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize("n,batch_size,padded", [
    (5, None, 8), (8, None, 8), (1, None, 1), (3, 4, 4), (10, 4, 4)])
def test_block_predict_pads_to_a_fixed_shape(n, batch_size, padded):
    net = _dense()
    seen = []
    net.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    pred = BlockPredictor(net, device="cpu")
    X = np.random.RandomState(n).rand(n, 12).astype("float32")
    got = pred.predict(X, batch_size=batch_size)
    assert got.shape == (n, 8) and set(seen) == {padded}
    with torch.inference_mode():
        np.testing.assert_allclose(got.numpy(),
                                   net(torch.from_numpy(X)).numpy(),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------- the surface against JAX's
# The same traffic through the JAX package's ModelServer and the port's,
# over a plain callable predictor: the outcomes must be the same.
def _jax_serving():
    from incubator_mxnet_tpu import serving as jserving
    return jserving


def _make(mod, pred, **kw):
    if mod.__name__.startswith("incubator_mxnet_tpu_torch"):
        return mod.ModelServer(pred, device="cpu", **kw)
    return mod.ModelServer(pred, **kw)


def _gated():
    """A predictor that returns 2 * x once ``gate`` is set."""
    gate = threading.Event()

    def pred(x):
        assert gate.wait(10)
        return 2 * x
    return pred, gate


def _outcome(fut, timeout=10):
    try:
        return ("ok", fut.result(timeout=timeout).tolist())
    except Exception as e:      # the outcome is the exception's type
        return (type(e).__name__,)


def _policy_run(mod, policy):
    """One request runs (stuck in the predictor), one waits in the queue
    of depth 1, a third arrives: rejected, or blocked until the gate
    opens; then a fourth with a 50 ms deadline; returns the outcomes and
    the queue depths seen."""
    pred, gate = _gated()
    server = _make(mod, pred, config=mod.ServingConfig(
        max_batch=1, linger_us=0, queue_depth=1, full_policy=policy),
        input_shapes=[(2,)])
    first = server.submit(np.ones(2, "float32"))
    deadline = time.time() + 5
    while server.queue_depth() and time.time() < deadline:
        time.sleep(0.005)                       # the worker took it
    second = server.submit(np.full(2, 2.0, "float32"))
    depths = [server.queue_depth()]
    third, err = [], []

    def submit_third():
        try:
            third.append(server.submit(np.full(2, 3.0, "float32")))
        except Exception as e:   # the outcome is the exception's type
            err.append(type(e).__name__)
    t = threading.Thread(target=submit_third)
    t.start()
    t.join(0.3)
    blocked = t.is_alive()
    late = None
    if policy == "block":
        try:
            server.submit(np.zeros(2, "float32"), timeout_ms=50)
        except Exception as e:   # the outcome is the exception's type
            late = type(e).__name__
    gate.set()
    t.join(10)
    assert not t.is_alive()
    outs = [_outcome(f) for f in [first, second] + third]
    depths.append(server.queue_depth())
    server.close()
    return dict(blocked=blocked, err=err, late=late, outs=outs,
                depths=depths, closed=server._batcher.closed)


@pytest.mark.parametrize("policy", ["reject", "block"])
def test_full_policy_like_jax(policy):
    got = _policy_run(sys.modules["incubator_mxnet_tpu_torch.serving"],
                      policy)
    want = _policy_run(_jax_serving(), policy)
    assert got == want
    assert got["blocked"] == (policy == "block")
    assert got["err"] == ([] if policy == "block" else ["QueueFullError"])
    assert got["closed"] and got["depths"] == [1, 0]
    if policy == "block":
        assert got["late"] == "DeadlineExceededError"
        assert got["outs"][2] == ("ok", [6.0, 6.0])


def test_close_wakes_a_blocked_submitter_like_jax():
    for mod in (sys.modules["incubator_mxnet_tpu_torch.serving"],
                _jax_serving()):
        pred, gate = _gated()
        server = _make(mod, pred, config=mod.ServingConfig(
            max_batch=1, linger_us=0, queue_depth=1, full_policy="block"),
            input_shapes=[(2,)])
        futs = [server.submit(np.ones(2, "float32"))]
        deadline = time.time() + 5
        while server.queue_depth() and time.time() < deadline:
            time.sleep(0.005)
        futs.append(server.submit(np.ones(2, "float32")))
        errs = []

        def blocked():
            try:
                server.submit(np.ones(2, "float32"))
            except Exception as e:   # the outcome is the exception's type
                errs.append(type(e).__name__)
        t = threading.Thread(target=blocked)
        t.start()
        t.join(0.2)
        assert t.is_alive()
        closer = threading.Thread(target=server.close)
        closer.start()
        t.join(5)
        gate.set()
        closer.join(10)
        assert errs == ["ServerClosedError"], mod
        assert [_outcome(f) for f in futs] == [("ok", [2.0, 2.0])] * 2
        assert server._batcher.closed


def test_input_dtypes_in_warmup_like_jax():
    def run(mod):
        seen = []

        def pred(a, b):
            seen.append((a.shape, a.dtype.name, b.shape, b.dtype.name))
            return a.sum(1) + b.sum(1)
        server = _make(mod, pred, max_batch=4, input_shapes=[(3,), (2,)],
                       input_dtypes=["float32", "int32"])
        server.warmup()
        out = server.submit(np.ones(3), np.array([1.7, 2.2])).result(10)
        server.close()
        return seen, float(out)

    got, want = run(sys.modules["incubator_mxnet_tpu_torch.serving"]), \
        run(_jax_serving())
    assert got == want
    assert [s[3] for s in got[0]] == ["int32"] * 4 and got[1] == 6.0


def test_watchdog_counts_a_stall_and_logs_the_stacks(caplog):
    """A predictor that sleeps 0.6 s with requests queued behind it:
    the watchdog (0.1 s) counts a stall and logs every thread's stack,
    the worker's in the predictor included; a fast server counts none."""
    def sleepy(x):
        time.sleep(0.6)
        return x
    with caplog.at_level("ERROR"):
        server = ModelServer(sleepy, device="cpu", config=ServingConfig(
            max_batch=1, linger_us=0, watchdog_s=0.1), input_shapes=[(2,)])
        futs = [server.submit(np.ones(2, "float32")) for _ in range(3)]
        for f in futs:
            f.result(10)
        server.close()
    stalls = server.stats()["serving.watchdog.stall"]
    assert stalls >= 1
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "no progress" in text and "mxnet-serving-worker" in text
    assert "sleepy" in text
    fast = ModelServer(lambda x: x, device="cpu", config=ServingConfig(
        max_batch=2, watchdog_s=0.05), input_shapes=[(2,)])
    for f in [fast.submit(np.ones(2, "float32")) for _ in range(8)]:
        f.result(10)
    time.sleep(0.15)
    fast.close()
    # the registry is the process's: the fast server adds none
    assert fast.stats()["serving.watchdog.stall"] == stalls
    assert fast._counters()["watchdog_stalls"] == 0
    assert not any(t.name == "mxnet-serving-watchdog" and t.is_alive()
                   for t in threading.enumerate())


def test_bf16_outputs_leave_the_server_as_float32():
    def half(x):
        return torch.from_numpy(x).to(torch.bfloat16) * 3
    server = ModelServer(half, device="cpu", max_batch=2,
                         input_shapes=[(2,)])
    out = server.submit(np.array([1.0, 0.5], "float32")).result(10)
    server.close()
    assert out.dtype == np.float32 and out.tolist() == [3.0, 1.5]
