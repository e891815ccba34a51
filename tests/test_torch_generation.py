"""The port's GenerationEngine: greedy output token-identical to the JAX
package's engine on shared weights (the slice end to end on the CPU),
and the engine's own contracts — slot reuse after EOS, deadline expiry,
the queue bound, memory-pressure admission, and sampled decode as a pure
function of (seed, position) inside the port.

Greedy tokens must match exactly: both engines take the argmax of fp32
logits that agree to ~1e-6 (test_torch_decoder.py), and the weights'
spread keeps the top two logits far apart."""
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.serving.generation import \
    GenerationEngine as JaxEngine
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
from incubator_mxnet_tpu_torch.serving import (DeadlineExceededError,
                                               GenerationConfig,
                                               GenerationEngine,
                                               QueueFullError,
                                               ServerClosedError)
from incubator_mxnet_tpu_torch.serving.generation import (_draw_seed,
                                                          _gumbel)
from torch_port_helpers import (SMALL, fresh_port_telemetry,  # noqa: F401
                                jax_decoder, prompts, torch_twin)


def _engine(net=None, **kw):
    net = net if net is not None else TransformerDecoder(device="cpu",
                                                         **SMALL)
    kw.setdefault("max_len", 64)
    return GenerationEngine(net, device="cpu", **kw)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_greedy_token_identical_to_jax_engine(layout):
    """4 concurrent prompts in three buckets (16, 32, 64) on shared
    weights: the port's engine emits exactly the JAX paged engine's
    tokens, on both of its cache layouts."""
    jnet = jax_decoder(seed=0)
    ps = prompts(4, lengths=[3, 14, 25, 50])
    with JaxEngine(jnet, kv_layout="paged", prefix_cache=False, slots=4,
                   max_len=64, max_new_tokens=8) as jeng:
        futs = [jeng.submit(p) for p in ps]
        ref = [f.result(timeout=240) for f in futs]
    with _engine(torch_twin(jnet), kv_layout=layout, slots=4,
                 max_new_tokens=8) as eng:
        futs = [eng.submit(p) for p in ps]
        got = [f.result(timeout=120) for f in futs]
        assert eng.stats()["gen.prefill.count"] == 4
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == np.int32


def test_slot_reuse_after_eos_retirement():
    with _engine(slots=2, max_new_tokens=30) as eng:
        first = int(eng.submit([3, 1, 4], max_new_tokens=1)
                    .result(timeout=60)[0])
        futs = [eng.submit([3, 1, 4], eos_id=first) for _ in range(6)]
        outs = [f.result(timeout=60) for f in futs]
        assert all(o.tolist() == [first] for o in outs)
        assert eng.stats()["gen.retire.eos"] == 6
        assert eng.free_slots() == 2
        # every slot's block back: the prefix cache (on by default)
        # holds the one tail block of [3, 1, 4], which the 6 repeats hit
        assert eng.kv_info()["live"] == 1
        assert eng.kv_info()["prefix"] == {"blocks": 0, "terminals": 1}
        assert eng.stats()["gen.prefix.hit"] == 6
        assert eng.kv_info()["reserved"] == 0


def test_deadline_expiry_frees_mid_generation_slot():
    net = TransformerDecoder(device="cpu", **dict(SMALL, max_len=4096,
                                                   depth=1))
    with _engine(net, slots=1, max_len=4096, prefill_buckets=[8],
                 max_new_tokens=10 ** 6) as eng:
        fut = eng.submit([1, 2, 3], timeout_ms=150)
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(timeout=60)
        assert 0 < len(ei.value.tokens) < 10 ** 6    # it was generating
        assert eng.free_slots() == 1
        assert eng.stats()["gen.retire.deadline"] == 1
        out = eng.submit([1, 2, 3], max_new_tokens=4).result(timeout=60)
        assert len(out) == 4


def test_queue_admission_bound():
    net = TransformerDecoder(device="cpu", **dict(SMALL, max_len=4096,
                                                   depth=1))
    eng = _engine(net, slots=1, max_len=4096, prefill_buckets=[8],
                  max_new_tokens=10 ** 6, queue_depth=2)
    try:
        eng.submit([1, 2])
        deadline = time.time() + 30
        while eng.free_slots() > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.free_slots() == 0
        queued = [eng.submit([1, 2]), eng.submit([1, 2])]
        with pytest.raises(QueueFullError):
            eng.submit([1, 2])
        assert eng.stats()["gen.reject.count"] == 1
    finally:
        eng.close(drain=False)
    for f in queued:
        with pytest.raises(ServerClosedError):
            f.result(timeout=30)


def test_memory_pressure_queues_instead_of_deadlocking():
    """A pool far below dense-equivalent: requests wait for blocks
    (queued_on_memory) and all complete with the tokens they get
    alone."""
    ps = prompts(5, lengths=[12, 9, 15, 4, 11])
    with _engine(slots=4, max_new_tokens=10) as eng:
        alone = [eng.submit(p).result(timeout=60) for p in ps]
    with _engine(slots=4, max_new_tokens=10, num_blocks=4) as eng:
        futs = [eng.submit(p) for p in ps]
        squeezed = [f.result(timeout=60) for f in futs]
        assert eng.stats()["gen.kv.queued_on_memory"] >= 1
    for a, b in zip(alone, squeezed):
        np.testing.assert_array_equal(a, b)


def test_sampling_pure_function_of_seed_and_position():
    """The same sampled request alone and inside a full batch yields the
    same tokens; other seeds diverge; a uint32 seed wraps like JAX's."""
    ps = prompts(6)
    with _engine(slots=3, max_new_tokens=10) as eng:
        alone = eng.submit(ps[0], temperature=0.8, seed=123) \
            .result(timeout=60)
        futs = [eng.submit(p, temperature=0.8,
                           seed=123 if i == 0 else 1000 + i)
                for i, p in enumerate(ps)]
        batched = futs[0].result(timeout=60)
        rest = [f.result(timeout=60) for f in futs[1:]]
        wrapped = eng.submit(ps[0], temperature=0.8, seed=123 + 2 ** 32) \
            .result(timeout=60)
    np.testing.assert_array_equal(alone, batched)
    np.testing.assert_array_equal(alone, wrapped)
    assert any(not np.array_equal(alone[:len(r)], r[:len(alone)])
               for r in rest)
    assert torch.equal(_gumbel(5, 9, 32), _gumbel(5, 9, 32))
    assert not torch.equal(_gumbel(5, 9, 32), _gumbel(5, 10, 32))
    assert 0 <= _draw_seed(2 ** 32 - 1, 2 ** 31) < 2 ** 63


def test_concurrent_submitters_stress():
    """16 client threads (more than cores) submit at once under a short
    switch interval: every request completes with its one-at-a-time
    tokens, and the shared counters lose no update."""
    import sys
    import threading
    ps = prompts(16)
    with _engine(slots=3, max_new_tokens=5) as eng:
        alone = [eng.submit(p).result(timeout=60) for p in ps]
        got = [None] * len(ps)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def client(i):
                got[i] = eng.submit(ps[i]).result(timeout=60)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(ps))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        st = eng.stats()
    for a, b in zip(alone, got):
        np.testing.assert_array_equal(a, b)
    assert st["gen.request.count"] == st["gen.prefill.count"] == 2 * len(ps)
    assert st["gen.token.count"] == 2 * sum(len(a) for a in alone)


def test_stream_and_close_without_drain():
    with _engine(slots=1, max_new_tokens=6) as eng:
        fut = eng.submit([5, 6, 7])
        seen = list(fut.stream(timeout=60))
        assert seen == fut.result(timeout=5).tolist() and len(seen) == 6
    net = TransformerDecoder(device="cpu", **dict(SMALL, max_len=4096,
                                                   depth=1))
    eng = _engine(net, slots=1, max_len=4096, prefill_buckets=[8],
                  max_new_tokens=10 ** 6)
    fut = eng.submit([1, 2, 3])
    time.sleep(0.3)
    eng.close(drain=False)
    with pytest.raises(ServerClosedError) as ei:
        fut.result(timeout=30)
    assert len(ei.value.tokens) > 0
    with pytest.raises(ServerClosedError):
        eng.submit([1])


def test_max_len_retirement_and_prompt_validation():
    net = TransformerDecoder(device="cpu", **dict(SMALL, max_len=16))
    with _engine(net, slots=1, max_len=16, prefill_buckets=[8, 16],
                 max_new_tokens=100) as eng:
        out = eng.submit([1, 2, 3, 4]).result(timeout=60)
        assert len(out) == 16 - 4 + 1
        assert eng.stats()["gen.retire.max_len"] == 1
        for bad in (list(range(1, 17)), [], [1, 32], [-1, 2]):
            with pytest.raises(MXNetError):
                eng.submit(bad)


def test_config_validation():
    # the prefix cache is ported: on by default on the paged layout, as
    # in the JAX engine, and off on the dense one
    assert GenerationConfig(slots=2, max_len=64).prefix_cache is True
    assert GenerationConfig(slots=2, max_len=64,
                            prefix_cache=True).prefix_cache is True
    assert GenerationConfig(slots=2, max_len=64, kv_layout="dense",
                            prefix_cache=True).prefix_cache is False
    with pytest.raises(MXNetError):
        GenerationConfig(slots=2, max_len=64, prefill_buckets=[12])
    with pytest.raises(MXNetError):
        GenerationConfig(slots=2, max_len=64, kv_layout="ragged")
    with pytest.raises(MXNetError):
        GenerationConfig(slots=0, max_len=64)
    cfg = GenerationConfig(slots=8, max_len=1024, block_size=16)
    assert cfg.num_blocks == 8 * 64 + 2
    assert cfg.prefill_buckets == [16, 32, 64, 128, 256, 512, 1024]
    net = TransformerDecoder(device="cpu", **SMALL)
    with pytest.raises(MXNetError, match="position table"):
        GenerationEngine(net, device="cpu", slots=2, max_len=128)
