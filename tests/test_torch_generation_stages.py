"""The generation engine's paged stages in the port — the prefix cache
(on by default), speculative decoding and chunked prefill — and the
decoder hooks and pool primitives under them, held against the JAX
package on the CPU at the tiny decoder of ``torch_port_helpers``
(vocab 32, dim 32, heads 2, depth 2, max_len 64), weights carried by
``torch_twin``.

Tolerances: the decoder hooks' logits, outputs and K/V rows 1e-5 abs
(observed ~2e-6: other summation orders over two fp32 layers); the
pool primitives exact (index moves); engine output token-identical to
the JAX engine in the same configuration (both take the argmax of fp32
logits that agree to ~1e-6).  Inside the port, the spec window's row t
equals the t-th sequential decode step bit for bit, so spec on and off
give identical tokens.  Spec + chunk is held against the port's
chunk-only engine: the JAX package's own composed check passes and
fails in turn (ROADMAP §C, reference caveats)."""
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
import jax.numpy as jnp
from incubator_mxnet_tpu.parallel import paged_attention as jpa
from incubator_mxnet_tpu.serving import generation as jgen
from incubator_mxnet_tpu.serving.generation import \
    GenerationEngine as JaxEngine
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel import paged_attention as tpa
from incubator_mxnet_tpu_torch.serving import (DeadlineExceededError,
                                               GenerationConfig,
                                               GenerationEngine)
from incubator_mxnet_tpu_torch.serving.generation import (_BlockPool,
                                                          _PrefixCache)
from torch_port_helpers import fresh_port_telemetry  # noqa: F401
from torch_port_helpers import SMALL, VOCAB, jax_decoder, prompts, \
    torch_twin

ATOL = 1e-5
T = torch.from_numpy


def _nd(a, dtype=np.float32):
    return mx.nd.array(np.asarray(a, dtype), dtype=dtype)


@pytest.fixture(scope="module")
def nets():
    jnet = jax_decoder(seed=0)
    return jnet, torch_twin(jnet)


def _pools(seed=0, nb=9, bs=16):
    rs = np.random.RandomState(seed)
    shape = (nb, 2, 2, bs, 16)
    return rs.randn(*shape).astype(np.float32), \
        rs.randn(*shape).astype(np.float32)


PT = np.array([[3, 1, 0, 0], [0, 0, 0, 0], [2, 8, 5, 7]], np.int64)
POS = np.array([20, 0, 58], np.int64)


def _close(got, ref, what):
    for g, r in zip(got, ref):
        g = g.detach().numpy()
        assert g.shape == r.shape, what
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0, err_msg=what)


# ------------------------------------------------------------ decoder hooks
def _hook_pair(jnet, tnet, hook):
    """(port outputs, JAX outputs) of one decoder hook on seeded
    inputs."""
    kp, vp = _pools()
    rs = np.random.RandomState(1)
    if hook == "decode_step_paged_partial":
        toks = rs.randint(0, VOCAB, 3)
        ref = jnet.decode_step_paged_partial(
            _nd(toks, np.int32), _nd(POS, np.int32), _nd(kp), _nd(vp),
            _nd(PT, np.int32), 1)
        got = tnet.decode_step_paged_partial(T(toks), T(POS), T(kp), T(vp),
                                             T(PT), 1)
    elif hook == "decode_step_paged_window":
        toks = rs.randint(0, VOCAB, (3, 4))
        ref = jnet.decode_step_paged_window(
            _nd(toks, np.int32), _nd(POS, np.int32), _nd(kp), _nd(vp),
            _nd(PT, np.int32))
        got = tnet.decode_step_paged_window(T(toks), T(POS), T(kp), T(vp),
                                            T(PT))
    elif hook == "prefill_chunk":
        toks = np.zeros((1, 16), np.int64)
        toks[0, :10] = rs.randint(1, VOCAB, 10)
        pt = PT[2:3]
        ref = jnet.prefill_chunk(_nd(toks, np.int32), _nd(32, np.int32),
                                 _nd(42, np.int32), _nd(kp), _nd(vp),
                                 _nd(pt, np.int32))
        got = tnet.prefill_chunk(T(toks), 32, 42, T(kp), T(vp), T(pt))
    else:
        x = rs.randn(*((1, 16, 32) if hook == "forward_window"
                       else (3, 4, 32))).astype(np.float32)
        kc = tpa.gather_layer_blocks(T(kp), T(PT), 1)
        vc = tpa.gather_layer_blocks(T(vp), T(PT), 1)
        jlayer, tlayer = jnet.layers[1], tnet.layers[1]
        if hook == "forward_window":
            ref = jlayer.forward_window(_nd(x), _nd(kc[2:3].numpy()),
                                        _nd(vc[2:3].numpy()),
                                        _nd(40, np.int32))
            got = tlayer.forward_window(T(x), kc[2:3], vc[2:3], 40)
        else:
            ref = jlayer.forward_step_window(_nd(x), _nd(kc.numpy()),
                                             _nd(vc.numpy()),
                                             _nd(POS, np.int32))
            got = tlayer.forward_step_window(T(x), kc, vc, T(POS))
    return got, [r.asnumpy() for r in ref]


@pytest.mark.parametrize("hook", [
    "decode_step_paged_partial", "decode_step_paged_window",
    "prefill_chunk", "forward_window", "forward_step_window"])
def test_decoder_hook_matches_jax(nets, hook):
    jnet, tnet = nets
    with torch.inference_mode():
        got, ref = _hook_pair(jnet, tnet, hook)
    _close(got, ref, hook)


def test_window_rows_equal_sequential_decode_steps_bit_for_bit(nets):
    """Row t of the verify window (logits, K/V) equals the t-th
    sequential ``decode_step_paged``, each step's rows written first —
    the row-count-invariant window; positions past max_len clamp."""
    _, tnet = nets
    kp, vp = _pools(3)
    pos = np.array([20, 0, 61], np.int64)
    toks = np.random.RandomState(4).randint(0, VOCAB, (3, 5))
    with torch.inference_mode():
        lw, kw, vw = tnet.decode_step_paged_window(T(toks), T(pos), T(kp),
                                                   T(vp), T(PT))
        kk, vv = T(kp.copy()), T(vp.copy())
        for t in range(5):
            lg, kn, vn = tnet.decode_step_paged(T(toks[:, t].copy()),
                                                T(pos + t), kk, vv, T(PT))
            tpa.write_token_rows(kk, T(PT), T(pos + t), kn, 16, limit=64)
            tpa.write_token_rows(vv, T(PT), T(pos + t), vn, 16, limit=64)
            rows = [0, 1] if t >= 3 else [0, 1, 2]   # slot 2 passes 64
            assert torch.equal(lw[rows, t], lg[rows]), t
            assert torch.equal(kw[rows, t], kn[rows]), t
            assert torch.equal(vw[rows, t], vn[rows]), t


# ------------------------------------------------------------ pool primitives
@pytest.mark.parametrize("limit,layers", [(None, None), (64, None),
                                          (None, 1), (64, 1), (30, 2)])
def test_write_token_rows_limit_and_layers_exact(limit, layers):
    kp, _ = _pools(5)
    rows = np.random.RandomState(6).randn(3, layers or 2, 2, 16) \
        .astype(np.float32)
    pos = np.array([63, 5, 64 if limit else 33], np.int64)
    ref = np.asarray(jpa.write_token_rows(
        jnp.asarray(kp), jnp.asarray(PT, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(rows), 16, limit=limit,
        layers=layers))
    pool = T(kp.copy())
    tpa.write_token_rows(pool, T(PT), T(pos), T(rows), 16, limit=limit,
                         layers=layers)
    np.testing.assert_array_equal(pool.numpy(), ref)


def test_copy_blocks_exact_against_jax():
    kp, _ = _pools(7)
    dst, src = np.array([4, 0, 6]), np.array([3, 0, 8])
    ref = np.asarray(jpa.copy_blocks(jnp.asarray(kp), jnp.asarray(dst),
                                     jnp.asarray(src)))
    pool = T(kp.copy())
    tpa.copy_blocks(pool, T(dst), T(src))
    np.testing.assert_array_equal(pool.numpy(), ref)


# ------------------------------------------------------------ pool + cache
def test_block_pool_refcounts_release_to_zero():
    pool = _BlockPool(4)
    a = pool.alloc()
    assert pool.ref[a] == 1 and pool.free_count() == 2
    pool.retain(a)
    pool.release(a)
    assert pool.ref[a] == 1 and pool.free_count() == 2
    pool.release(a)
    assert pool.ref[a] == 0 and pool.free_count() == 3
    assert pool.live_count() == 0
    with pytest.raises(MXNetError):
        [pool.alloc() for _ in range(5)]


def test_prefix_chain_hashes_equal_jax():
    """The same chain hashes over the int32 prompt bytes, seeded with
    b"gen-prefix-v1", as the JAX cache computes."""
    p = np.random.RandomState(8).randint(0, VOCAB, 53)
    want = jgen._PrefixCache(jgen._BlockPool(4), 16) \
        .chain_hashes(p.astype(np.int32))
    got = _PrefixCache(_BlockPool(4), 16).chain_hashes(p.astype(np.int64))
    assert got == want and len(got) == 3


# ------------------------------------------------------------ engines
def _run(eng, ps, stagger=False, **kw):
    futs = []
    for i, p in enumerate(ps):
        futs.append(eng.submit(p, **kw))
        if stagger:
            time.sleep(0.002 * (i % 3))
    return [f.result(timeout=240) for f in futs]


def _jax(jnet, ps, stagger=False, sequential=False, **kw):
    with JaxEngine(jnet, **kw) as eng:
        if sequential:
            return [_run(eng, [p])[0] for p in ps], eng
        return _run(eng, ps, stagger), eng


def _port(tnet, **kw):
    return GenerationEngine(tnet, device="cpu", **kw)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_terminal_prefix_hit_skips_prefill_like_jax(nets):
    """Cold, warm, warm: the repeats run no prefill and match the cold
    output, the JAX engine's tokens, and (copy-on-write) each other."""
    jnet, tnet = nets
    prompt = [7, 3, 9, 2, 6, 1]
    kw = dict(slots=2, max_len=64, prefill_buckets=[16], max_new_tokens=8)
    want, _ = _jax(jnet, [prompt] * 3, sequential=True, **kw)
    with _port(tnet, **kw) as eng:
        got = [eng.submit(prompt).result(timeout=120)]
        assert eng.stats()["gen.prefill.count"] == 1
        assert eng.stats()["gen.prefix.miss"] == 1
        got += [eng.submit(prompt).result(timeout=120) for _ in range(2)]
        st = eng.stats()
    _equal(got, want)
    assert st["gen.prefill.count"] == 1 and st["gen.prefix.hit"] == 2
    assert st["gen.prefix.saved_tokens"] == 2 * len(prompt)
    assert st["gen.kv.cow.count"] >= 2


def test_shared_full_block_dedup_like_jax(nets):
    jnet, tnet = nets
    head = list(range(1, 17))              # one full 16-row block
    ps = [head + [20, 21], head + [25]]
    kw = dict(slots=2, max_len=64, prefill_buckets=[32], block_size=16,
              max_new_tokens=6)
    want, jeng = _jax(jnet, ps, sequential=True, **kw)
    with _port(tnet, **kw) as eng:
        got = [eng.submit(p).result(timeout=120) for p in ps]
        info = eng.kv_info()
    _equal(got, want)
    assert info["prefix"] == {"blocks": 1, "terminals": 2}, info
    assert info["live"] == 3 and info["reserved"] == 0, info


def test_refcounts_back_to_zero_after_release(nets):
    """A retired engine holds only prefix-cache refs; evicting them all
    returns every block, and every refcount is 0."""
    _, tnet = nets
    with _port(tnet, slots=2, max_len=64, prefill_buckets=[32],
               block_size=16, max_new_tokens=4) as eng:
        _run(eng, [list(range(1, 20)), list(range(1, 17)) + [9], [1, 2]])
        info = eng.kv_info()
        # one shared full block + three tails
        assert info["live"] == 4 and info["prefix"]["blocks"] == 1, info
        pool = eng._pool
        assert pool.ref.sum() == 4 and pool.reserved == 0
        assert eng._prefix.evict(pool.num_blocks) == 4
        assert pool.live_count() == 0 and not pool.ref.any()


def test_memory_pressure_evicts_without_deadlock_like_jax(nets):
    jnet, tnet = nets
    ps = prompts(6, seed=7)
    kw = dict(slots=3, max_len=64, prefill_buckets=[16], block_size=16,
              num_blocks=4, max_new_tokens=10)
    want, _ = _jax(jnet, ps, **kw)
    with _port(tnet, **kw) as eng:
        got = _run(eng, ps)
        st, info = eng.stats(), eng.kv_info()
    _equal(got, want)
    # admission queued, and dropped cold entries to make room
    assert st["gen.kv.queued_on_memory"] > 0
    assert info["prefix"]["terminals"] < len(ps)
    assert info["live"] + info["free"] == 3 and info["reserved"] == 0


@pytest.mark.parametrize("again", ["terminal", "lead"])
def test_eviction_keeps_the_readmitted_prompts_own_blocks(nets, again):
    """Under pressure the eviction walks through to the very entries the
    admitted prompt maps (its terminal, or its warm lead run): those
    blocks are pinned first, so the free list never holds a block with
    a refcount and no block is handed out twice; the prompt waits for
    the running request instead.  Tokens equal the JAX engine without
    the cache (the JAX engine's admission retains its entries only
    after it evicts, so its cached run would not)."""
    jnet, tnet = nets
    p = list(range(1, 21))                   # one full block + 4-row tail
    r = list(range(31, 15, -1))              # one full block, no tail
    q = p if again == "terminal" else p[:16] + [9, 8, 7, 6]
    kw = dict(slots=2, max_len=64, prefill_buckets=[32], block_size=16,
              num_blocks=8)
    want = []
    with JaxEngine(jnet, prefix_cache=False, **kw) as jeng:
        want += _run(jeng, [p], max_new_tokens=4)
        want += [jeng.submit(r, max_new_tokens=40),
                 jeng.submit(q, max_new_tokens=28)]
        want[1:] = [f.result(timeout=240) for f in want[1:]]
    bad = []
    with _port(tnet, **kw) as eng:
        pool = eng._pool
        alloc, retain = pool.alloc, pool.retain

        def checked_alloc():
            bad.extend(b for b in pool._free if pool.ref[b] > 0)
            return alloc()

        def checked_retain(b):
            if b in pool._free:
                bad.append(b)
            retain(b)

        pool.alloc, pool.retain = checked_alloc, checked_retain
        got = _run(eng, [p], max_new_tokens=4)
        got += [eng.submit(r, max_new_tokens=40),
                eng.submit(q, max_new_tokens=28)]
        got[1:] = [f.result(timeout=240) for f in got[1:]]
        st = eng.stats()
        bad.extend(b for b in pool._free if pool.ref[b] > 0)
        assert pool.reserved == 0
    assert not bad, bad
    _equal(got, want)
    # the pinned blocks freed nothing: the prompt waited for R instead
    assert st["gen.kv.queued_on_memory"] > 0


def test_copy_on_write_of_a_shared_tail_like_jax(nets):
    """Two slots decode off one cached tail block at once: each copies
    it before its first write (as the cold request did, its tail shared
    with the cache since registration), so both match the JAX
    engine."""
    jnet, tnet = nets
    prompt = list(range(3, 23))             # one full block + 4-row tail
    kw = dict(slots=3, max_len=64, prefill_buckets=[32], block_size=16,
              max_new_tokens=9)
    want, _ = _jax(jnet, [prompt], **kw)
    with _port(tnet, **kw) as eng:
        got = [eng.submit(prompt).result(timeout=120)]
        got += _run(eng, [prompt, prompt])
        st = eng.stats()
    _equal(got, want * 3)
    assert st["gen.prefix.hit"] == 2 and st["gen.kv.cow.count"] == 3


SPEC = dict(slots=3, max_len=64, prefill_buckets=[16], max_new_tokens=12)


def test_spec_greedy_matches_jax_and_plain_with_rollback(nets):
    """8 staggered prompts with spec on (K=2, a 1-layer draft): the
    tokens equal the JAX spec engine's and the port's plain engine's,
    proposals were mostly rolled back, and every proposal is counted
    once."""
    jnet, tnet = nets
    ps = prompts(8)
    want, _ = _jax(jnet, ps, stagger=True, spec_k=2, spec_draft_layers=1,
                   **SPEC)
    with _port(tnet, **SPEC) as plain:
        base = _run(plain, ps)
    with _port(tnet, spec_k=2, spec_draft_layers=1, **SPEC) as eng:
        eng.warmup()
        got = _run(eng, ps, stagger=True)
        st = eng.stats()
    _equal(got, want)
    _equal(got, base)
    assert st["gen.spec.proposed.count"] > 0 and st["gen.spec.rollback.count"] > 0
    assert st["gen.spec.proposed.count"] == st["gen.spec.accepted.count"] + st["gen.spec.rollback.count"]


def test_spec_sampled_pure_function_of_seed_and_position(nets):
    _, tnet = nets
    probe = [3, 1, 4, 1, 5]
    kw = dict(temperature=0.8, seed=123, max_new_tokens=10)
    cfg = dict(slots=3, max_len=64, prefill_buckets=[8], spec_k=3,
               spec_draft_layers=1, prefix_cache=False)
    with _port(tnet, **cfg) as eng:
        alone = eng.submit(probe, **kw).result(timeout=120)
        noise = [eng.submit(p, temperature=0.5, seed=i)
                 for i, p in enumerate(prompts(4, seed=2,
                                               lengths=[3, 7, 5, 8]))]
        crowded = eng.submit(probe, **kw).result(timeout=120)
        [f.result(timeout=120) for f in noise]
        assert eng.stats()["gen.spec.proposed.count"] > 0
    with _port(tnet, **cfg) as eng:
        fresh = eng.submit(probe, **kw).result(timeout=120)
    np.testing.assert_array_equal(alone, crowded)
    np.testing.assert_array_equal(alone, fresh)


CHUNK = dict(slots=3, max_len=64, prefill_buckets=[32], block_size=8,
             max_new_tokens=8, prefill_chunk=8)


def test_chunked_prefill_matches_jax(nets):
    jnet, tnet = nets
    ps = prompts(6, seed=7, lengths=[10, 29, 3, 17, 24, 8])
    want, _ = _jax(jnet, ps, stagger=True, **CHUNK)
    with _port(tnet, **CHUNK) as eng:
        eng.warmup()
        got = _run(eng, ps, stagger=True)
        st = eng.stats()
    _equal(got, want)
    assert st["gen.prefill.chunk.count"] == sum(-(-len(p) // 8) for p in ps)
    assert st["gen.prefill.count"] == len(ps)


def test_partial_prefix_hit_fills_only_tail_chunks_like_jax(nets):
    jnet, tnet = nets
    shared = list(range(1, 17))             # two full 8-row blocks
    p_cold = shared + [20, 21, 22, 23, 24, 25, 26, 27]
    p_warm = shared + [28, 29, 30, 31, 1, 2, 3, 4]
    kw = dict(CHUNK, slots=2, max_new_tokens=6)
    want, _ = _jax(jnet, [p_cold, p_warm], sequential=True, **kw)
    with _port(tnet, **kw) as eng:
        got = [eng.submit(p_cold).result(timeout=120)]
        s0 = eng.stats()
        assert s0["gen.prefill.chunk.count"] == len(p_cold) // 8
        got.append(eng.submit(p_warm).result(timeout=120))
        s1 = eng.stats()
    _equal(got, want)
    assert s1["gen.prefill.chunk.count"] - s0["gen.prefill.chunk.count"] == 1
    assert s1["gen.prefix.saved_tokens"] - s0["gen.prefix.saved_tokens"] == 16


def test_spec_with_chunks_equals_the_chunk_only_engine(nets):
    _, tnet = nets
    ps = prompts(8, seed=7, lengths=[10, 29, 12, 17, 24, 11, 28, 15])
    with _port(tnet, **CHUNK) as eng:
        want = _run(eng, ps)
    with _port(tnet, spec_k=3, spec_draft_layers=1, **CHUNK) as eng:
        got = _run(eng, ps, stagger=True)
        st = eng.stats()
    _equal(got, want)
    assert st["gen.prefill.chunk.count"] > 0 and st["gen.spec.proposed.count"] > 0


def test_deadline_mid_chunk_retires_and_frees_blocks():
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    net = TransformerDecoder(device="cpu", **dict(SMALL, max_len=512))
    with _port(net, slots=1, max_len=512, prefill_buckets=[512],
               block_size=8, max_new_tokens=4, prefill_chunk=8,
               prefix_cache=False) as eng:
        eng.submit([1, 2, 3]).result(timeout=120)
        fut = eng.submit([5] * 480, timeout_ms=10)
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(timeout=120)
        assert len(ei.value.tokens) == 0
        st = eng.stats()
        assert st["gen.retire.deadline"] == 1 and st["gen.prefill.count"] == 1
        assert st["gen.prefill.chunk.count"] < 1 + 480 // 8
        assert eng.live_blocks() == 0
        assert len(eng.submit([1, 2, 3]).result(timeout=120)) == 4


def test_accessors_equal_jax_after_the_same_traffic(nets):
    jnet, tnet = nets
    ps = prompts(4, lengths=[20, 5, 33, 17])
    kw = dict(slots=2, max_len=64, prefill_buckets=[64], block_size=16,
              max_new_tokens=5)
    _, jeng = _jax(jnet, ps, sequential=True, **kw)
    with _port(tnet, **kw) as eng:
        for p in ps:
            _run(eng, [p])
        got = (eng.queue_depth(), eng.free_blocks(), eng.live_blocks(),
               eng.cache_info())
    want = (jeng.queue_depth(), jeng.free_blocks(), jeng.live_blocks(),
            jeng.cache_info())
    assert got[:3] == want[:3]
    for key in ("bytes", "shape", "layout"):
        assert got[3][key] == want[3][key], key
    assert got[3]["devices"] == ["cpu"]
    with _port(tnet, slots=2, max_len=64, kv_layout="dense") as dense:
        assert dense.free_blocks() is None and dense.live_blocks() is None
        assert dense.queue_depth() == 0


# ------------------------------------------------------------ configuration
def test_config_validation_like_jax(nets):
    _, tnet = nets
    kw = dict(slots=2, max_len=64, prefill_buckets=[16])
    for knobs in (dict(), dict(spec_k=3, prefill_chunk=20),
                  dict(kv_layout="dense", spec_k=3, prefill_chunk=16,
                       prefix_cache=True),
                  dict(prefill_chunk=3), dict(prefill_chunk=1000),
                  dict(spec_k=2, spec_draft_layers=0)):
        got = GenerationConfig(**kw, **knobs)
        want = jgen.GenerationConfig(**kw, **knobs)
        for key in ("prefix_cache", "spec_k", "spec_draft_layers",
                    "prefill_chunk", "num_blocks", "block_size"):
            assert getattr(got, key) == getattr(want, key), (knobs, key)
        for L, new in ((20, 10), (16, 40), (3, 100)):
            if got.kv_layout == "paged":
                assert got.worst_blocks(L, new) == \
                    want.worst_blocks(L, new)
    with pytest.raises(MXNetError, match="spec_draft_layers"):
        _port(tnet, spec_k=2, spec_draft_layers=2, **kw)


@pytest.mark.parametrize("env,key,value", [
    ("MXNET_GEN_PREFIX_CACHE", "prefix_cache", False),
    ("MXNET_GEN_SPEC_K", "spec_k", 2),
    ("MXNET_GEN_PREFILL_CHUNK", "prefill_chunk", 8)])
def test_env_switches(nets, monkeypatch, env, key, value):
    """Each switch feeds the engine's default as in the JAX engine;
    MXNET_GEN_PREFIX_CACHE=0 wins over ``prefix_cache=True``, and the
    engine then prefills a repeated prompt again."""
    _, tnet = nets
    monkeypatch.setenv(env, str(int(value)))
    kw = dict(slots=2, max_len=64, prefill_buckets=[16], block_size=8,
              max_new_tokens=4)
    assert getattr(GenerationConfig(**kw), key) == value
    if key == "prefix_cache":
        assert GenerationConfig(prefix_cache=True, **kw).prefix_cache \
            is False
    with _port(tnet, **kw) as eng:
        a = eng.submit([1, 2, 3, 4, 5]).result(timeout=120)
        b = eng.submit([1, 2, 3, 4, 5]).result(timeout=120)
        st = eng.stats()
    np.testing.assert_array_equal(a, b)
    if key == "prefix_cache":
        # the prefix slice counts nothing (an earlier test of the
        # process may have registered it)
        assert st["gen.prefill.count"] == 2
        assert st.get("gen.prefix.hit", 0) == 0
    elif key == "spec_k":
        assert st["gen.spec.proposed.count"] > 0
    else:
        assert st["gen.prefill.chunk.count"] > 0
    monkeypatch.delenv(env)
    assert getattr(GenerationConfig(**kw), key) == \
        {"prefix_cache": True, "spec_k": 0, "prefill_chunk": 0}[key]
