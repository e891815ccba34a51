"""The port's TransformerDecoder against the JAX package's, mode by mode,
on one tiny decoder (vocab 32, dim 32, heads 2, depth 2, max_len 64)
whose numpy-seeded weights are moved with ``convert.params_from_numpy``.

Tolerances: atol 1e-4 on logits and K/V.  Both sides run fp32; the JAX
prefill goes through the blocked Pallas flash kernel (interpret mode)
and the port's CPU path through one full softmax, and matmul summation
orders differ, so values agree to fp32 rounding accumulated over two
layers (observed ~1e-6 on logits of magnitude ~1-10).  Inside the port,
paged decode must equal dense decode bit for bit (same values, same
ops)."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import params_from_numpy
from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
from incubator_mxnet_tpu_torch.parallel import flash_attention
from incubator_mxnet_tpu_torch.parallel.paged_attention import \
    gather_layer_blocks
from incubator_mxnet_tpu_torch.serving import GenerationEngine
from torch_port_helpers import SMALL, VOCAB, jax_decoder, torch_twin

ATOL = 1e-4


def _nd(a, dtype=np.float32):
    return mx.nd.array(np.asarray(a, dtype), dtype=dtype)


@pytest.fixture(scope="module")
def nets():
    jnet = jax_decoder(seed=0)
    return jnet, torch_twin(jnet)


def test_forward_matches_jax(nets):
    jnet, tnet = nets
    toks = np.random.RandomState(0).randint(0, VOCAB, (2, 16))
    ref = jnet(_nd(toks, np.int32)).asnumpy()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 16, VOCAB)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bucket,length", [(16, 11), (32, 32), (64, 1)])
def test_prefill_matches_jax(nets, bucket, length):
    jnet, tnet = nets
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :length] = np.random.RandomState(bucket).randint(1, VOCAB,
                                                             length)
    ref = [o.asnumpy() for o in jnet.prefill(_nd(toks, np.int32),
                                             _nd(length, np.int32))]
    with torch.inference_mode():
        got = [o.numpy() for o in tnet.prefill(torch.from_numpy(toks),
                                               length)]
    assert got[1].shape == (2, 2, bucket, 16)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


def _paged_state(seed=0, slots=3, nb=9, bs=16, max_blocks=4):
    rs = np.random.RandomState(seed)
    shape = (nb, 2, 2, bs, 16)
    k_pool = rs.randn(*shape).astype(np.float32)
    v_pool = rs.randn(*shape).astype(np.float32)
    pt = np.zeros((slots, max_blocks), np.int64)
    pt[0, :2] = [3, 1]
    pt[2, :4] = [2, 8, 5, 7]            # slot 1 stays inactive (null row)
    positions = np.array([20, 0, 61], np.int64)
    tokens = rs.randint(0, VOCAB, slots)
    return tokens, positions, k_pool, v_pool, pt


def test_decode_step_paged_matches_jax_and_equals_dense(nets):
    jnet, tnet = nets
    tokens, positions, k_pool, v_pool, pt = _paged_state()
    ref = [o.asnumpy() for o in jnet.decode_step_paged(
        _nd(tokens, np.int32), _nd(positions, np.int32), _nd(k_pool),
        _nd(v_pool), _nd(pt, np.int32))]
    T = torch.from_numpy
    with torch.inference_mode():
        paged = tnet.decode_step_paged(T(tokens), T(positions), T(k_pool),
                                       T(v_pool), T(pt))
        # the dense cache holding the same rows: [S, layers, H, M, hd]
        k_dense = torch.stack([gather_layer_blocks(T(k_pool), T(pt), li)
                               for li in range(2)], 1)
        v_dense = torch.stack([gather_layer_blocks(T(v_pool), T(pt), li)
                               for li in range(2)], 1)
        dense = tnet.decode_step(T(tokens), T(positions), k_dense, v_dense)
    for g, r in zip(paged, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)
    for a, b in zip(paged, dense):
        assert torch.equal(a, b)
    jref = [o.asnumpy() for o in jnet.decode_step(
        _nd(tokens, np.int32), _nd(positions, np.int32),
        _nd(k_dense.numpy()), _nd(v_dense.numpy()))]
    for g, r in zip(dense, jref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)


def test_cpu_path_never_launches_the_kernel(nets):
    _, tnet = nets
    before = flash_attention.launches
    with torch.inference_mode():
        tnet.prefill(torch.zeros((1, 32), dtype=torch.long), 5)
    assert flash_attention.launches == before == 0


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="cuda"):
        TransformerDecoder(**SMALL)
    net = TransformerDecoder(device="cpu", **SMALL)
    with pytest.raises(MXNetError, match="cuda"):
        GenerationEngine(net, slots=2, max_len=64)


def test_seeded_init_is_deterministic_and_device_independent_draw():
    a = TransformerDecoder(device="cpu", seed=7, **SMALL).state_dict()
    b = TransformerDecoder(device="cpu", seed=7, **SMALL).state_dict()
    c = TransformerDecoder(device="cpu", seed=8, **SMALL).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])
    assert torch.equal(a["layers.0.ln1.gamma"], torch.ones(32))


def test_convert_places_every_parameter_and_refuses_strangers(nets):
    jnet, _ = nets
    named = {n: p.data().asnumpy()
             for n, p in jnet.collect_params().items()}
    sd = params_from_numpy(named)
    port = TransformerDecoder(device="cpu", **SMALL).state_dict()
    assert set(sd) == set(port)
    assert all(sd[n].shape == port[n].shape for n in sd)
    with pytest.raises(MXNetError):
        params_from_numpy(dict(named, lm_mystery0_weight=np.zeros(3)))
