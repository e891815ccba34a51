"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's ``flash_attention`` runs its plain version
(``_flash_plain``); the reference is the JAX package's Pallas kernel in
interpret mode, as its own tests run it on the CPU.  Inputs come from a
seeded numpy stream and go to both sides.  Tolerance: atol 2e-5 — both
sides compute in fp32, the Pallas kernel with a blocked online softmax
and the plain version with one full softmax, so they differ only by
fp32 rounding of O(1) values (observed ~1e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.parallel.flash_attention import \
    flash_attention as jax_flash
from incubator_mxnet_tpu_torch import _build
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel.flash_attention import (
    _flash_plain, flash_attention)

ATOL = 2e-5


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,block,d", [(16, 16, 16), (32, 16, 16),
                                       (64, 32, 32), (64, 16, 32),
                                       (48, 16, 16), (32, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_pallas_interpret(t, block, d, causal):
    q, k, v = _qkv((2, 2, t, d), seed=t + d)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=block,
                               block_k=block, interpret=True))
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          block_q=block, block_k=block).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert flash_attention.launches == before


def test_causal_prefix_rows_ignore_the_future():
    """Row i of causal attention depends only on keys <= i."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 32, 16)))
    a = flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 20:] += 5.0
    v2[:, :, 20:] -= 5.0
    b = flash_attention(q, k2, v2, causal=True, block_q=16, block_k=16)
    assert torch.equal(a[:, :, :20], b[:, :, :20])
    assert not torch.equal(a[:, :, 20:], b[:, :, 20:])


def test_divisibility_contract_and_device_refusal():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 24, 16)))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, block_q=16, block_k=16)
    meta = torch.empty((1, 1, 16, 16), device="meta")
    with pytest.raises(MXNetError):
        flash_attention(meta, meta, meta)


def test_plain_keeps_input_dtype():
    q, k, v = (torch.from_numpy(a).double() for a in _qkv((1, 2, 16, 16)))
    out = _flash_plain(q, k, v, True, 0.25)
    assert out.dtype == torch.float64


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit: the build refuses with MXNetError naming nvcc;
    there is no silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: str(tmp_path / f"lib{name}.so"))
    with pytest.raises(MXNetError, match="nvcc"):
        _build.build(["flash_attention"])
