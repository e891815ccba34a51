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
from torch_port_helpers import split_tf32, tf32_rna

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


# B5 on the card runs both products in TF32 on the tensor cores, each
# operand split into two TF32 parts and three products summed
# (csrc/flash_attention.cu, with tc_gemm.cuh's numerics), over key tiles
# with an online softmax in base 2.  Here that recurrence runs on the CPU
# (a CPU computation, not the card's: fp32 sums rounding to nearest)
# over 64-key tiles against fp64 attention: the split must hold
# chip_smoke.py's kernel gate (KERNEL_ATOL, 1e-4 abs) with a margin of
# SPLIT_MARGIN, and one TF32 pass must not hold it.
KERNEL_ATOL = 1e-4
SPLIT_MARGIN = 20.0
LOG2E = 1.4426950408889634


def _tf32_product(a, b, product):
    """a @ b with the multiplications of ``product``: "tf32" (one pass)
    or "3xtf32" (small x big, big x small, then big x big)."""
    if product == "tf32":
        return tf32_rna(a) @ tf32_rna(b)
    (ab, asm), (bb, bsm) = split_tf32(a), split_tf32(b)
    return asm @ bb + ab @ bsm + ab @ bb


def _flash_recurrence(q, k, v, causal, product, tile=64):
    """The kernel's recurrence in fp32: q scaled by scale * log2 e,
    S = q' k^T per key tile, running max m (-inf until a key is seen,
    subtracting 0 then), P = 2^(S - m), l and the output rescaled by
    2^(m_old - m), each tile's P V added to the rescaled output, o / l
    at the end."""
    t, d = q.shape[-2:]
    qs = q * (LOG2E / np.sqrt(d))
    rows = torch.arange(t).view(-1, 1)
    m = torch.full(q.shape[:-1] + (1,), -np.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, t, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        s = _tf32_product(qs, kt.transpose(-1, -2), product)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2]).view(1, -1)
            s = s.masked_fill(cols > rows, -np.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -np.inf, torch.zeros_like(m_new),
                            m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_product(p, vt, product)
        m = m_new
    return acc / l


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(256, 64), (1024, 64), (256, 128),
                                 (1024, 128)])
def test_3xtf32_split_holds_the_flash_gate_and_one_pass_does_not(t, d,
                                                                   causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, t, d), seed=t + d))
    ref = _flash_plain(q.double(), k.double(), v.double(), causal,
                       1.0 / np.sqrt(d))

    def err(product):
        out = _flash_recurrence(q, k, v, causal, product)
        assert out.dtype == torch.float32
        return (out.double() - ref).abs().max().item()
    split, once = err("3xtf32"), err("tf32")
    assert split * SPLIT_MARGIN <= KERNEL_ATOL, (split, once)
    assert once > KERNEL_ATOL, (split, once)
