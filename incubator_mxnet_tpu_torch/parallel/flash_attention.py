"""Flash-attention forward: a hand-written Hopper kernel and its plain
version.

Port of ``incubator_mxnet_tpu/parallel/flash_attention.py``.  The TPU
kernel there (``_kernel``, a Pallas grid over (batch*head, q-block) with
an online-softmax ``fori_loop`` over K/V blocks) becomes
``csrc/flash_attention.cu``: the same function — same scale, same
causal rule ``cols <= rows``, fp32 online softmax and accumulation —
re-tiled for the card (its source note says how and why).

* A CUDA tensor always goes to the kernel, or raises: there is no
  fallback to the plain version.  The kernel takes contiguous fp32
  tensors with head_dim in {16, 32, 64, 128}.
* A CPU tensor goes to ``_flash_plain``, the ``attention`` math with
  the causal mask.  The CPU tests use it, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* ``flash_attention.launches`` counts kernel launches, so a run can show
  that its main path went through the kernel.
* ``flash_attention`` is one ``torch.autograd.Function`` on both
  devices (``_Flash``), as the JAX function is a ``jax.custom_vjp``:
  its forward is the kernel (or the plain version on the CPU), its
  backward recomputes the plain fp32 ``attention`` from the saved q, k
  and v and takes autograd's VJP of it (JAX ``_flash_bwd``).  Nothing
  else is saved, so the forward keeps no T x T scores.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..base import MXNetError
from .ring_attention import attention

__all__ = ["flash_attention"]

HEAD_DIMS = (16, 32, 64, 128)

_bound = None


def _lib():
    """The kernel library, built at first use, with its C signature."""
    global _bound
    if _bound is None:
        lib = _build.load("flash_attention")
        fn = lib.mx_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _flash_plain(q, k, v, causal, scale):
    """The plain PyTorch version: fp32 ``attention`` with the causal
    mask, cast back to q's dtype (the kernel's output dtype)."""
    return attention(q.float(), k.float(), v.float(), causal=causal,
                     scale=scale).to(q.dtype)


def _flash_cuda(q, k, v, causal, scale):
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device:
            raise MXNetError(f"flash_attention: {name} is on {a.device}, "
                             f"q on {q.device}")
        if a.dtype != torch.float32:
            raise MXNetError(f"flash_attention kernel takes float32, "
                             f"{name} is {a.dtype}")
        if not a.is_contiguous():
            raise MXNetError(f"flash_attention kernel takes contiguous "
                             f"tensors, {name} is not")
        if a.shape != q.shape:
            raise MXNetError(f"flash_attention: {name} shape "
                             f"{tuple(a.shape)} != q shape {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise MXNetError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b * h * t * d >= 2 ** 31:
        raise MXNetError("flash_attention kernel: tensor too large")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mx_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, t, d, float(scale), int(causal), stream)
    if rc:
        raise MXNetError(f"flash_attention kernel launch failed: "
                         f"{lib.mx_cuda_error_string(rc).decode()} ({rc})")
    flash_attention.launches += 1
    return out


def _flash_forward(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_cuda(q, k, v, causal, scale)


class _Flash(torch.autograd.Function):
    """The kernel's forward; the plain fp32 ``attention``'s VJP as its
    backward, recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash_forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().float().requires_grad_(True)
                      for t in (q, k, v)]
            out = attention(*inputs, causal=ctx.causal, scale=ctx.scale)
            grads = torch.autograd.grad(out, inputs, do.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v))) + \
            (None, None)


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """Fused attention forward.  q/k/v: (batch, heads, seq, head_dim);
    seq must be divisible by the block sizes (the JAX package's
    contract — bucketing keeps shapes static).  The CUDA kernel picks
    its own tiles and masks ragged edges, so the blocks only fix that
    contract.  Matches ``attention`` numerics."""
    b, h, t, d = q.shape
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq_len {t} must be divisible by block sizes "
                         f"({block_q}, {block_k})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _Flash.apply(q, k, v, bool(causal), float(scale))


flash_attention.launches = 0
