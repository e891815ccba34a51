"""Attention on one device, and ring attention over the ``sp`` axis
(counterpart of ``incubator_mxnet_tpu/parallel/ring_attention.py``).

``attention`` is the reference semantics every fused attention kernel
is held against.  ``ring_attention`` is the per-shard body: each rank
holds its block of the sequence of q, k and v; K/V blocks rotate round
the ``sp`` group (``ops.collective.ppermute_shift``, a ring) while the
online softmax of ``_block_attn`` accumulates exact attention over the
whole sequence, causal positions taken globally (shard i owns rows
``[i*L, (i+1)*L)``).  ``ring_attention_sharded`` and
``make_ring_attention`` are the whole-array entry points: q, k and v
are global, each rank takes its sequence block (``scatter_to_group``),
runs the ring and the blocks are gathered back (``gather_from_group``),
so every rank returns the global output, as JAX's ``shard_map`` does.
A mesh without the axis, or with it of size 1, runs ``attention``.
"""
from __future__ import annotations

import functools
import math

import torch

from ..ops.collective import (gather_from_group, group_rank_size,
                              ppermute_shift, scatter_to_group)

__all__ = ["attention", "ring_attention", "ring_attention_sharded",
           "make_ring_attention"]


def attention(q, k, v, causal=False, scale=None):
    """Multi-head attention on one device.  q/k/v: (batch, heads, seq,
    head_dim) -> (batch, heads, seq, head_dim).  The causal mask keeps
    key ``j`` for query ``i`` when ``j <= i + (tk - tq)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=scores.device).tril(tk - tq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _block_attn(q, k, v, bias, scale, carry=None):
    """One (q-block x kv-block) online-softmax update; carry =
    (acc, row_max, row_sum)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    m_new = scores.amax(dim=-1, keepdim=True)
    if carry is not None:
        acc, m_old, l_old = carry
        m_new = torch.maximum(m_old, m_new)
        corr = torch.exp(m_old - m_new)
    p = torch.exp(scores - m_new)
    l_blk = p.sum(dim=-1, keepdim=True)
    o_blk = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if carry is None:
        return o_blk, m_new, l_blk
    return acc * corr + o_blk, m_new, l_old * corr + l_blk


def ring_attention(q, k, v, group=None, causal=False, scale=None):
    """The ring body on this rank's sequence block of q/k/v (batch,
    heads, local_seq, head_dim), the blocks of the ``sp`` process group
    ``group`` in rank order (None: one shard).  Exact attention over the
    whole sequence; with ``causal`` the positions are global."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    me, n = group_rank_size(group)
    length = q.shape[-2]
    neg = torch.tensor(-1e30, dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)

    def bias_for(owner):
        if not causal:
            return None
        q_pos = me * length + torch.arange(length, device=q.device)[:, None]
        k_pos = owner * length + torch.arange(length,
                                              device=q.device)[None, :]
        return torch.where(q_pos >= k_pos, zero, neg)

    carry = _block_attn(q, k, v, bias_for(me), scale)
    for i in range(1, n):
        k = ppermute_shift(k, group, wrap=True)
        v = ppermute_shift(v, group, wrap=True)
        carry = _block_attn(q, k, v, bias_for((me - i) % n), scale, carry)
    acc, _, l_sum = carry
    return acc / l_sum


def _sp_group(mesh, axis_name):
    """The axis's group, or None where the ring is degenerate."""
    if axis_name not in mesh.axis_names or mesh.axis_size(axis_name) == 1:
        return None
    return mesh.group(axis_name)


def _check_seq(t, size, axis_name):
    if t % size:
        raise ValueError(f"seq ({t}) not divisible by '{axis_name}' "
                         f"({size})")


def ring_attention_sharded(q, k, v, mesh, causal=False, scale=None,
                           axis_name="sp"):
    """Whole-array entry point: q/k/v are global (batch, heads, seq,
    dim); each rank takes its block of the sequence over ``axis_name``,
    runs the ring, and the global output is returned on every rank."""
    group = _sp_group(mesh, axis_name)
    if group is None:
        return attention(q, k, v, causal=causal, scale=scale)
    _check_seq(q.shape[2], mesh.axis_size(axis_name), axis_name)
    local = [scatter_to_group(a, group, 2) for a in (q, k, v)]
    out = ring_attention(*local, group=group, causal=causal, scale=scale)
    return gather_from_group(out, group, 2, q.shape[2])


def make_ring_attention(mesh, causal=False, axis_name="sp"):
    """``ring_attention_sharded`` with its mesh bound."""
    return functools.partial(ring_attention_sharded, mesh=mesh,
                             causal=causal, axis_name=axis_name)
