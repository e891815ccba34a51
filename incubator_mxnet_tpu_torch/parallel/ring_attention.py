"""Plain single-device attention — the port of
``incubator_mxnet_tpu/parallel/ring_attention.py`` ``attention``, the
reference semantics every fused attention kernel is held against.  The
ring (sequence-parallel) variants come with the multi-device slice."""
from __future__ import annotations

import math

import torch

__all__ = ["attention"]


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
