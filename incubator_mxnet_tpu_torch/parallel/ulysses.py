"""Ulysses all-to-all sequence parallelism (counterpart of
``incubator_mxnet_tpu/parallel/ulysses.py``).

Each rank holds its block of the sequence of every head; an all-to-all
over the ``sp`` group (``ops.collective.all_to_all``: split the heads,
join the sequence) gives it the whole sequence of ``heads / sp`` heads,
on which it runs exact attention (or ``attn_fn``: with
``parallel.flash_attention`` the kernel B5 runs on the full sequence of
those heads), and the inverse all-to-all brings the output back to
sequence blocks.  The all-to-all outputs are contiguous, as the kernel
wants.  ``ulysses_attention_sharded`` is the whole-array entry point,
as ``ring_attention_sharded`` is: global q/k/v in, the global output
out, on every rank.  Heads and sequence must divide by the axis.
"""
from __future__ import annotations

from ..ops.collective import all_to_all, gather_from_group, scatter_to_group
from .ring_attention import _check_seq, _sp_group, attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, causal=False, scale=None, group=None,
                      attn_fn=None):
    """The per-shard body: q/k/v (batch, heads, seq_local, dim), this
    rank's sequence block of every head over the ``sp`` process group
    ``group``; all-to-all to (batch, heads/sp, seq, dim), attention
    there, all-to-all back."""
    qh, kh, vh = (all_to_all(a, group, 1, 2) for a in (q, k, v))
    fn = attn_fn if attn_fn is not None else attention
    out = fn(qh, kh, vh, causal=causal, scale=scale)
    return all_to_all(out, group, 2, 1)


def ulysses_attention_sharded(q, k, v, mesh, causal=False, scale=None,
                              axis_name="sp", attn_fn=None):
    """Whole-array entry point: q/k/v are global (batch, heads, seq,
    dim); the sequence is split over ``axis_name``, the all-to-all
    schedule runs, and the global output is returned on every rank."""
    group = _sp_group(mesh, axis_name)
    if group is None:
        fn = attn_fn if attn_fn is not None else attention
        return fn(q, k, v, causal=causal, scale=scale)
    sp = mesh.axis_size(axis_name)
    if q.shape[1] % sp:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by the "
            f"'{axis_name}' axis ({sp}); use ring attention otherwise")
    _check_seq(q.shape[2], sp, axis_name)
    local = [scatter_to_group(a, group, 2) for a in (q, k, v)]
    out = ulysses_attention(*local, causal=causal, scale=scale, group=group,
                            attn_fn=attn_fn)
    return gather_from_group(out, group, 2, q.shape[2])
