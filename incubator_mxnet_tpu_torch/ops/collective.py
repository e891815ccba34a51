"""Collectives the ops run under a data-parallel step.

Under GSPMD the JAX package's ``TrainStep(mesh=...)`` on a ``dp`` mesh
computes the single-device step on the global batch: every BatchNorm's
statistics cover the whole batch, which the compiler arranges without a
line of BN code knowing.  The port runs one process per rank, each on
its slice of the batch, so the BN statistics must be summed over the
ranks explicitly:

* ``dp_sync(group)`` is the context ``parallel.TrainStep`` sets around
  a mesh step whose ``dp`` group has more than one rank; ``dp_group()``
  reads it (a thread-local: None outside such a step).  Gluon's
  ``Trainer`` and ``Module`` never set it, so they keep each rank's own
  statistics, as MXNet and the JAX eager path do.
* ``dp_all_reduce_sum(tensors, group)`` is one ``torch.autograd.
  Function``: its forward sums the tensors over the group (one flat
  ``all_reduce``), its backward sums their cotangents the same way, so
  the backward through the statistics is global too, as in PyTorch's
  SyncBatchNorm.  ``ops.fused_conv.bn_stats`` sums ``(Σx, Σx², count)``
  through it; the chain's pass-1 sums (B3) go through it between the B3
  and B4 launches; the ops whose backward is a recomputation
  (``recompute_vjp``) re-enter ``dp_sync`` with the group their forward
  saw, since the backward runs on autograd's own thread.

Every rank runs the same graph, so the collectives of a forward and of
its backward come in the same order on every rank.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["all_reduce_flat", "dp_all_reduce_sum", "dp_group", "dp_sync",
           "gather_rows"]

_state = threading.local()


def dp_group():
    """The ``dp`` process group of the mesh step running on this thread,
    or None."""
    return getattr(_state, "group", None)


@contextlib.contextmanager
def dp_sync(group):
    """Sum the BN statistics over ``group`` inside the block (None: keep
    them per rank)."""
    prev = dp_group()
    _state.group = group
    try:
        yield
    finally:
        _state.group = prev


def all_reduce_flat(tensors, group, divide=1):
    """The tensors summed over ``group`` (then divided by ``divide``),
    out of place: one ``all_reduce`` per dtype of their flat
    concatenation.  The results come back in the tensors' order."""
    import torch.distributed as dist
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(tensors)
    for idx in by_dtype.values():
        same = [tensors[i] for i in idx]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divide != 1:
            flat = flat / divide
        for i, t, part in zip(idx, same,
                              flat.split([t.numel() for t in same])):
            out[i] = part.view_as(t)
    return out


def gather_rows(t, group, size, rank):
    """``(size, *t.shape)``: row r holds rank r's ``t``.  One SUM
    ``all_reduce`` of a zeroed buffer in which each rank fills its own
    row (gloo has no ``all_gather`` of CUDA tensors); exact, since every
    position is nonzero on one rank at most.  An unsigned byte buffer
    sums as bytes."""
    import torch.distributed as dist
    rows = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype,
                       device=t.device)
    rows[rank] = t
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(all_reduce_flat(tensors, group))

    @staticmethod
    def backward(ctx, *cotangents):
        return (None,) + tuple(all_reduce_flat(cotangents, ctx.group))


def dp_all_reduce_sum(tensors, group):
    """``tensors`` (one dtype) summed over ``group``, differentiably: the
    backward sums the cotangents over the group."""
    return _AllReduceSum.apply(group, *tensors)
