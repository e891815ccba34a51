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

The model-parallel layers (``parallel.layers``, ``moe``, ``pipeline``,
``ring_attention``, ``ulysses``) write out the collectives that GSPMD
inserts for the JAX package, as pairs whose backward is the forward's
transpose, each a ``torch.autograd.Function`` over one axis's group:

=====================  ==========================  ======================
op                     forward                     backward
=====================  ==========================  ======================
``copy_to_group``      identity                    SUM ``all_reduce``
``reduce_from_group``  SUM ``all_reduce``          identity
``scatter_to_group``   this rank's block of a dim  ``all_gather`` of it
``gather_from_group``  ``all_gather`` along a dim  this rank's block
``all_to_all``         split a dim, concat another the inverse
``ppermute_shift``     to rank+1, from rank-1      the reverse shift
=====================  ==========================  ======================

A tensor computed alike on every rank of an axis (replicated) must get
the same full gradient on each: ``copy_to_group`` goes where such a
tensor enters a computation each rank does only part of, and
``reduce_from_group`` where the parts are summed.  A dim that the axis
does not divide is cut into blocks of ``ceil(n / size)`` (the last ones
shorter, as GSPMD pads), so a vocabulary of 50257 splits over two.

Each op's route is chosen from the group's backend and the tensor's
device by ``ROUTES``, a table: NCCL's native call; gloo's native call
on CPU tensors; on CUDA tensors over gloo (which has no ``all_gather``,
``all_to_all`` or send of them) the exact form ``gather_rows`` uses,
one SUM ``all_reduce`` of a zeroed buffer in which each rank fills its
own rows.  ``routes_taken`` records the route of each op's last call.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["ROUTES", "all_reduce_flat", "all_to_all", "block_range",
           "copy_to_group", "dp_all_reduce_sum", "dp_group", "dp_sync",
           "gather_from_group", "gather_rows", "group_rank_size",
           "ppermute_shift", "reduce_from_group", "routes_taken",
           "scatter_to_group"]

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


# ------------------------------------------------- model-parallel pairs
#: (backend, device type) -> op -> route: "native" (the backend's own
#: call) or "sum" (one SUM all_reduce of a zeroed buffer, exact)
ROUTES = {
    ("nccl", "cuda"): {"all_gather": "native", "all_to_all": "native",
                       "ppermute": "native"},
    ("gloo", "cpu"): {"all_gather": "native", "all_to_all": "native",
                      "ppermute": "native"},
    ("gloo", "cuda"): {"all_gather": "sum", "all_to_all": "sum",
                       "ppermute": "sum"},
}

#: op -> (backend, device type, route) of its last call
routes_taken = {}


def _route(op, group, t):
    import torch.distributed as dist
    key = (dist.get_backend(group), t.device.type)
    route = ROUTES[key][op]
    routes_taken[op] = key + (route,)
    return route


def group_rank_size(group):
    """``(rank, size)`` of this process in ``group`` (``(0, 1)`` for
    None)."""
    if group is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def block_range(n, size, rank):
    """``[start, stop)`` of block ``rank`` when ``n`` is cut into
    ``size`` blocks of ``ceil(n / size)`` (the last ones shorter)."""
    step = -(-n // size)
    start = min(n, rank * step)
    return start, min(n, start + step)


def _all_gather(t, group, rank, size):
    """``(size, *t.shape)``: row r holds rank r's ``t``."""
    import torch.distributed as dist
    t = t.contiguous()
    if _route("all_gather", group, t) == "sum":
        return gather_rows(t, group, size, rank)
    flat = t.reshape((1,) + tuple(t.shape)) if t.dim() == 0 else t
    out = torch.empty((size * flat.shape[0],) + tuple(flat.shape[1:]),
                      dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, flat, group=group)
    return out.reshape((size,) + tuple(t.shape))


def _gather_dim(t, group, dim, total):
    """The ranks' blocks of ``t`` along ``dim`` joined into ``total``
    (each block padded to ``ceil(total / size)`` for the gather)."""
    rank, size = group_rank_size(group)
    step = -(-total // size)
    have = t.shape[dim]
    if have < step:
        pad = list(t.shape)
        pad[dim] = step - have
        t = torch.cat([t, t.new_zeros(pad)], dim)
    rows = _all_gather(t.movedim(dim, 0), group, rank, size)
    whole = rows.reshape((size * step,) + tuple(rows.shape[2:]))
    return whole[:total].movedim(0, dim)


def _block(t, group, dim):
    rank, size = group_rank_size(group)
    start, stop = block_range(t.shape[dim], size, rank)
    return t.narrow(dim, start, stop - start)


def _sum(t, group):
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.total = group, dim, x.shape[dim]
        return _block(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim, ctx.total), None, None


class _GatherFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim, total):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim, total)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None, None


def _a2a(x, group, split_dim, concat_dim):
    import torch.distributed as dist
    rank, size = group_rank_size(group)
    if x.shape[split_dim] % size:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {size}")
    chunks = torch.stack(x.chunk(size, split_dim)).contiguous()
    if _route("all_to_all", group, chunks) == "sum":
        buf = torch.zeros((size,) + tuple(chunks.shape), dtype=x.dtype,
                          device=x.device)
        buf[rank] = chunks
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        got = buf[:, rank]
    else:
        got = torch.empty_like(chunks)
        dist.all_to_all_single(got, chunks, group=group)
    return torch.cat(list(got.unbind(0)), concat_dim).contiguous()


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def _shift(x, group, step, wrap):
    """Each rank's ``x`` to rank + step (mod size); a rank that nothing
    reaches without ``wrap`` receives zeros."""
    import torch.distributed as dist
    rank, size = group_rank_size(group)
    x = x.contiguous()
    src, dst = rank - step, rank + step
    takes = wrap or 0 <= src < size
    gives = wrap or 0 <= dst < size
    if _route("ppermute", group, x) == "sum":
        rows = gather_rows(x, group, size, rank)
        return rows[src % size].clone() if takes else torch.zeros_like(x)
    out = torch.zeros_like(x)
    ops = []
    if gives:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
            group, dst % size), group))
    if takes:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
            group, src % size), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out


class _PPermuteShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, wrap):
        ctx.group, ctx.wrap = group, wrap
        return _shift(x, group, 1, wrap)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1, ctx.wrap), None, None


def _trivial(group):
    return group is None or group_rank_size(group)[1] == 1


def copy_to_group(x, group):
    """Identity forward; the backward sums the cotangent over ``group``
    (where a replicated tensor enters work each rank does part of)."""
    return x if _trivial(group) else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """The SUM of ``x`` over ``group``; the backward passes the
    (replicated) cotangent through."""
    return x if _trivial(group) else _ReduceFromGroup.apply(x, group)


def scatter_to_group(x, group, dim):
    """This rank's block of ``x`` along ``dim``; the backward gathers
    the blocks' cotangents."""
    return x if _trivial(group) else _ScatterToGroup.apply(x, group, dim)


def gather_from_group(x, group, dim, total=None):
    """The ranks' blocks along ``dim`` joined (``total``: the joined
    size, default this block's times the group's size); the backward
    keeps this rank's block of the cotangent."""
    if _trivial(group):
        return x
    if total is None:
        total = x.shape[dim] * group_rank_size(group)[1]
    return _GatherFromGroup.apply(x, group, dim, int(total))


def all_to_all(x, group, split_dim, concat_dim):
    """Tiled all-to-all: ``x`` split into ``size`` chunks along
    ``split_dim``, chunk j to rank j, the chunks received joined along
    ``concat_dim`` in rank order (JAX ``lax.all_to_all(tiled=True)``)."""
    if _trivial(group):
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ppermute_shift(x, group, wrap=False):
    """Each rank's ``x`` to the next rank of ``group``; rank 0 receives
    the last rank's with ``wrap`` (a ring), else zeros (a pipeline).
    The backward shifts the cotangents back.  A group of one passes
    ``x`` through, as JAX's ``_ppermute_shift`` does."""
    if _trivial(group):
        return x
    return _PPermuteShift.apply(x, group, bool(wrap))
