"""Pipeline parallelism over the ``pp`` axis (counterpart of
``incubator_mxnet_tpu/parallel/pipeline.py``).

The JAX package runs the GPipe schedule as one SPMD program: the S
homogeneous stages' parameters are stacked along a leading dim of size
S split over ``pp``, and a ``lax.scan`` over M + S - 1 ticks applies
every stage to its current microbatch, then rotates the activations to
the next stage with ``lax.ppermute``.  The port runs the same tick loop
on every rank of the ``pp`` group, written out:

* each rank holds its stage's block of the stacked parameters (cut by
  the step, ``gluon.Parameter.cut``) and takes the microbatches, which
  are replicated over ``pp``, through ``copy_to_group`` (only stage 0
  reads them, so their gradient is summed over the stages);
* at tick t stage 0 applies itself to microbatch min(t, M-1), the other
  stages to the state the previous stage sent (zeros in the bubbles);
  the output goes to the next stage by ``ppermute_shift`` (no wrap);
* the last stage keeps its outputs from tick S-1 on; every other stage
  zeroes its copy, and ``reduce_from_group`` sums them, so every ``pp``
  rank holds the outputs and the loss needs no placement.

Every rank runs every tick, bubbles included, so the stages' own
collectives (tensor-parallel layers inside a stage, on the ``tp`` group
of the stage's ranks) come in the same order on every rank.  Bubble
fraction (S-1)/(M+S-1).

``PipelineStack`` is the Gluon wrapper (S copies of one stage block,
the schedule on a ``pp`` mesh of S ranks, the sequential unroll without
one); ``Pipeline`` is a plain sequential container of heterogeneous
stages, whose ``shard_over`` raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter, _run_init
from ..ndarray.ndarray import NDArray
from ..ops.collective import (copy_to_group, group_rank_size,
                              ppermute_shift, reduce_from_group,
                              scatter_to_group)
from .mesh import Sharding, current_mesh

__all__ = ["pipeline_spmd", "pipeline_forward", "PipelineStack",
           "PipelineStage", "Pipeline", "split_microbatches"]


def split_microbatches(a, num, batch_axis=0):
    """``a`` reshaped into (num, n/num, ...) microbatches along
    ``batch_axis``."""
    n = a.shape[batch_axis]
    m = n // num
    moved = a.movedim(batch_axis, 0)
    resh = moved.reshape((num, m) + tuple(moved.shape[1:]))
    return resh.movedim(1, batch_axis + 1)


class _StackedParameter(Parameter):
    """Parameter shaped (S,) + stage_shape whose initializer fills each
    stage slice at the stage's shape, so fan-based initializers see the
    stage's fans."""

    def _fill(self, init, default_init, values):
        stage = np.empty(values.shape[1:], dtype=values.dtype)
        for s in range(values.shape[0]):
            stage[...] = 0
            _run_init(init, default_init, self.name, stage)
            values[s] = stage


def _schedule(stage_fn, params, microbatches, group):
    """The GPipe tick loop on this rank: ``params`` its stage's arrays,
    ``microbatches`` (M, mb, ...) replicated over ``group``.  Returns the
    last stage's outputs (M, mb, ...) on every rank.

    The graph is the same on every rank (the stage's choice of input
    and the last stage's mask are ``where`` and a product, not Python
    branches), so every collective of the backward is reached on every
    rank, in the same order."""
    idx, size = group_rank_size(group)
    mbs = copy_to_group(microbatches, group)
    m = mbs.shape[0]
    first = torch.tensor(idx == 0, device=mbs.device)
    state = torch.zeros_like(mbs[0])
    outs = []
    for t in range(m + size - 1):
        out = stage_fn(params, torch.where(first, mbs[min(t, m - 1)], state))
        if t >= size - 1:
            outs.append(out)
        if t < m + size - 2:
            state = ppermute_shift(out, group, wrap=False)
    keep = 1.0 if idx == size - 1 else 0.0
    return reduce_from_group(torch.stack(outs) * keep, group)


def pipeline_spmd(stage_fn, stacked_params, microbatches, mesh,
                  axis_name="pp"):
    """Run the GPipe schedule over ``mesh``'s ``axis_name``.

    ``stage_fn(params, x) -> y`` applies one stage (y of x's shape);
    ``stacked_params`` are the stacked (S, ...) arrays, S the axis size
    (each rank takes its stage's block, and their gradients are gathered
    back); ``microbatches`` is (M, mb, ...).  Returns the outputs (M, mb,
    ...) on every rank of the axis."""
    size = mesh.axis_size(axis_name)
    group = mesh.group(axis_name) if size > 1 else None
    for i, a in enumerate(stacked_params):
        if a.shape[0] != size:
            raise MXNetError(
                f"stacked param {i} has {a.shape[0]} stages but the mesh's "
                f"'{axis_name}' axis has size {size}; the stage stack must "
                "match the pipeline axis exactly")
    local = [scatter_to_group(a, group, 0) for a in stacked_params]
    if group is None:
        return torch.stack([stage_fn([a[0] for a in local], x)
                            for x in microbatches])
    return _schedule(stage_fn, [a[0] for a in local], microbatches, group)


def _check_split(n, m):
    if n % m:
        raise MXNetError(f"batch size {n} not divisible by "
                         f"num_microbatches {m}")


def pipeline_forward(stage_fn, stacked_params, x, num_microbatches, mesh,
                     axis_name="pp", batch_axis=0):
    """Split ``x`` into microbatches along ``batch_axis``, run the
    schedule, and join the outputs back into the batch.  On a mesh with
    a ``dp`` axis ``x`` is this rank's slice of the batch."""
    n = x.shape[batch_axis]
    _check_split(n, num_microbatches)
    out = pipeline_spmd(stage_fn, stacked_params,
                        split_microbatches(x, num_microbatches, batch_axis),
                        mesh, axis_name=axis_name)
    out = out.movedim(1 + batch_axis, 1)
    out = out.reshape((n,) + tuple(out.shape[2:]))
    return out.movedim(0, batch_axis)


class PipelineStack(HybridBlock):
    """S homogeneous copies of ``stage``, pipelined over the ``pp`` axis.

    The stage's parameters are made again stacked, with a leading stage
    dim of size S carrying the sharding ``(pp, ...)`` in front of the
    stage's own (a tensor-parallel layer inside a stage keeps its
    ``tp`` split), named ``s{i}_<suffix>``.  A step on a mesh whose
    ``pp`` axis has S ranks cuts them (one stage a rank) and the forward
    runs the GPipe schedule; without one it runs the stages one after
    another (the same function: the tests hold the two to each other).
    The stage block must have static shapes, equal input and output
    shapes, and no batch-coupled state (BatchNorm would see microbatch
    statistics).  An LM pipelines with its embedding and head split
    over the ``pp`` axis around the stack (``ShardedEmbedding(V, D,
    axis="pp")``, ``ColumnParallelDense(V, axis="pp")``), so no rank
    holds the whole of either."""

    _writes_collectives = True

    def __init__(self, stage, num_stages, num_microbatches=None,
                 axis_name="pp", mesh=None, **kwargs):
        super().__init__(**kwargs)
        # not a registered child: the stage's own parameters are scratch
        # space the stacked ones are substituted into
        object.__setattr__(self, "_stage_block", stage)
        self._S = int(num_stages)
        self._M = num_microbatches or 2 * self._S
        self._axis = axis_name
        self._mesh = mesh
        self._stage_params = list(stage.collect_params().values())
        for p in self._stage_params:
            if not p._shape_known():
                raise MXNetError(
                    "PipelineStack stage must have static shapes "
                    f"(param {p.name} has unknown shape — pass in_units "
                    "/ in_channels)")
            if p.grad_req == "null":
                raise MXNetError(
                    f"PipelineStack stage param {p.name} has "
                    "grad_req='null' (e.g. BatchNorm moving stats): "
                    "batch-coupled / aux state is not supported inside a "
                    "pipelined stage — its in-forward updates would be "
                    "silently dropped. Use LayerNorm or move the layer "
                    "outside the stack.")
            if p._data is None:
                p.initialize()
        self._stacked = []
        for i, p in enumerate(self._stage_params):
            suffix = p.name.rsplit("_", 1)[-1]
            name = self.params.prefix + f"s{i}_" + suffix
            sp = _StackedParameter(
                name, shape=(self._S,) + tuple(p.shape), dtype=p.dtype,
                init=p.init, grad_req=p.grad_req)
            sp.lr_mult, sp.wd_mult = p.lr_mult, p.wd_mult
            tail = tuple(p.sharding) if p.sharding is not None \
                else (None,) * len(p.shape)
            sp.sharding = (axis_name,) + tail
            self.params._params[name] = sp
            self._reg_params[f"s{i}_{suffix}"] = sp
            self._stacked.append(sp)

    @property
    def num_stages(self):
        return self._S

    def _apply_stage(self, stage_arrays, x):
        """The stage block with its parameters' values swapped for
        ``stage_arrays`` (and their cut for the stacked ones')."""
        saved = []
        try:
            for p, sp, a in zip(self._stage_params, self._stacked,
                                stage_arrays):
                nd = p._data
                saved.append((p, nd, nd._data, p._cut))
                nd._data = a
                p._cut = None if sp._cut is None else \
                    _tail(sp._cut)
            out = self._stage_block(NDArray(x))
            return out._data if isinstance(out, NDArray) else out
        finally:
            for p, nd, old, cut in saved:
                nd._data = old
                p._cut = cut

    def _pp_group(self):
        """The ``pp`` group the stacked parameters are cut over, or
        None (not cut: the sequential unroll)."""
        cut = self._stacked[0]._cut if self._stacked else None
        if cut is None or cut.group(0) is None:
            mesh = self._mesh or current_mesh()
            size = mesh.axis_size(self._axis) if mesh is not None else 1
            if size > 1 and size != self._S:
                raise MXNetError(
                    f"PipelineStack has {self._S} stages but the mesh's "
                    f"'{self._axis}' axis has size {size}; they must match")
            return None
        size = group_rank_size(cut.group(0))[1]
        if size != self._S:
            raise MXNetError(
                f"PipelineStack has {self._S} stages but the mesh's "
                f"'{self._axis}' axis has size {size}; they must match")
        return cut.group(0)

    def forward(self, x):
        if any(p._data is None for p in self._stacked):
            raise MXNetError("PipelineStack not initialized")
        arrays = [p.local_data()._data for p in self._stacked]
        xd = x._data if isinstance(x, NDArray) else x
        group = self._pp_group()
        if group is None:
            cur = xd
            for s in range(self._S):
                cur = self._apply_stage([a[s] for a in arrays], cur)
            return NDArray(cur)
        n = xd.shape[0]
        _check_split(n, self._M)
        out = _schedule(self._apply_stage, [a[0] for a in arrays],
                        split_microbatches(xd, self._M), group)
        return NDArray(out.reshape((n,) + tuple(out.shape[2:])))


def _tail(cut):
    """The cut of a stage's parameter from its stacked one's: the spec
    without the leading stage dim (None when nothing else is split)."""
    tail = Sharding(cut.mesh, cut.spec[1:])
    return tail if tail.is_split else None


class PipelineStage(HybridBlock):
    """Marks a sub-block as one stage of a heterogeneous Pipeline."""

    def __init__(self, block, stage_index, **kwargs):
        super().__init__(**kwargs)
        self.register_child(block, "body")
        self.stage_index = stage_index

    def hybrid_forward(self, F, x):
        return self._children["body"](x)


class Pipeline(HybridBlock):
    """Sequential container of heterogeneous stages, run in order on
    this rank.  It places no stage on a ``pp`` rank (heterogeneous
    stages are not one SPMD program; ``PipelineStack`` pipelines
    homogeneous ones), so ``shard_over`` raises."""

    def __init__(self, *blocks, **kwargs):
        super().__init__(**kwargs)
        self._stages = []
        with self.name_scope():
            for i, b in enumerate(blocks):
                stage = b if isinstance(b, PipelineStage) else \
                    PipelineStage(b, i)
                self.register_child(stage, f"stage{i}")
                self._stages.append(stage)

    @property
    def num_stages(self):
        return len(self._stages)

    def shard_over(self, mesh):
        raise MXNetError(
            "Pipeline holds heterogeneous stages and cannot be placed "
            "over a pp axis; use PipelineStack (homogeneous stages, "
            "GPipe schedule) for real pipeline parallelism")

    def hybrid_forward(self, F, x):
        for stage in self._stages:
            x = stage(x)
        return x
