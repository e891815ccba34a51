"""Tensor-parallel layers of the port (counterpart of
``incubator_mxnet_tpu/parallel/layers.py``).

The JAX layers are Gluon blocks whose parameters carry a ``sharding``
tuple; under GSPMD the compiler inserts the collectives, and each
layer's output is logically the global activation.  The port's layers
declare the same tuples, and once a step on a mesh has cut their
parameters (``gluon.Parameter.cut``) each rank computes its part and
writes out the collectives (``ops.collective``), so that the output is
the global activation on every rank of the axis, as JAX's is:

* ``ColumnParallelDense``: ``copy_to_group`` of the input, the product
  with this rank's rows of the weight (and bias) and the activation,
  then ``gather_from_group`` of the output features;
* ``RowParallelDense``: ``scatter_to_group`` of the input features, the
  product with this rank's columns of the weight, ``reduce_from_group``
  of the partial sums, then the bias and the activation;
* ``ShardedEmbedding``: a lookup of the ids in this rank's block of the
  vocabulary (zeros for the others), then ``reduce_from_group``.

With no mesh, or an axis of size 1, each is bit for bit the port's
plain ``Dense`` or ``Embedding``.  A vocabulary the axis does not divide
(GPT-2's 50257 over two) is cut into blocks of ``ceil(V / size)``.
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon.nn import Dense
from ..ndarray.ndarray import NDArray
from ..ops.collective import (block_range, copy_to_group, gather_from_group,
                              group_rank_size, reduce_from_group,
                              scatter_to_group)

__all__ = ["ColumnParallelDense", "RowParallelDense", "ShardedEmbedding"]


def cut_group(param, dim):
    """The process group ``param``'s dim ``dim`` is cut over, or None
    (not cut, or an axis of size 1)."""
    return None if param._cut is None else param._cut.group(dim)


def _nd(t, like):
    return NDArray(t, like.context)


class ColumnParallelDense(Dense):
    """Dense with its output features split over ``axis`` (the weight's
    rows and the bias); the output is gathered, so every rank of the
    axis holds the global activation."""

    _writes_collectives = True

    def __init__(self, units, axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self.weight.sharding = (axis, None)
        if self.bias is not None:
            self.bias.sharding = (axis,)

    def hybrid_forward(self, F, x, weight, bias=None):
        group = cut_group(self.weight, 0)
        if group is None:
            return super().hybrid_forward(F, x, weight, bias)
        x = _nd(copy_to_group(x._data, group), x)
        out = F.FullyConnected(x, weight, bias, num_hidden=weight.shape[0],
                               flatten=self._flatten, no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return _nd(gather_from_group(out._data, group, out.ndim - 1,
                                     self._units), out)


class RowParallelDense(Dense):
    """Dense with its input features split over ``axis`` (the weight's
    columns); the partial products are summed over the axis, then the
    bias and the activation."""

    _writes_collectives = True

    def __init__(self, units, axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self.weight.sharding = (None, axis)

    def hybrid_forward(self, F, x, weight, bias=None):
        group = cut_group(self.weight, 1)
        if group is None:
            return super().hybrid_forward(F, x, weight, bias)
        t = x._data
        if self._flatten and t.dim() > 2:
            t = t.reshape(t.shape[0], -1)
        t = scatter_to_group(t, group, t.dim() - 1)
        part = F.FullyConnected(_nd(t, x), weight, None,
                                num_hidden=self._units, flatten=False,
                                no_bias=True)
        out = reduce_from_group(part._data, group)
        if bias is not None:
            out = out + bias._data
        out = _nd(out, x)
        if self.act is not None:
            out = self.act(out)
        return out


class ShardedEmbedding(HybridBlock):
    """Embedding with the vocabulary split over ``axis``: each rank holds
    a block of the table's rows, looks up the ids that fall in it, and
    the rows are summed over the axis."""

    _writes_collectives = True

    def __init__(self, input_dim, output_dim, axis="tp", dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            self.weight.sharding = (axis, None)

    def hybrid_forward(self, F, x, weight):
        group = cut_group(self.weight, 0)
        if group is None:
            return F.Embedding(x, weight, input_dim=self._input_dim,
                               output_dim=self._output_dim)
        rank, size = group_rank_size(group)
        start, stop = block_range(self._input_dim, size, rank)
        ids = x._data.long() - start
        w = weight._data
        if stop <= start:
            # an empty block (ceil(n / size) rows leave the last ranks
            # none): a zero lookup that still reaches the all-reduce
            # every rank waits in, and gives the (0, D) block its zero
            # gradient
            rows = w.new_zeros(ids.shape + (0,)) @ w
        else:
            inside = ((ids >= 0) & (ids < stop - start)).unsqueeze(-1)
            rows = w[ids.clamp(0, stop - start - 1)]
            rows = torch.where(inside, rows, torch.zeros_like(rows))
        return _nd(reduce_from_group(rows, group), x)

    def __repr__(self):
        return f"ShardedEmbedding({self._input_dim} -> {self._output_dim})"
