"""Mixture-of-Experts with expert parallelism over the ``ep`` axis
(counterpart of ``incubator_mxnet_tpu/parallel/moe.py``).

The GShard/Switch dense dispatch of the JAX package: routing is one-hot
einsum contractions over (tokens, experts, capacity slots), with no
data-dependent shapes, and tokens beyond an expert's capacity are
dropped in the JAX slot order.

* ``moe_ffn``: the top-k gated expert FFN and the Switch load-balance
  loss, on one device.
* ``moe_ffn_sharded``: the experts split over ``ep``, the tokens
  replicated over it, which is what JAX's GSPMD form computes (capacity
  counted over all N tokens).  Every rank gates all tokens (the gate's
  path takes no collective, so its gradient is whole on every rank),
  runs its block of experts on them, and the expert outputs' combine is
  summed over the axis (``reduce_from_group``).  ``copy_to_group`` goes
  on x and on the combine weights where they enter the expert-local
  einsums, so their gradients are summed over the experts.  It takes
  the global expert tensors; ``MoELayer`` runs the same body on its cut
  parameters.
* ``moe_ffn_alltoall``: the tokens split over ``ep``, one expert a
  shard, the GShard wire pattern written out: each rank gates its
  tokens, its per-expert slabs go out by one ``all_to_all`` and the
  expert outputs come back by the mirrored one; the load-balance loss
  sums its token counts and probabilities over the axis.  Its capacity
  rule is its own (per source shard and expert; default every local
  token).
* ``MoELayer``: a Gluon block whose stacked expert parameters carry
  ``(ep, None, None)`` shardings; its forward on an ``ep`` mesh is
  ``moe_ffn_sharded``'s body, as JAX's ``moe_ffn`` is under GSPMD.
  ``aux_loss`` holds the forward's load-balance loss (an NDArray on the
  tape, pre-scaled by ``aux_loss_weight``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ..base import MXNetError
from ..gluon.block import Block
from ..ndarray.ndarray import NDArray
from ..ops.collective import (all_to_all, block_range, copy_to_group,
                              gather_from_group, group_rank_size,
                              reduce_from_group, scatter_to_group)
from .layers import cut_group

__all__ = ["moe_ffn", "moe_ffn_sharded", "moe_ffn_alltoall", "MoELayer"]


def _dispatch_tensors(probs, top_k, capacity, normalize_gates):
    """Token -> expert dispatch and combine tensors, capacity-bounded:
    probs (N, E) -> dispatch (N, E, C) one-hot over capacity slots and
    combine (N, E, C) = dispatch x gate value.  A token past its
    expert's capacity is dropped (its combine rows are zero)."""
    n, num_experts = probs.shape
    # a stable descending sort breaks ties toward the lower expert, as
    # ``lax.top_k`` does (``torch.topk`` takes the higher ones)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :top_k], gate_idx[:, :top_k]
    if normalize_gates:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(num_experts, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = torch.zeros((n, num_experts, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((num_experts,), dtype=torch.int64,
                         device=probs.device)
    for k in range(top_k):
        mask = (gate_idx[:, k][:, None] == experts[None, :]).long()
        # each token's place in its expert's queue for this choice
        pos = torch.cumsum(mask, 0) - 1 + counts[None, :]
        counts = counts + mask.sum(0)
        keep = (pos < capacity) & (mask > 0)
        slot = pos.clamp(0, capacity - 1)
        d_k = ((slot[..., None] == slots) & keep[..., None]).to(probs.dtype)
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_vals[:, k][:, None, None]
    return dispatch, combine


def _activate(h, activation):
    if activation == "relu":
        return torch.relu(h)
    if activation == "gelu":
        return tF.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    if activation is not None:
        raise MXNetError(f"unsupported MoE activation {activation!r}")
    return h


def _experts(expert_in, w1, b1, w2, b2, activation):
    h = torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :]
    h = _activate(h, activation)
    return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]


def _moe(x, gate_w, w1, b1, w2, b2, num_experts, group, top_k,
         capacity_factor, activation, normalize_gates, capacity):
    """The body of ``moe_ffn`` (``group`` None) and of the ``ep`` form:
    w1/b1/w2/b2 hold this rank's block of the experts."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    if capacity is None:
        capacity = max(1, int(math.ceil(
            top_k * n * capacity_factor / num_experts)))
    probs = torch.softmax(xf @ gate_w, dim=-1)
    dispatch, combine = _dispatch_tensors(probs, top_k, capacity,
                                          normalize_gates)
    # the Switch load-balance loss (Switch Transformer eq. 4)
    frac_tokens = dispatch.sum(dim=(0, 2)) / max(n, 1)
    aux = num_experts * torch.sum(frac_tokens * probs.mean(0))
    rank, size = group_rank_size(group)
    e0, e1 = block_range(num_experts, size, rank)
    xin = copy_to_group(xf, group)
    combine = copy_to_group(combine, group)[:, e0:e1]
    expert_in = torch.einsum("nec,nd->ecd", dispatch[:, e0:e1], xin)
    out_e = _experts(expert_in, w1, b1, w2, b2, activation)
    y = reduce_from_group(torch.einsum("nec,ecd->nd", combine, out_e),
                          group)
    return y.reshape(tuple(lead) + (d,)), aux


def moe_ffn(x, gate_w, w1, b1, w2, b2, *, top_k=2, capacity_factor=1.25,
            activation="relu", normalize_gates=True, capacity=None):
    """Top-k gated mixture-of-experts FFN (GShard dense dispatch).
    x (..., D); gate_w (D, E); w1 (E, D, H); b1 (E, H); w2 (E, H, D);
    b2 (E, D).  Returns ``(y, aux_loss)``: y of x's shape and the Switch
    load-balance loss E * sum_e fraction_e * mean_prob_e."""
    return _moe(x, gate_w, w1, b1, w2, b2, w1.shape[0], None, top_k,
                capacity_factor, activation, normalize_gates, capacity)


def moe_ffn_sharded(x, gate_w, w1, b1, w2, b2, mesh, *, axis_name="ep",
                    top_k=2, capacity_factor=1.25, activation="relu",
                    normalize_gates=True, capacity=None):
    """``moe_ffn`` with the experts split over ``axis_name``: the global
    expert tensors in, each rank runs its block of them on every token,
    the global output (and the loss) on every rank."""
    if axis_name not in mesh.axis_names or mesh.axis_size(axis_name) == 1:
        return moe_ffn(x, gate_w, w1, b1, w2, b2, top_k=top_k,
                       capacity_factor=capacity_factor,
                       activation=activation,
                       normalize_gates=normalize_gates, capacity=capacity)
    group = mesh.group(axis_name)
    local = [scatter_to_group(a, group, 0) for a in (w1, b1, w2, b2)]
    return _moe(x, gate_w, *local, w1.shape[0], group, top_k,
                capacity_factor, activation, normalize_gates, capacity)


def moe_ffn_alltoall(x, gate_w, w1, b1, w2, b2, mesh, *, axis_name="ep",
                     top_k=2, capacity=None, normalize_gates=True,
                     activation="relu"):
    """Expert-parallel MoE FFN with the dispatch and combine all-to-alls
    written out, one expert a shard of ``axis_name``.  x (N, D) with N
    divisible by the axis; w1 (E, D, H) etc. with E the axis size.
    Global arrays in, ``(y, aux_loss)`` out on every rank.  Equal to
    ``moe_ffn`` when ``capacity`` is large enough that no expert drops a
    token."""
    group = mesh.group(axis_name) if axis_name in mesh.axis_names else None
    n_shards = mesh.axis_size(axis_name)
    num_experts = w1.shape[0]
    if num_experts != n_shards:
        raise MXNetError(
            f"moe_ffn_alltoall needs one expert per '{axis_name}' shard "
            f"(experts={num_experts}, axis={n_shards})")
    n_tokens = x.shape[0]
    if n_tokens % n_shards:
        raise MXNetError(
            f"moe_ffn_alltoall needs tokens ({n_tokens}) divisible by "
            f"the '{axis_name}' axis ({n_shards})")
    if capacity is None:
        # every local token could route to one expert: no drops
        capacity = n_tokens // n_shards
    xl = scatter_to_group(x, group, 0)
    gw = copy_to_group(gate_w, group)
    w1l, b1l, w2l, b2l = (scatter_to_group(a, group, 0)
                          for a in (w1, b1, w2, b2))
    probs = torch.softmax(xl @ gw, dim=-1)
    dispatch, combine = _dispatch_tensors(probs, top_k, capacity,
                                          normalize_gates)
    # (E, C, D) slabs out: each rank then holds its expert's tokens
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xl)
    recv = all_to_all(expert_in, group, 0, 1)
    out_e = _experts(recv, w1l, b1l, w2l, b2l, activation)
    back = all_to_all(out_e, group, 1, 0)
    y = torch.einsum("nec,ecd->nd", combine, back)
    frac = reduce_from_group(dispatch.sum(dim=(0, 2)), group) / n_tokens
    mean_probs = reduce_from_group(probs.sum(0), group) / n_tokens
    aux = num_experts * torch.sum(frac * mean_probs)
    return gather_from_group(y, group, 0, n_tokens), aux


class MoELayer(Block):
    """Expert-parallel FFN block: the stacked expert weights carry
    ``(axis, None, None)`` shardings, so a step on a mesh with that axis
    cuts them and the forward runs this rank's experts
    (``moe_ffn_sharded``'s body).  After each forward ``aux_loss`` holds
    the load-balance loss, pre-scaled by ``aux_loss_weight``."""

    _writes_collectives = True

    def __init__(self, dim, hidden_dim, num_experts, *, top_k=2,
                 capacity_factor=1.25, activation="relu",
                 aux_loss_weight=0.01, axis="ep", **kwargs):
        super().__init__(**kwargs)
        self._num_experts = num_experts
        self._top_k = top_k
        self._cf = capacity_factor
        self._act = activation
        self._aux_w = aux_loss_weight
        self.aux_loss = None
        with self.name_scope():
            self.gate_w = self.params.get("gate_weight",
                                          shape=(dim, num_experts))
            self.w1 = self.params.get("expert1_weight",
                                      shape=(num_experts, dim, hidden_dim))
            self.b1 = self.params.get("expert1_bias",
                                      shape=(num_experts, hidden_dim),
                                      init="zeros")
            self.w2 = self.params.get("expert2_weight",
                                      shape=(num_experts, hidden_dim, dim))
            self.b2 = self.params.get("expert2_bias",
                                      shape=(num_experts, dim),
                                      init="zeros")
            self.w1.sharding = (axis, None, None)
            self.b1.sharding = (axis, None)
            self.w2.sharding = (axis, None, None)
            self.b2.sharding = (axis, None)

    def forward(self, x):
        arrays = [p.local_data()._data for p in (self.gate_w, self.w1,
                                                 self.b1, self.w2, self.b2)]
        y, aux = _moe(x._data, *arrays, self._num_experts,
                      cut_group(self.w1, 0), self._top_k, self._cf,
                      self._act, True, None)
        self.aux_loss = NDArray(aux * self._aux_w, x.context)
        return NDArray(y, x.context)
