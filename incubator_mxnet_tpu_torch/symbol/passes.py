"""Graph pass manager over the symbolic IR (counterpart of
``incubator_mxnet_tpu/symbol/passes.py``; reference nnvm passes run by
the graph executor, src/executor/graph_executor.cc).

The same API (``apply_pass(graph, "InferShape", data=(4, 8))`` returns a
Graph whose ``attrs`` carry the results; ``apply_passes`` routes shapes,
dtypes and storage types to their passes) and the same passes:

* InferShape, InferType, InferStorageType (with its per-op storage
  rules): graph walks, as in the JAX package; InferType runs the bound
  graph on ``meta`` tensors where JAX uses ``jax.eval_shape``;
* Gradient: a callable ``grad_fn(arrays) -> (outs, grads)`` and
  ``backward_op_count``, here the count of nodes in the autograd graph
  of one forward (the JAX package counts the jaxpr's equations of the
  forward and backward, so the two counts differ);
* PlanMemory: ``argument_size`` and ``output_size`` exactly as the JAX
  package's own accounting of the avals; with ``ctx=`` a CUDA context,
  also ``temp_size``, the peak bytes one eval forward allocates on the
  card beyond its arguments and outputs (``torch.cuda`` memory stats,
  where the JAX package reads XLA's buffer assignment);
* FuseBatchNormRelu: BatchNorm -> Activation(relu) pairs into the port's
  ``_FusedBatchNormRelu``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, registry, torch_dtype
from .symbol import _Plan

__all__ = ["Graph", "register_pass", "apply_pass", "apply_passes",
           "list_passes", "register_storage_rule"]

_PASSES = registry("graph_pass")


class Graph:
    """A symbol plus accumulated pass attributes (nnvm::Graph role)."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.attrs = {}

    def __repr__(self):
        return f"<Graph {sorted(self.attrs)}>"


def register_pass(name, fn=None):
    if fn is None:
        return lambda f: register_pass(name, f)
    _PASSES.register(name, fn)
    return fn


def list_passes():
    return list(_PASSES.names())


def apply_pass(graph, name, **kwargs):
    """Run one pass; accepts a Symbol or a Graph, returns the Graph
    (nnvm::ApplyPass)."""
    if not isinstance(graph, Graph):
        graph = Graph(graph)
    fn = _PASSES.find(name)
    if fn is None:
        raise MXNetError(
            f"unknown graph pass {name!r} (have {list_passes()})")
    fn(graph, **kwargs)
    return graph


def apply_passes(graph, names, shapes=None, dtypes=None, stypes=None):
    """Run passes in order with explicitly routed per-pass inputs:
    ``shapes`` feed InferShape, ``dtypes`` feed InferType, ``stypes``
    feed InferStorageType; other passes take no inputs."""
    routed = {"InferShape": shapes, "InferType": dtypes,
              "InferStorageType": stypes}
    for name in names:
        graph = apply_pass(graph, name, **(routed.get(name) or {}))
    return graph


def _signature(graph, what):
    """(names, shapes, dtypes) of the graph's arguments then auxiliary
    states, from an earlier InferShape (and InferType)."""
    sym = graph.symbol
    names = sym.list_arguments() + sym.list_auxiliary_states()
    arg_shapes = graph.attrs.get("arg_shapes")
    if arg_shapes is None:
        raise MXNetError(f"{what}: run InferShape first")
    shapes = list(arg_shapes) + list(graph.attrs.get("aux_shapes") or [])
    dtypes = (list(graph.attrs.get("arg_types") or []) +
              list(graph.attrs.get("aux_types") or [])) or \
        [np.float32] * len(names)
    for name, shape in zip(names, shapes):
        if shape is None:
            raise MXNetError(f"{what}: unknown shape for {name}")
    return names, [tuple(s) for s in shapes], \
        [np.dtype(d) for d in dtypes]


def _tensors(shapes, dtypes, device):
    return [torch.zeros(s, dtype=torch_dtype(d), device=device)
            for s, d in zip(shapes, dtypes)]


# ------------------------------------------------------------- InferShape
@register_pass("InferShape")
def _infer_shape_pass(graph, **shapes):
    """Shape inference (reference InferShape pass,
    src/executor/infer_graph_attr_pass.cc). Stores arg/out/aux shapes."""
    arg_shapes, out_shapes, aux_shapes = graph.symbol.infer_shape(**shapes)
    graph.attrs["shape_inputs"] = dict(shapes)
    graph.attrs["arg_shapes"] = arg_shapes
    graph.attrs["out_shapes"] = out_shapes
    graph.attrs["aux_shapes"] = aux_shapes


# -------------------------------------------------------------- InferType
@register_pass("InferType")
def _infer_type_pass(graph, **dtypes):
    """Dtype inference by running the graph on ``meta`` tensors
    (reference InferType pass).  Requires InferShape to have run;
    unspecified arg dtypes default to float32."""
    sym = graph.symbol
    names = sym.list_arguments() + sym.list_auxiliary_states()
    if graph.attrs.get("arg_shapes") is None:
        raise MXNetError("InferType: run InferShape first")
    graph.attrs.pop("arg_types", None)
    graph.attrs.pop("aux_types", None)
    _, shapes, _ = _signature(graph, "InferType")
    arg_dtypes = [np.dtype(dtypes.get(n, np.float32)) for n in names]
    meta = torch.device("meta")
    with torch.no_grad():
        outs, _ = _Plan(sym, names, meta).run(
            _tensors(shapes, arg_dtypes, meta), True)
    n_args = len(sym.list_arguments())
    graph.attrs["arg_types"] = arg_dtypes[:n_args]
    graph.attrs["aux_types"] = arg_dtypes[n_args:]
    graph.attrs["out_types"] = [np.dtype(str(o.dtype).replace("torch.", ""))
                                for o in outs]


# ------------------------------------------------------- InferStorageType
# op name -> fn(input_stypes, attrs) -> (out_stype, dispatch_mode)
_STORAGE_RULES = {}


def register_storage_rule(op_name, fn=None):
    """Per-op storage inference rule (reference FInferStorageType,
    include/mxnet/op_attr_types.h:258)."""
    if fn is None:
        return lambda f: register_storage_rule(op_name, f)
    _STORAGE_RULES[op_name] = fn
    return fn


@register_pass("InferStorageType")
def _infer_storage_pass(graph, **stypes):
    """Storage-type inference + dispatch-mode assignment (reference
    InferStorageType pass + DispatchMode, op_attr_types.h:105-126): an
    op touched by a sparse input dispatches as 'fallback' (densify ->
    dense compute) unless its rule says otherwise."""
    sym = graph.symbol
    var_stypes = {n: stypes.get(n, "default")
                  for n in sym.list_arguments() + sym.list_auxiliary_states()}
    node_modes = {}
    node_stypes = {}
    for node in sym._topo():
        if node.is_var or node._view_of is not None:
            # views share the base node's storage/dispatch
            continue
        in_stypes = []
        for inp in node._inputs:
            if inp.is_var:
                in_stypes.append(var_stypes.get(inp._name, "default"))
            else:
                in_stypes.append(node_stypes.get(id(inp._base()), "default"))
        rule = _STORAGE_RULES.get(node._op.name)
        if rule is not None:
            out_stype, mode = rule(in_stypes, dict(node._attrs))
        elif any(s != "default" for s in in_stypes):
            out_stype, mode = "default", "fallback"
        else:
            out_stype, mode = "default", "fcompute"
        node_stypes[id(node)] = out_stype
        node_modes[node._name] = mode
    graph.attrs["arg_stypes"] = [var_stypes[n]
                                 for n in sym.list_arguments()]
    graph.attrs["dispatch_modes"] = node_modes
    graph.attrs["out_stypes"] = [
        node_stypes.get(id(r._base()), var_stypes.get(r._name, "default"))
        for r in sym._roots()]


# --------------------------------------------------------------- Gradient
def _count_nodes(outs):
    """Nodes of the autograd graph behind ``outs``."""
    seen, stack = set(), [o.grad_fn for o in outs if o.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return len(seen)


@register_pass("Gradient")
def _gradient_pass(graph):
    """Whole-graph gradient construction (reference Gradient pass invoked
    by InitFullGraph, graph_executor.cc:249).  Artifacts: ``grad_fn``,
    arrays -> (outs, gradients of every argument and auxiliary state
    against ones), and ``backward_op_count``, the autograd nodes of one
    forward (on ``meta`` tensors)."""
    sym = graph.symbol
    names, shapes, dtypes = _signature(graph, "Gradient")

    def run(tensors):
        plan = _Plan(sym, names, tensors[0].device if tensors
                     else torch.device("cpu"))
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in tensors]
        with torch.enable_grad():
            outs, _ = plan.run(leaves, True)
        return outs, leaves

    def fwd_bwd(arrays):
        outs, leaves = run([torch.as_tensor(np.asarray(a)) for a in arrays])
        heads = [o for o in outs if o.requires_grad]
        wanted = [x for x in leaves if x.requires_grad]
        got = iter(torch.autograd.grad(
            heads, wanted, [torch.ones_like(o) for o in heads],
            allow_unused=True) if heads and wanted else ())
        grads = []
        for x in leaves:
            g = next(got) if x.requires_grad else None
            grads.append((torch.zeros_like(x) if g is None else g)
                         .detach().numpy())
        return [o.detach().numpy() for o in outs], grads

    outs, _ = run(_tensors(shapes, dtypes, torch.device("meta")))
    graph.attrs["grad_fn"] = fwd_bwd
    graph.attrs["backward_op_count"] = _count_nodes(outs)


# ------------------------------------------------------------- PlanMemory
def _nbytes(shapes, dtypes):
    return int(sum(np.prod(s, dtype=np.int64) * np.dtype(d).itemsize
                   for s, d in zip(shapes, dtypes)))


@register_pass("PlanMemory")
def _plan_memory_pass(graph, ctx=None):
    """Memory planning (reference PlanMemory pass, graph_executor.cc:903).
    ``argument_size`` and ``output_size``: the bytes of the arguments and
    auxiliary states, and of the eval forward's outputs.  With ``ctx``
    a CUDA context, ``temp_size``: the peak bytes one eval forward on
    zeros allocates on that card beyond them."""
    sym = graph.symbol
    names, shapes, dtypes = _signature(graph, "PlanMemory")
    meta = torch.device("meta")
    with torch.no_grad():
        outs, _ = _Plan(sym, names, meta).run(
            _tensors(shapes, dtypes, meta), False)
    mem = {"argument_size": _nbytes(shapes, dtypes),
           "output_size": int(sum(o.numel() * o.element_size()
                                  for o in outs))}
    device = ctx.torch_device() if ctx is not None else None
    if device is not None and device.type == "cuda":
        tensors = _tensors(shapes, dtypes, device)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with torch.no_grad():
            outs, _ = _Plan(sym, names, device).run(tensors, False)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        mem["temp_size"] = int(peak - base - mem["output_size"])
        del outs, tensors
    graph.attrs["memory"] = mem


# built-in storage rules: the sparse-aware update/embedding paths keep
# their semantics instead of the generic densify fallback
@register_storage_rule("sgd_update")
@register_storage_rule("sgd_mom_update")
@register_storage_rule("adam_update")
def _sparse_update_rule(in_stypes, attrs):
    if in_stypes and in_stypes[1] == "row_sparse":
        return "default", "fcompute_ex"   # lazy row-wise update path
    if any(s != "default" for s in in_stypes):
        return "default", "fallback"
    return "default", "fcompute"


@register_storage_rule("cast_storage")
def _cast_storage_rule(in_stypes, attrs):
    return attrs.get("stype", "default"), "fcompute_ex"


@register_storage_rule("dot")
def _dot_rule(in_stypes, attrs):
    if in_stypes and in_stypes[0] == "csr":
        return "default", "fcompute_ex"   # CSR x dense sparse dot
    if any(s != "default" for s in in_stypes):
        return "default", "fallback"
    return "default", "fcompute"


# ------------------------------------------------- operator fusion passes
@register_pass("FuseBatchNormRelu")
def _fuse_bn_relu_pass(graph):
    """Operator-fusion pass: rewrite BatchNorm -> Activation(relu) pairs
    into the _FusedBatchNormRelu op (same math, the lean backward of
    ``ops.nn.fused_batch_norm_relu``).  A pair fuses only when the
    BatchNorm feeds that one Activation (no other consumer, not a graph
    output, no output_mean_var request).  Parameter and aux names are
    preserved (the fused node keeps the BatchNorm's name), so bound
    checkpoints interchange.  Records graph.attrs['num_fused_bn_relu']."""
    from ..ops import find_op
    from .symbol import Symbol

    sym = graph.symbol
    roots = []
    for r in sym._roots():
        roots.append(r)
        if r._view_of is not None:
            roots.append(r._view_of)
    root_ids = {id(r) for r in roots}
    consumers = {}
    for node in sym._topo():
        for i in node._inputs:
            consumers[id(i)] = consumers.get(id(i), 0) + 1
        if node._view_of is not None:
            consumers[id(node._view_of)] = \
                consumers.get(id(node._view_of), 0) + 1
    fused_op = find_op("_FusedBatchNormRelu")
    memo = {}
    count = [0]

    def rebuild(node):
        got = memo.get(id(node))
        if got is not None:
            return got
        if (node._op is not None and node._op.name == "Activation"
                and str(node._attrs.get("act_type")) == "relu"
                and len(node._inputs) == 1):
            src = node._inputs[0]
            if (src._op is not None
                    and src._op.name in ("BatchNorm", "BatchNorm_v1")
                    and consumers.get(id(src), 0) == 1
                    and id(src) not in root_ids
                    and not src._attrs.get("output_mean_var", False)):
                new = Symbol(op=fused_op, name=src._name,
                             inputs=[rebuild(i) for i in src._inputs],
                             attrs=dict(src._attrs), num_outputs=1,
                             attr_dict=dict(src._attr_dict))
                count[0] += 1
                memo[id(node)] = new
                memo[id(src)] = new   # safe: this Activation was the
                #                       BatchNorm's only consumer
                return new
        new_inputs = [rebuild(i) for i in node._inputs]
        view_of = rebuild(node._view_of) \
            if node._view_of is not None else None
        if node._outputs_group is not None:
            outs = [rebuild(o) for o in node._outputs_group]
            # identity comparison: Symbol __eq__ is the elementwise op
            if all(a is b for a, b in zip(outs, node._outputs_group)):
                memo[id(node)] = node
                return node
            new = Symbol(name=node._name)
            new._outputs_group = outs
            memo[id(node)] = new
            return new
        if view_of is node._view_of and \
                len(new_inputs) == len(node._inputs) and \
                all(a is b for a, b in zip(new_inputs, node._inputs)):
            memo[id(node)] = node
            return node
        new = Symbol(op=node._op, name=node._name, inputs=new_inputs,
                     attrs=dict(node._attrs), out_index=node._out_index,
                     num_outputs=node._num_outputs,
                     attr_dict=dict(node._attr_dict), view_of=view_of)
        memo[id(node)] = new
        return new

    graph.symbol = rebuild(sym)
    graph.attrs["num_fused_bn_relu"] = count[0]
