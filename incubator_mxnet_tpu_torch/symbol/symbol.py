"""Symbol — the declarative graph API of the port (counterpart of
``incubator_mxnet_tpu/symbol/symbol.py``; reference
python/mxnet/symbol/symbol.py + nnvm Symbol/Graph).

A Symbol is a node in an operator DAG (op name + static attrs + input
symbols); variables are leaves.  The graph, its names, listings, JSON
format, parameter-shape rules and composition follow the JAX package
line for line, so a ``-symbol.json`` written by either package loads in
the other.  What differs is how a bound graph runs: the JAX executor
traces the DAG into one jitted program; here ``_Plan`` turns it, once
at bind, into a flat list of steps (op function, attributes for train
and eval, input slots) that ``_Plan.run`` replays eagerly on tensors,
with torch autograd recording when gradients are wanted.

``infer_shape`` applies the per-op parameter-shape rules (the
reference's FInferShape, ``_ARG_SHAPE_RULES``) and then runs each op on
``meta`` tensors, where the JAX package uses ``jax.eval_shape``; the
fused ops take their plain composition on ``meta``, so shape inference
never reaches a kernel wrapper.  An op that cannot run on ``meta`` runs
on zeros on the CPU instead.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..base import MXNetError
from ..name import NameManager
from ..ops import find_op, get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]

# ops whose trailing inputs are auxiliary states (not gradient targets) —
# reference: MXNET_REGISTER_OP mutable inputs (batch_norm.cc aux states).
# _FusedBNReluConv is not listed: its moving statistics are arguments,
# as in the JAX package
_AUX_INPUTS = {
    "BatchNorm": ("moving_mean", "moving_var"),
    "BatchNorm_v1": ("moving_mean", "moving_var"),
    "_FusedBatchNormRelu": ("moving_mean", "moving_var"),
}
# ops whose moving statistics the executor folds in training
_FOLDS_STATS = ("BatchNorm", "_FusedBatchNormRelu")
_OUTPUT_OPS = ("SoftmaxOutput", "LinearRegressionOutput",
               "LogisticRegressionOutput", "MAERegressionOutput",
               "SVMOutput")


# per-op parameter-argument shape rules:
# (input_shape, attrs) -> {arg_name: shape}
# mirrors reference FInferShape for parameterized ops
def _fc_shapes(shapes, attrs):
    data = shapes["data"]
    num_hidden = attrs["num_hidden"]
    in_units = int(np.prod(data[1:])) if attrs.get("flatten", True) \
        else data[-1]
    out = {"weight": (num_hidden, in_units)}
    if not attrs.get("no_bias", False):
        out["bias"] = (num_hidden,)
    return out


def _conv_shapes(shapes, attrs):
    data = shapes["data"]
    kernel = tuple(attrs["kernel"])
    num_filter = attrs["num_filter"]
    num_group = attrs.get("num_group", 1)
    layout = attrs.get("layout") or "NCHW"
    c_axis = layout.find("C") if isinstance(layout, str) else 1
    in_c = data[c_axis]
    out = {"weight": (num_filter, in_c // num_group) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (num_filter,)
    return out


def _deconv_shapes(shapes, attrs):
    data = shapes["data"]
    kernel = tuple(attrs["kernel"])
    num_filter = attrs["num_filter"]
    num_group = attrs.get("num_group", 1)
    in_c = data[1]
    out = {"weight": (in_c, num_filter // num_group) + kernel}
    if not attrs.get("no_bias", True):
        out["bias"] = (num_filter,)
    return out


def _bn_shapes(shapes, attrs):
    c = shapes["data"][attrs.get("axis", 1)]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _fused_conv_shapes(shapes, attrs):
    """``_FusedBNReluConv``: its BatchNorm's rule over the layout's
    channel axis, then its conv's.  The JAX package has no rule for this
    op (its infer_shape needs every parameter's shape given)."""
    layout = attrs.get("layout") or "NCHW"
    c = shapes["data"][layout.find("C")]
    out = {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
           "moving_var": (c,)}
    out.update(_conv_shapes(shapes, attrs))
    return out


def _norm_shapes(shapes, attrs):
    c = shapes["data"][attrs.get("axis", -1)]
    return {"gamma": (c,), "beta": (c,)}


def _embed_shapes(shapes, attrs):
    return {"weight": (attrs["input_dim"], attrs["output_dim"])}


def _rnn_shapes(shapes, attrs):
    from ..ops.rnn import rnn_param_size
    _, n, input_size = shapes["data"]
    bidirectional = attrs.get("bidirectional", False)
    size = rnn_param_size(attrs["num_layers"], input_size,
                          attrs["state_size"], bidirectional, attrs["mode"])
    st = (attrs["num_layers"] * (2 if bidirectional else 1), n,
          attrs["state_size"])
    out = {"parameters": (size,), "state": st}
    if attrs["mode"] == "lstm":
        out["state_cell"] = st
    return out


def _softmax_out_shapes(shapes, attrs):
    """Label shape from data shape (reference SoftmaxOutputShape,
    src/operator/softmax_output-inl.h)."""
    data = shapes["data"]
    if attrs.get("multi_output", False):
        return {"label": (data[0],) + tuple(data[2:])}
    if attrs.get("preserve_shape", False):
        return {"label": tuple(data[:-1])}
    return {"label": (data[0],)}


def _regression_out_shapes(shapes, attrs):
    return {"label": tuple(shapes["data"])}


def _svm_out_shapes(shapes, attrs):
    return {"label": (shapes["data"][0],)}


_ARG_SHAPE_RULES = {
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "Deconvolution": _deconv_shapes,
    "BatchNorm": _bn_shapes,
    "BatchNorm_v1": _bn_shapes,
    "_FusedBatchNormRelu": _bn_shapes,
    "_FusedBNReluConv": _fused_conv_shapes,
    "InstanceNorm": _norm_shapes,
    "LayerNorm": _norm_shapes,
    "Embedding": _embed_shapes,
    "RNN": _rnn_shapes,
    "SoftmaxOutput": _softmax_out_shapes,
    "LinearRegressionOutput": _regression_out_shapes,
    "LogisticRegressionOutput": _regression_out_shapes,
    "MAERegressionOutput": _regression_out_shapes,
    "SVMOutput": _svm_out_shapes,
}


def _node_attrs(node, is_train, device):
    """The attributes node's op is called with: ``is_train`` injected
    where the op takes it and the node does not set it, ``device`` for
    the ops that place their output."""
    attrs = {k: v for k, v in node._attrs.items() if v is not None}
    if "is_train" in node._op.attr_names and "is_train" not in attrs:
        attrs["is_train"] = is_train
    if "device" in node._op.attr_names and "device" not in attrs:
        attrs["device"] = device
    return attrs


class _Step:
    """One op node of a plan: the op, its attributes in train and eval
    form, its input slots and its output slot.  ``single`` marks a node
    of one visible output whose op returns several (BatchNorm's
    ``(out, mean, var)``): the step keeps the first, and ``fold`` lists
    the ``(slot, name)`` of the moving statistics it folds in
    training.  ``free``: the slots no later step reads, dropped after
    this one."""

    __slots__ = ("op", "attrs", "ins", "out", "view", "single", "fold",
                 "momentum", "free")

    def __init__(self, node, ins, out, device):
        self.op = node._op
        self.ins = ins
        self.out = out
        self.view = None
        self.attrs = {True: _node_attrs(node, True, device),
                      False: _node_attrs(node, False, device)}
        self.single = node._num_outputs == 1
        self.fold = ()
        self.momentum = node._attrs.get("momentum", 0.9)


class _Plan:
    """A bound graph as a flat list of steps over slots: the first
    ``len(names)`` slots hold the arguments and auxiliary states (in
    ``names`` order), then one slot per node.  Built once at bind.  A
    node's output is dropped after the last step that reads it (the
    outputs of the graph are kept), so an eval forward holds only the
    live activations, as XLA's buffer assignment reuses them."""

    def __init__(self, symbol, names, device):
        slot = {n: i for i, n in enumerate(names)}
        where = {}
        self.steps = []
        nxt = len(names)
        for node in symbol._topo():
            if node.is_var:
                if node._name not in slot:
                    raise MXNetError(f"bind: missing argument {node._name}")
                where[id(node)] = slot[node._name]
                continue
            if node._view_of is not None:
                step = _Step.__new__(_Step)
                step.view = node._out_index
                step.ins = [where[id(node._view_of)]]
            else:
                step = _Step(node, [where[id(i)] for i in node._inputs],
                             nxt, device)
                if node._op.name in _FOLDS_STATS and step.single:
                    step.fold = tuple(
                        (where[id(i)], i._name) for i in node._inputs[3:5]
                        if i.is_var)
            step.out = nxt
            where[id(node)] = nxt
            nxt += 1
            self.steps.append(step)
        self.size = nxt
        self.roots = [where[id(r)] for r in symbol._roots()]
        self.device = device
        last = {}
        for i, step in enumerate(self.steps):
            for s in step.ins:
                last[s] = i
        keep = set(self.roots) | set(range(len(names)))
        for step in self.steps:
            step.free = ()
        for s, i in last.items():
            if s not in keep:
                self.steps[i].free += (s,)

    def run(self, arrays, is_train):
        """Replay the graph on ``arrays`` (tensors in ``names`` order).
        Returns (outputs, {aux name: folded moving statistic})."""
        from .. import random as _random
        env = list(arrays) + [None] * (self.size - len(arrays))
        updates = {}
        grad_on = torch.is_grad_enabled()
        for st in self.steps:
            if st.view is not None:
                env[st.out] = env[st.ins[0]][st.view]
                for s in st.free:
                    env[s] = None
                continue
            args = [env[i] for i in st.ins]
            if st.op.needs_rng:
                args.insert(0, None if self.device.type == "meta"
                            else _random.generator(self.device))
            attrs = st.attrs[is_train]
            if grad_on and not st.op.differentiable:
                with torch.no_grad():
                    raw = st.op.fn(*args, **attrs)
            else:
                raw = st.op.fn(*args, **attrs)
            if st.single and isinstance(raw, (tuple, list)):
                if st.fold and is_train and \
                        not attrs.get("use_global_stats", False):
                    m = st.momentum
                    with torch.no_grad():
                        for (s, name), stat in zip(st.fold, raw[1:3]):
                            updates[name] = m * env[s].detach() + \
                                (1 - m) * stat.detach()
                raw = raw[0]
            env[st.out] = raw
            for s in st.free:
                env[s] = None
        outs = []
        for r in self.roots:
            raw = env[r]
            if isinstance(raw, (tuple, list)):
                outs.extend(raw)
            else:
                outs.append(raw)
        return outs, updates


def _meta_eval(node, in_shapes):
    """Output shape(s) of ``node`` on inputs of ``in_shapes`` (float32):
    its op run on ``meta`` tensors, or on zeros on the CPU when the op
    cannot run on ``meta``."""
    with torch.no_grad():
        for device in (torch.device("meta"), torch.device("cpu")):
            args = [torch.zeros(s, dtype=torch.float32, device=device)
                    for s in in_shapes]
            if node._op.needs_rng:
                args.insert(0, None if device.type == "meta"
                            else torch.Generator())
            try:
                raw = node._op.fn(*args, **_node_attrs(node, True, device))
            except Exception:
                if device.type == "cpu":
                    raise
                continue
            if isinstance(raw, (tuple, list)):
                if node._num_outputs == 1:
                    return tuple(raw[0].shape)   # BatchNorm's (out, ...)
                return [tuple(r.shape) for r in raw]
            return tuple(raw.shape)


class Symbol:
    """A node in the symbolic graph (reference symbol.py:Symbol)."""

    def __init__(self, op=None, name=None, inputs=None, attrs=None,
                 out_index=None, num_outputs=1, attr_dict=None,
                 view_of=None):
        self._op = op                  # None for variables / groups
        self._name = name
        self._inputs = inputs or []    # list[Symbol]
        self._attrs = attrs or {}      # static op attributes
        self._out_index = out_index    # int for single-output view
        self._view_of = view_of        # base multi-output node for views
        self._num_outputs = num_outputs
        self._attr_dict = attr_dict or {}   # user attrs (__lr_mult__ etc.)
        self._outputs_group = None     # list[Symbol] for Group

    # ----------------------------------------------------------- basics
    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attr_dict.get(key)

    def _set_attr(self, **kwargs):
        self._attr_dict.update(kwargs)

    def attr_dict(self):
        out = {}
        for node in self._topo():
            if node._attr_dict:
                out[node._name] = {k: str(v)
                                   for k, v in node._attr_dict.items()}
        return out

    def list_attr(self):
        return {k: str(v) for k, v in self._attr_dict.items()}

    @property
    def is_var(self):
        return self._op is None and self._outputs_group is None

    # ------------------------------------------------------- graph walk
    def _roots(self):
        return self._outputs_group if self._outputs_group is not None \
            else [self]

    def _topo(self):
        seen = set()
        order = []

        def visit(s):
            if id(s) in seen:
                return
            seen.add(id(s))
            if s._view_of is not None:
                visit(s._view_of)
            for i in s._inputs:
                visit(i)
            order.append(s)
        for r in self._roots():
            visit(r)
        return order

    def list_arguments(self):
        """All leaf variable names except aux states, in topo order
        (reference symbol.py list_arguments)."""
        aux = set(self.list_auxiliary_states())
        return [s._name for s in self._topo() if s.is_var
                and s._name not in aux]

    def list_auxiliary_states(self):
        out = []
        for s in self._topo():
            if s._op is None:
                continue
            aux_names = _AUX_INPUTS.get(s._op.name, ())
            if not aux_names:
                continue
            arg_names = s._op.arg_names
            for i, inp in enumerate(s._inputs):
                if i < len(arg_names) and arg_names[i] in aux_names \
                        and inp.is_var:
                    out.append(inp._name)
        return out

    def list_outputs(self):
        names = []
        for r in self._roots():
            if r._out_index is not None:
                names.append(f"{r._name}_output{r._out_index}")
            else:
                n = r._num_outputs
                if n == 1:
                    names.append(f"{r._name}_output" if r._op else r._name)
                else:
                    names.extend(f"{r._name}_output{i}" for i in range(n))
        return names

    def list_inputs(self):
        return [s._name for s in self._topo() if s.is_var]

    def get_internals(self):
        """Group of every node's outputs (reference get_internals)."""
        return Group(self._topo())

    def __getitem__(self, index):
        if self._outputs_group is not None:
            if isinstance(index, str):
                names = self.list_outputs()
                matches = [i for i, n in enumerate(names)
                           if n == index or n.rsplit("_output", 1)[0] == index]
                if len(matches) != 1:
                    raise MXNetError(f"cannot resolve output {index!r}")
                index = matches[0]
            return self._outputs_group[index]
        if isinstance(index, str):
            for s in self._topo():
                if s._name == index:
                    return s
            raise MXNetError(f"no internal symbol named {index!r}")
        if self._num_outputs == 1:
            if index != 0:
                raise MXNetError("index out of range")
            return self
        if index >= self._num_outputs:
            raise MXNetError("index out of range")
        return Symbol(op=self._op, name=self._name, out_index=index,
                      num_outputs=self._num_outputs,
                      attr_dict=self._attr_dict, view_of=self)

    def __iter__(self):
        n = len(self._outputs_group) if self._outputs_group is not None \
            else self._num_outputs
        return (self[i] for i in range(n))

    def __len__(self):
        return len(self.list_outputs())

    def __repr__(self):
        return f"<Symbol {self._name}>"

    # ------------------------------------------------------- arithmetic
    _SCALAR_OPS = {
        "broadcast_add": "_plus_scalar", "broadcast_sub": "_minus_scalar",
        "broadcast_mul": "_mul_scalar", "broadcast_div": "_div_scalar",
        "broadcast_power": "_power_scalar", "broadcast_mod": "_mod_scalar",
        "broadcast_equal": "_equal_scalar",
        "broadcast_not_equal": "_not_equal_scalar",
        "broadcast_greater": "_greater_scalar",
        "broadcast_greater_equal": "_greater_equal_scalar",
        "broadcast_lesser": "_lesser_scalar",
        "broadcast_lesser_equal": "_lesser_equal_scalar"}
    _REVERSED = {"_minus_scalar": "_rminus_scalar",
                 "_div_scalar": "_rdiv_scalar",
                 "_power_scalar": "_rpower_scalar",
                 "_mod_scalar": "_rmod_scalar"}

    def _bin(self, other, opname, rev=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if rev else (self, other)
            return _create(opname, [a, b], {})
        sname = self._SCALAR_OPS.get(opname, opname + "_scalar")
        if rev:
            sname = self._REVERSED.get(sname, sname)
        return _create(sname, [self], {"scalar": float(other)})

    def __add__(self, o): return self._bin(o, "broadcast_add")
    def __radd__(self, o): return self._bin(o, "broadcast_add")
    def __sub__(self, o): return self._bin(o, "broadcast_sub")
    def __rsub__(self, o): return self._bin(o, "broadcast_sub", rev=True)
    def __mul__(self, o): return self._bin(o, "broadcast_mul")
    def __rmul__(self, o): return self._bin(o, "broadcast_mul")
    def __truediv__(self, o): return self._bin(o, "broadcast_div")
    def __rtruediv__(self, o): return self._bin(o, "broadcast_div", rev=True)
    def __pow__(self, o): return self._bin(o, "broadcast_power")
    def __neg__(self): return _create("negative", [self], {})

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._bin(o, "broadcast_equal")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._bin(o, "broadcast_not_equal")
        return NotImplemented

    __hash__ = object.__hash__

    # ---------------------------------------------------------- compute
    def _base(self):
        """Underlying multi-output node for an out_index view."""
        return self._view_of if self._view_of is not None else self

    def infer_shape(self, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from given input shapes
        (reference symbol.py infer_shape).  Unknown parameter-arg shapes
        are resolved by per-op rules, then each node runs on ``meta``
        tensors."""
        shapes = {k: tuple(v) for k, v in kwargs.items()}  # var -> shape
        node_out = {}          # id(node) -> shape or [shapes]

        def first(shape):
            return shape[0] if isinstance(shape, list) else shape

        for node in self._topo():
            if node.is_var:
                continue
            if node._view_of is not None:
                node_out[id(node)] = node_out[id(node._view_of)][
                    node._out_index]
                continue
            rule = _ARG_SHAPE_RULES.get(node._op.name)
            arg_names = node._op.arg_names
            if rule is not None:
                in_shapes = {}
                for i, inp in enumerate(node._inputs):
                    nm = arg_names[i] if i < len(arg_names) else f"in{i}"
                    if inp.is_var and inp._name in shapes:
                        in_shapes[nm] = shapes[inp._name]
                    elif not inp.is_var and id(inp) in node_out:
                        in_shapes[nm] = first(node_out[id(inp)])
                try:
                    derived = rule(in_shapes, node._attrs)
                except KeyError:
                    derived = {}
                for i, inp in enumerate(node._inputs):
                    nm = arg_names[i] if i < len(arg_names) else None
                    if inp.is_var and inp._name not in shapes \
                            and nm in derived:
                        shapes[inp._name] = tuple(derived[nm])
            ins = []
            for inp in node._inputs:
                shape = shapes.get(inp._name) if inp.is_var \
                    else node_out.get(id(inp))
                if shape is None:
                    raise MXNetError(
                        f"cannot infer shape at node {node._name}: missing "
                        "input shapes")
                ins.append(shape)
            node_out[id(node)] = _meta_eval(node, ins)

        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        out_shapes = []
        for r in self._roots():
            if r.is_var:
                out_shapes.append(shapes.get(r._name))
                continue
            got = node_out[id(r)]
            if isinstance(got, list):
                out_shapes.extend(got)
            else:
                out_shapes.append(got)
        return ([tuple(s) if s else None for s in arg_shapes], out_shapes,
                [tuple(shapes[n]) if n in shapes else None
                 for n in self.list_auxiliary_states()])

    def infer_type(self, **kwargs):
        args = self.list_arguments()
        return ([np.float32] * len(args), [np.float32] * len(self._roots()),
                [np.float32] * len(self.list_auxiliary_states()))

    def eval(self, ctx=None, **kwargs):
        """Evaluate with ndarray inputs (reference symbol.py eval)."""
        ex = self.bind(ctx, kwargs)
        return ex.forward(is_train=False)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, **kwargs):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", **input_shapes):
        """Allocate arguments from inferred shapes and bind
        (reference symbol.py:1278 simple_bind)."""
        from .. import ndarray as nd_mod
        arg_shapes, _, aux_shapes = self.infer_shape(**input_shapes)
        arg_names = self.list_arguments()
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise MXNetError(f"cannot infer shape of argument {name}")
            args[name] = nd_mod.zeros(shape, ctx=ctx)
        aux = {}
        for name, shape in zip(self.list_auxiliary_states(), aux_shapes):
            aux[name] = nd_mod.zeros(shape, ctx=ctx)
        args_grad = None
        if grad_req != "null":
            args_grad = {n: nd_mod.zeros(s, ctx=ctx)
                         for n, s in zip(arg_names, arg_shapes)
                         if not (n.endswith("_label") or n == "data"
                                 or n.endswith("_data"))}
        return self.bind(ctx, args, args_grad, grad_req, aux)

    # ------------------------------------------------------ persistence
    def tojson(self):
        """Serialize to the reference's JSON graph format
        (nnvm::Graph JSON: nodes with op/name/attrs/inputs, arg_nodes,
        heads — legacy loadable layout)."""
        order = [s for s in self._topo() if s._view_of is None]
        index = {id(s): i for i, s in enumerate(order)}

        def ref(i):
            base = i._base()
            return [index[id(base)], i._out_index or 0, 0]

        nodes = []
        for s in order:
            if s.is_var:
                node = {"op": "null", "name": s._name, "inputs": []}
            else:
                node = {
                    "op": s._op.name,
                    "name": s._name,
                    "attrs": {k: json.dumps(v) if not isinstance(v, str)
                              else v for k, v in s._attrs.items()},
                    "inputs": [ref(i) for i in s._inputs]}
            if s._attr_dict:
                # user attrs (ctx_group, __lr_mult__, ...) — reference
                # keeps these per node and they must survive save/load
                node["attr"] = {k: str(v) for k, v in s._attr_dict.items()}
            nodes.append(node)
        heads = [ref(r) for r in self._roots()]
        arg_nodes = [i for i, s in enumerate(order) if s.is_var]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10100]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ---------------------------------------------------------- fluent
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if find_op(name) is None:
            raise AttributeError(name)

        def method(*args, **kwargs):
            return _create(name, [self] + list(args), kwargs)
        return method


def _parse_attr_value(v):
    try:
        return json.loads(v)
    except (json.JSONDecodeError, TypeError):
        return v


def load_json(json_str):
    """Load a symbol from the JSON graph format (reference symbol.load_json +
    legacy upgrade, src/nnvm/legacy_json_util.cc)."""
    data = json.loads(json_str)
    built = []
    for node in data["nodes"]:
        if node["op"] == "null":
            built.append(var(node["name"], attr=node.get("attr")))
            continue
        inputs = [_output(built[nid], out_idx)
                  for (nid, out_idx, _) in node["inputs"]]
        attrs = {k: _parse_attr_value(v)
                 for k, v in (node.get("attrs") or
                              node.get("param") or {}).items()}
        sym = _create(node["op"], inputs, attrs, name=node["name"],
                      _explicit_inputs=True)
        if node.get("attr"):
            sym._attr_dict.update(node["attr"])
        built.append(sym)
    outs = [_output(built[nid], out_idx) for (nid, out_idx, _) in
            data.get("heads", [[len(built) - 1, 0, 0]])]
    return outs[0] if len(outs) == 1 else Group(outs)


def _output(node, index):
    """Output ``index`` of a loaded node: the node itself when it has one
    output, else its view.  (The JAX loader keeps the whole node for
    index 0, which feeds the next op all of a multi-output node's
    outputs, so a saved ``sym[0]`` of such a node does not run there.)"""
    return node[index] if node._num_outputs > 1 else node


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (reference symbol.py var/Variable)."""
    from ..attribute import AttrScope
    attr_dict = AttrScope.current().get(dict(attr or {}))
    if lr_mult is not None:
        attr_dict["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attr_dict["__wd_mult__"] = wd_mult
    if shape is not None:
        attr_dict["__shape__"] = tuple(shape)
    return Symbol(name=name, attr_dict=attr_dict)


Variable = var


def Group(symbols):
    """Group symbols into one multi-output symbol (reference symbol.Group)."""
    roots = []
    for s in symbols:
        roots.extend(s._roots())
    g = Symbol(name="group")
    g._outputs_group = roots
    return g


def _create(op_name, inputs, kwargs, name=None, _explicit_inputs=False):
    """Create an op node; auto-create variables for missing parameter inputs
    (the reference's symbol composition semantics: missing inputs become
    prefix-named variables, symbol.py compose)."""
    op = get_op(op_name)
    attrs = {}
    tensor_kwargs = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            tensor_kwargs[k] = v
        elif k == "name":
            name = v
        else:
            attrs[k] = v
    name = NameManager.current.get(name, op.name.lower().lstrip("_"))
    from ..attribute import AttrScope
    scope_attrs = AttrScope.current().get()

    ins = list(inputs)
    if not _explicit_inputs and (op.arg_names and not op.variadic):
        arg_names = list(op.arg_names)
        # positional inputs fill the first arg slots
        merged = {}
        for i, s in enumerate(ins):
            if i >= len(arg_names):
                raise MXNetError(f"too many inputs for op {op.name}")
            merged[arg_names[i]] = s
        merged.update(tensor_kwargs)
        ins = []
        for an in arg_names:
            if an in merged:
                ins.append(merged[an])
                continue
            # optionality rules mirroring op defaults
            if an == "bias" and attrs.get("no_bias", False):
                continue
            if an in ("sequence_length",) and not attrs.get(
                    "use_sequence_length", False):
                continue
            if an == "state_cell" and attrs.get("mode") != "lstm":
                continue
            if an in ("gamma",) and op.name == "LeakyReLU" and \
                    attrs.get("act_type", "leaky") != "prelu":
                continue
            if an == "label" and op.name in _OUTPUT_OPS:
                ins.append(var(f"{name}_label"))
                continue
            ins.append(var(f"{name}_{an}"))
    elif tensor_kwargs:
        ins.extend(tensor_kwargs.values())

    num_outputs = op.num_outputs if op.num_outputs else 1
    # special-case: reference-visible output counts
    if op.name == "SliceChannel":
        num_outputs = attrs.get("num_outputs", 1)
    if op.name == "RNN" and attrs.get("state_outputs", False):
        num_outputs = 3 if attrs.get("mode", "lstm") == "lstm" else 2
    if op.name in _FOLDS_STATS:
        num_outputs = 1  # the executor treats moving stats functionally

    return Symbol(op=op, name=name, inputs=ins, attrs=attrs,
                  num_outputs=num_outputs,
                  attr_dict=dict(scope_attrs) if scope_attrs else None)


def _make_sym_op(opname):
    def wrapper(*args, **kwargs):
        return _create(opname, list(args), kwargs)
    wrapper.__name__ = opname
    return wrapper
