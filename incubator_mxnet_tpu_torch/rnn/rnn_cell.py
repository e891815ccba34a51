"""Legacy symbolic RNN cells of the port (counterpart of
``incubator_mxnet_tpu/rnn/rnn_cell.py``; reference
python/mxnet/rnn/rnn_cell.py: BaseRNNCell :108, RNNCell, LSTMCell :408,
GRUCell, FusedRNNCell :536, SequentialRNNCell, BidirectionalCell,
DropoutCell, ZoneoutCell, ResidualCell).

Cells build Symbol graphs step by step (the bucketing workflow's
programming model), over the port's ``mx.sym``, with the JAX package's
node names, so the graphs' listings and JSON are the same.
``FusedRNNCell`` emits the one fused ``RNN`` op (cuDNN's fused RNN on
the card, ``ops/rnn.py``); ``unfuse()`` gives the per-step cell stack
whose per-layer parameters ``unpack_weights`` cuts from the fused
``parameters`` and ``pack_weights`` joins back.  Weights that
``pack_weights`` / ``unpack_weights`` make are host NDArrays."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams:
    """Container for cell parameters (reference rnn_cell.py:RNNParams):
    lazily-created shared sym.var's keyed by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract RNN cell (reference rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states as symbols (reference begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        func = func or symbol.zeros
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                info = {**info, **kwargs}
            else:
                info = kwargs
            # layout hints (__layout__) are metadata, not op attrs
            info = {k: v for k, v in info.items()
                    if not k.startswith("__")}
            state = func(name=f"{self._prefix}begin_state_"
                              f"{self._init_counter}", **info)
            states.append(state)
        return states

    def _begin_state_like(self, x, x_ndim=2, x_batch_axis=0):
        """Zero initial states whose batch dim is inherited from the input
        symbol `x` (rank `x_ndim`, batch extent at `x_batch_axis`).

        The reference encodes unknown batch as dim 0 in begin_state zeros
        and lets nnvm shape inference fill it (rnn_cell.py:begin_state);
        here the graph's shapes come from its inputs, so the state is
        constructed from the input instead: an all-zero (batch,) vector
        broadcast to each state shape, with 0-dims taking the batch
        extent.
        zeros_like (not x*0) so inf/NaN inputs still give zero states."""
        states = []
        reduce_axes = tuple(a for a in range(x_ndim) if a != x_batch_axis)
        vec = symbol.sum(symbol.zeros_like(x), axis=reduce_axes)  # (batch,)
        for info in self.state_info:
            shape = info["shape"] if info else None
            if shape is None:
                raise MXNetError(
                    "cell %s has no static state shape; pass begin_state "
                    "explicitly" % self._prefix)
            if 0 not in shape:
                states.append(symbol.zeros(shape=shape))
                continue
            batch_axis = shape.index(0)
            s = vec
            for ax in range(len(shape)):
                if ax != batch_axis:
                    s = symbol.expand_dims(s, axis=ax)
            for ax, size in enumerate(shape):
                if ax != batch_axis:
                    s = symbol.broadcast_axis(s, axis=ax, size=size)
            states.append(s)
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate weights
        (reference rnn_cell.py:unpack_weights)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                name = f"{self._prefix}{group}_{t}"
                if name not in args:
                    continue
                blob = args.pop(name)
                blob_np = blob.asnumpy() if hasattr(blob, "asnumpy") \
                    else np.asarray(blob)
                from ..ndarray import array as nd_array
                for j, gate in enumerate(self._gate_names):
                    args[f"{self._prefix}{group}{gate}_{t}"] = nd_array(
                        blob_np[j * h:(j + 1) * h], ctx=cpu())
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights."""
        args = dict(args)
        if not self._gate_names:
            return args
        from ..ndarray import array as nd_array
        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                gates = [f"{self._prefix}{group}{g}_{t}"
                         for g in self._gate_names]
                if not all(g in args for g in gates):
                    continue
                packed = np.concatenate([_as_np(args.pop(g)) for g in gates],
                                        axis=0)
                args[f"{self._prefix}{group}_{t}"] = nd_array(packed,
                                                              ctx=cpu())
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll the cell for `length` steps (reference rnn_cell.py:unroll).

        inputs: a (batch, T, C) symbol for 'NTC' (split internally), a
        (T, batch, C) symbol for 'TNC', or a list of T per-step symbols.
        Returns (outputs, final_states)."""
        self.reset()
        inputs = _normalize_inputs(inputs, length, layout, input_prefix)
        if begin_state is None:
            begin_state = self._begin_state_like(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states


def _as_np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def dict_pop(d, k):
    return d.pop(k)


def _normalize_inputs(inputs, length, layout, input_prefix):
    if inputs is None:
        return [symbol.var(f"{input_prefix}t{i}_data")
                for i in range(length)]
    if isinstance(inputs, symbol.Symbol):
        axis = layout.find("T")
        parts = symbol.SliceChannel(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=True)
        return [parts[i] for i in range(length)]
    if len(inputs) != length:
        raise MXNetError(f"got {len(inputs)} inputs, expected {length}")
    return list(inputs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell h' = act(W x + R h + b) (reference RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py:408; gate order i,f,c,o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=4 * self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=4 * self._num_hidden,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        slices = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                     name=f"{name}slice")
        in_gate = symbol.Activation(slices[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slices[1], act_type="sigmoid")
        in_transform = symbol.Activation(slices[2], act_type="tanh")
        out_gate = symbol.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference GRUCell; gate order r,z,n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=3 * self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(prev_h, self._hW, self._hB,
                                    num_hidden=3 * self._num_hidden,
                                    name=f"{name}h2h")
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = symbol.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = symbol.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                       act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN as ONE op (reference rnn_cell.py:536 wrapping
    the cuDNN RNN op; here the port's ``RNN`` op, cuDNN's on the card)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = 2 if self._bidirectional else 1
        n = (self._num_layers * b, 0, self._num_hidden)
        if self._mode == "lstm":
            return [{"shape": n, "__layout__": "LNC"},
                    {"shape": n, "__layout__": "LNC"}]
        return [{"shape": n, "__layout__": "LNC"}]

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """One fused RNN op over the whole sequence."""
        self.reset()
        if isinstance(inputs, (list, tuple)):
            inputs = symbol.Concat(
                *[symbol.expand_dims(i, axis=0) for i in inputs], dim=0)
        elif layout == "NTC":
            inputs = symbol.transpose(inputs, axes=(1, 0, 2))
        if begin_state is None:
            # inputs are TNC here: batch extent is axis 1
            begin_state = self._begin_state_like(inputs, x_ndim=3,
                                                 x_batch_axis=1)
        states = list(begin_state)
        mode = self._mode
        args = dict(state_size=self._num_hidden,
                    num_layers=self._num_layers, mode=mode,
                    bidirectional=self._bidirectional, p=self._dropout,
                    state_outputs=self._get_next_state)
        if mode == "lstm":
            rnn = symbol.RNN(inputs, self._parameter, states[0], states[1],
                             name=f"{self._prefix}rnn", **args)
        else:
            rnn = symbol.RNN(inputs, self._parameter, states[0],
                             name=f"{self._prefix}rnn", **args)
        if self._get_next_state:
            outputs = rnn[0]
            final = [rnn[1], rnn[2]] if mode == "lstm" else [rnn[1]]
        else:
            outputs, final = rnn, []
        if layout == "NTC":
            outputs = symbol.transpose(outputs, axes=(1, 0, 2))
        if merge_outputs is False:
            length_axis = 1 if layout == "NTC" else 0
            parts = symbol.SliceChannel(outputs, num_outputs=length,
                                        axis=length_axis, squeeze_axis=True)
            outputs = [parts[i] for i in range(length)]
        return outputs, final

    def __call__(self, inputs, states):
        raise MXNetError(
            "FusedRNNCell cannot be stepped one timestep at a time; use "
            "unroll, or unfuse() to get a per-step cell stack")

    def unfuse(self):
        """Equivalent stack of unfused cells (reference
        rnn_cell.py:FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                       forget_bias=self._forget_bias),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack

    def _layer_names(self):
        """The per-layer parameters' names, in the flat vector's order of
        the weights (``slice_rnn_weights``)."""
        dirs = "lr" if self._bidirectional else "l"
        return [[f"{self._prefix}{d}{i}_" for d in dirs]
                for i in range(self._num_layers)]

    def _input_size_of(self, size):
        """The input size that makes the flat vector ``size`` long (the
        size is linear in it), unless ``_input_size`` is set."""
        isize = getattr(self, "_input_size", None)
        if isize is not None:
            return isize
        from ..ops.rnn import rnn_param_size
        rest = rnn_param_size(self._num_layers, 0, self._num_hidden,
                              self._bidirectional, self._mode)
        per = rnn_param_size(self._num_layers, 1, self._num_hidden,
                             self._bidirectional, self._mode) - rest
        if (size - rest) % per or size < rest:
            raise MXNetError(f"unpack_weights: a parameter vector of {size}"
                             f" does not fit {self._mode} of {self._num_layers}"
                             f" layers of {self._num_hidden}")
        return (size - rest) // per

    def unpack_weights(self, args):
        """Split the fused ``parameters`` into per-layer, per-direction
        ``{prefix}{l|r}{layer}_{i2h|h2h}_{weight|bias}`` (the names of the
        ``unfuse()`` stack's cells), in ``slice_rnn_weights``' layout.
        The input size comes from ``_input_size`` when it is set, else
        from the vector's length (the JAX cell needs it set)."""
        from ..ops.rnn import slice_rnn_weights
        from ..ndarray import array as nd_array
        args = dict(args)
        pname = f"{self._prefix}parameters"
        if pname not in args:
            return args
        blob = _as_np(args.pop(pname))
        ws = slice_rnn_weights(blob, self._num_layers,
                               self._input_size_of(blob.size),
                               self._num_hidden, self._bidirectional,
                               self._mode)
        for names, layer in zip(self._layer_names(), ws):
            for p, arrays in zip(names, layer):
                for key, a in zip(("i2h_weight", "h2h_weight", "i2h_bias",
                                   "h2h_bias"), arrays):
                    args[p + key] = nd_array(np.ascontiguousarray(a),
                                             ctx=cpu())
        return args

    def pack_weights(self, args):
        """The inverse of ``unpack_weights``: the per-layer weights joined
        into ``{prefix}parameters``, all weights first, then all biases
        (the JAX cell leaves ``args`` as they are)."""
        from ..ndarray import array as nd_array
        args = dict(args)
        names = [p for layer in self._layer_names() for p in layer]
        keys = [p + k for p in names for k in ("i2h_weight", "h2h_weight")]
        keys += [p + k for p in names for k in ("i2h_bias", "h2h_bias")]
        if not all(k in args for k in keys):
            return args
        flat = np.concatenate([_as_np(args.pop(k)).reshape(-1)
                               for k in keys])
        args[f"{self._prefix}parameters"] = nd_array(flat, ctx=cpu())
        return args


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence per step (reference
    SequentialRNNCell).  A stack holding a cell that cannot be stepped
    (a BidirectionalCell, as ``FusedRNNCell.unfuse()`` makes for a
    bidirectional net) unrolls layer by layer, as the reference's
    ``unroll`` does; the JAX cell raises there."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        if not any(isinstance(c, BidirectionalCell) for c in self._cells):
            return super().unroll(length, inputs, begin_state, input_prefix,
                                  layout, merge_outputs)
        self.reset()
        states, p = [], 0
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            begin = None if begin_state is None else begin_state[p:p + n]
            p += n
            last = i == len(self._cells) - 1
            inputs, st = cell.unroll(length, inputs, begin, input_prefix,
                                     layout, merge_outputs if last else None)
            states.extend(st)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (reference
    BidirectionalCell). Only usable through unroll."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        inputs = _normalize_inputs(inputs, length, layout, input_prefix)
        if begin_state is None:
            begin_state = self._begin_state_like(inputs[0])
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(length, inputs,
                                        begin_state[:n_l], layout="TNC",
                                        merge_outputs=False)
        r_out, r_states = r_cell.unroll(length, list(reversed(inputs)),
                                        begin_state[n_l:], layout="TNC",
                                        merge_outputs=False)
        outputs = [symbol.Concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, l_states + r_states


class DropoutCell(BaseRNNCell):
    """Dropout on the step output (reference DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = symbol.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix="", params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(  # noqa: E731
            symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        if self.zoneout_outputs > 0:
            output = symbol.where(mask(self.zoneout_outputs, next_output),
                                  next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0:
            states = [symbol.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output (reference ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs, begin_state, input_prefix, layout,
            merge_outputs=False)
        self.base_cell._modified = True
        ins = _normalize_inputs(inputs, length, layout, input_prefix)
        outputs = [o + i for o, i in zip(outputs, ins)]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states
