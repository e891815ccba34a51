"""Unfused recurrent cells of the port's Gluon (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``; reference
python/mxnet/gluon/rnn/rnn_cell.py).

A cell computes one step (``cell(x, states)``) from ``nd`` ops; ``unroll``
runs it over a sequence, with ``merge_outputs`` and per-sequence
``valid_length`` (``SequenceMask`` / ``SequenceLast`` /
``SequenceReverse``).  Each step is a few eager ops, so for a whole
sequence the fused layers (``rnn_layer.py``, one cuDNN call on the card)
are the fast path; cells are for custom recurrences.
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ... import ndarray as nd_mod

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize inputs to a list of per-step arrays or a merged tensor
    (reference rnn_cell.py:_format_sequence)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, (list, tuple)):
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = [nd_mod.op.expand_dims(i, axis=axis) for i in inputs]
            inputs = nd_mod.op.concat(*inputs, dim=axis)
    else:
        batch_size = inputs.shape[batch_axis]
        if in_axis != axis:
            inputs = nd_mod.op.swapaxes(inputs, dim1=in_axis, dim2=axis)
        if merge is False:
            length = inputs.shape[axis]
            inputs = nd_mod.op.split(inputs, num_outputs=length, axis=axis,
                                     squeeze_axis=True)
            if not isinstance(inputs, list):
                inputs = [inputs]
    return inputs, axis, batch_size


def _mask_sequence_variable_length(data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    if not isinstance(data, (list, tuple)):
        return nd_mod.op.SequenceMask(data, valid_length,
                                      use_sequence_length=True,
                                      axis=time_axis)
    outputs = nd_mod.op.SequenceMask(
        nd_mod.op.stack(*data, axis=time_axis), valid_length,
        use_sequence_length=True, axis=time_axis)
    if not merge:
        outputs = nd_mod.op.split(outputs, num_outputs=len(data),
                                  axis=time_axis, squeeze_axis=True)
        if not isinstance(outputs, list):
            outputs = [outputs]
    return outputs


class RecurrentCell(Block):
    """Abstract cell (reference rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    @property
    def _curr_prefix(self):
        return f"{self.prefix}t{self._counter}_"

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called" \
            " directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.update(kwargs)
            shape = info.pop("shape")
            dtype = info.pop("dtype", "float32")
            if func is None:
                states.append(nd_mod.zeros(shape, dtype=dtype, ctx=ctx))
            else:
                states.append(func(shape=shape, dtype=dtype, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` steps (reference rnn_cell.py:unroll)."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=first.context)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd_mod.op.SequenceLast(
                nd_mod.op.stack(*ele_list, axis=0), valid_length,
                use_sequence_length=True, axis=0)
                for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                outputs, length, valid_length, axis, bool(merge_outputs))
        if merge_outputs and isinstance(outputs, (list, tuple)):
            outputs = [nd_mod.op.expand_dims(o, axis=axis) for o in outputs]
            outputs = nd_mod.op.concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Cell with hybrid_forward (reference rnn_cell.py:HybridRecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        # bypass HybridBlock's single-input CachedOp path: cells carry state
        from ..parameter import DeferredInitializationError
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(inputs, states)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd_mod, inputs, states, **params)

    def hybrid_forward(self, F, x, states, **params):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell (reference rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, states):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (reference rnn_cell.py:LSTMCell); gate order i,f,c,o matches
    the fused op (rnn-inl.h / ops/rnn.py)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"},
                {"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, x, states):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.sigmoid(slice_gates[0])
        forget_gate = F.sigmoid(slice_gates[1])
        in_transform = F.tanh(slice_gates[2])
        out_gate = F.sigmoid(slice_gates[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (reference rnn_cell.py:GRUCell); gate order r,z,n."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, x, states):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h + reset_gate * h2h)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied per step (reference rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout between steps (reference rnn_cell.py:DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, float)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (reference rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = nd_mod.zeros(next_output.shape,
                                       ctx=next_output.context,
                                       dtype=next_output.dtype)
        output = F.where(mask(self.zoneout_outputs, next_output),
                         next_output, prev_output) \
            if self.zoneout_outputs > 0.0 else next_output
        states = [F.where(mask(self.zoneout_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0.0 else next_states
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """output = cell(x) + x (reference rnn_cell.py:ResidualCell)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        if isinstance(outputs, list):
            inputs_l, _, _ = _format_sequence(length, inputs, layout, False)
            outputs = [o + i for o, i in zip(outputs, inputs_l)]
        else:
            inputs_m, _, _ = _format_sequence(length, inputs, layout, True)
            outputs = outputs + inputs_m
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Run two cells in opposite directions (reference
    rnn_cell.py:BidirectionalCell); only usable via unroll."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size, ctx=first.context)
        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            reversed_inputs = list(reversed(inputs))
        else:
            # per-sequence reversal so padding steps stay at the tail
            # (reference rnn_cell.py BidirectionalCell uses SequenceReverse
            # with sequence_length when valid_length is given)
            stacked = nd_mod.op.stack(*inputs, axis=0)
            rev = nd_mod.op.SequenceReverse(stacked, valid_length,
                                            use_sequence_length=True)
            reversed_inputs = nd_mod.op.split(rev, num_outputs=length, axis=0,
                                              squeeze_axis=True)
            if not isinstance(reversed_inputs, list):
                reversed_inputs = [reversed_inputs]
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            reversed_r_outputs = list(reversed(r_outputs))
        else:
            stacked_r = nd_mod.op.stack(*r_outputs, axis=0)
            rev_r = nd_mod.op.SequenceReverse(stacked_r, valid_length,
                                              use_sequence_length=True)
            reversed_r_outputs = nd_mod.op.split(rev_r, num_outputs=length,
                                                 axis=0, squeeze_axis=True)
            if not isinstance(reversed_r_outputs, list):
                reversed_r_outputs = [reversed_r_outputs]
        outputs = [nd_mod.op.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed_r_outputs)]
        if merge_outputs:
            outputs = [nd_mod.op.expand_dims(o, axis=axis) for o in outputs]
            outputs = nd_mod.op.concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states
