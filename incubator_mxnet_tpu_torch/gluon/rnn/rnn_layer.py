"""Fused recurrent layers of the port's Gluon: RNN, LSTM, GRU (counterpart
of ``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``; reference
python/mxnet/gluon/rnn/rnn_layer.py:31, ``_RNNLayer`` calling the fused
``RNN`` op at :219; RNN:234, LSTM:325, GRU:428).

The layer calls ``F.RNN`` (``ops/rnn.py``): cuDNN's fused RNN on the
card, the plain composition on the CPU.  Parameters are per-layer,
per-direction i2h / h2h weights and biases under the reference's names
(``l0_i2h_weight``, ``r0_h2h_bias`` ...), concatenated at each forward
into the flat vector the op takes; ``input_size=0`` defers the first
layer's i2h weight to the first input.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd_mod
from ...ndarray import op as ndop

__all__ = ["RNN", "LSTM", "GRU"]

_NUM_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    """Base fused RNN layer (reference rnn_layer.py:_RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = _NUM_GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = f"{shape[1] if shape[1] else None} -> {shape[0] // self._gates}"
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, x, *args):
        ni = x.shape[2] if self._layout == "TNC" else x.shape[-1]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, f"{j}{i}_i2h_weight").shape = \
                    (self._gates * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Initial recurrent states (reference rnn_layer.py:begin_state)."""
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            info.update(kwargs)
            shape = info.pop("shape")
            dtype = info.pop("dtype", "float32")
            if func is None:
                states.append(nd_mod.zeros(shape, dtype=dtype, ctx=ctx))
            else:
                states.append(func(shape=shape, dtype=dtype, **info))
        return states

    def _flat_params(self, params_dict):
        """Concatenate per-layer params into the fused op's flat vector
        (ordering matches ops/rnn.py slice_rnn_weights == rnn-inl.h:52-88:
        all weights first, then all biases)."""
        order = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                order.append(params_dict[f"{j}{i}_i2h_weight"])
                order.append(params_dict[f"{j}{i}_h2h_weight"])
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                order.append(params_dict[f"{j}{i}_i2h_bias"])
                order.append(params_dict[f"{j}{i}_h2h_bias"])
        flat = [ndop.reshape(w, shape=(-1,)) for w in order]
        return ndop.concat(*flat, dim=0)

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if not isinstance(states, (list, tuple)):
            states = [states]

        flat = self._flat_params(params)
        rnn_args = [inputs, flat] + list(states)
        outputs = F.RNN(*rnn_args, state_size=self._hidden_size,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True)
        out, new_states = outputs[0], list(outputs[1:])
        if self._layout == "NTC":
            out = F.swapaxes(out, dim1=0, dim2=1)
        if skip_states:
            return out
        return out, new_states


class RNN(_RNNLayer):
    """Vanilla multi-layer Elman RNN with relu/tanh
    (reference rnn_layer.py:RNN:234)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "dtype": "float32"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:LSTM:325)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "dtype": "float32"},
                {"shape": shape, "dtype": "float32"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:GRU:428)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "dtype": "float32"}]
