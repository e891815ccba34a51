"""Convolutional recurrent cells of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; reference
gluon/contrib/rnn/conv_rnn_cell.py: Conv{1,2,3}D{RNN,LSTM,GRU}Cell).

One parameterized recurrence over an i2h and an h2h convolution (the
port's ``Convolution`` op); the nine public classes pin (dims, mode).
Each step is two convolutions plus gate arithmetic.

State spatial dims equal the input's post-i2h-conv dims; the h2h conv is
'same' (odd kernels, auto pad), so states are step-invariant.
"""
from __future__ import annotations

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]

_GATES = {"rnn": 1, "lstm": 4, "gru": 3}


def _tup(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) != n:
        raise MXNetError(f"{name} must be int or length-{n}, got {v}")
    return v


class _ConvRecurrentCell(HybridRecurrentCell):
    """Shared machinery for conv RNN/LSTM/GRU cells."""

    _mode = "rnn"  # class-level: _alias() runs during Block.__init__

    def __init__(self, mode, dims, input_shape, hidden_channels,
                 i2h_kernel, h2h_kernel, i2h_pad=0, i2h_dilate=1,
                 h2h_dilate=1, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout="NCHW", activation="tanh",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._mode = mode
        self._dims = dims
        self._activation = activation
        self._layout = conv_layout
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        ch_axis = conv_layout.find("C")
        if ch_axis != 1:
            raise MXNetError(
                f"conv_layout {conv_layout}: only channels-first layouts "
                "are supported (weights are OI+kernel)")
        self._channels_first = True
        in_channels = self._input_shape[0 if self._channels_first else -1]
        spatial = self._input_shape[1:] if self._channels_first \
            else self._input_shape[:-1]
        if len(spatial) != dims:
            raise MXNetError(
                f"input_shape {input_shape} does not match {dims}D conv")

        self._i2h_kernel = _tup(i2h_kernel, dims, "i2h_kernel")
        self._i2h_pad = _tup(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tup(i2h_dilate, dims, "i2h_dilate")
        self._h2h_kernel = _tup(h2h_kernel, dims, "h2h_kernel")
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError("h2h_kernel must be odd (same-size recurrence), "
                             f"got {self._h2h_kernel}")
        self._h2h_dilate = _tup(h2h_dilate, dims, "h2h_dilate")
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))

        # state spatial dims = i2h conv output dims (stride 1)
        self._state_spatial = tuple(
            (spatial[i] + 2 * self._i2h_pad[i]
             - self._i2h_dilate[i] * (self._i2h_kernel[i] - 1) - 1) + 1
            for i in range(dims))

        gates = _GATES[mode]
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(gates * hidden_channels, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(gates * hidden_channels, hidden_channels)
            + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(gates * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(gates * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        if self._channels_first:
            shape = (batch_size, self._hidden_channels) + self._state_spatial
        else:
            shape = (batch_size,) + self._state_spatial \
                + (self._hidden_channels,)
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": self._layout}] * n_states

    def _alias(self):
        return f"conv_{self._mode}"

    def _convs(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        layout = self._layout if self._dims != 1 else None
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, stride=(1,) * self._dims,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            num_filter=_GATES[self._mode]
                            * self._hidden_channels,
                            layout=layout)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, stride=(1,) * self._dims,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=_GATES[self._mode]
                            * self._hidden_channels,
                            layout=layout)
        return i2h, h2h

    def _split_gates(self, F, x, n):
        ax = 1 if self._channels_first else self._dims + 1
        return list(F.SliceChannel(x, num_outputs=n, axis=ax))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = self._curr_prefix
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        if self._mode == "rnn":
            out = self._get_activation(F, i2h + h2h, self._activation,
                                       name=prefix + "out")
            return out, [out]
        if self._mode == "lstm":
            ii, ff, cc, oo = self._split_gates(F, i2h + h2h, 4)
            i = F.Activation(ii, act_type="sigmoid")
            f = F.Activation(ff, act_type="sigmoid")
            g = self._get_activation(F, cc, self._activation)
            o = F.Activation(oo, act_type="sigmoid")
            c = f * states[1] + i * g
            h = o * self._get_activation(F, c, self._activation,
                                         name=prefix + "out")
            return h, [h, c]
        # gru: reset gate scales the candidate's recurrent term
        i_r, i_z, i_n = self._split_gates(F, i2h, 3)
        h_r, h_z, h_n = self._split_gates(F, h2h, 3)
        r = F.Activation(i_r + h_r, act_type="sigmoid")
        z = F.Activation(i_z + h_z, act_type="sigmoid")
        n = self._get_activation(F, i_n + r * h_n, self._activation)
        out = (1 - z) * n + z * states[0]
        return out, [out]


def _make(mode, dims, default_layout):
    class Cell(_ConvRecurrentCell):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros",
                     conv_layout=default_layout,
                     activation="tanh" if mode != "gru" else "tanh",
                     prefix=None, params=None):
            super().__init__(
                mode, dims, input_shape, hidden_channels, i2h_kernel,
                h2h_kernel, i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer,
                conv_layout=conv_layout, activation=activation,
                prefix=prefix, params=params)
    Cell._mode = mode
    Cell.__name__ = f"Conv{dims}D{mode.upper() if mode != 'rnn' else 'RNN'}Cell"
    Cell.__qualname__ = Cell.__name__
    Cell.__doc__ = (f"{dims}D convolutional {mode.upper()} cell (reference "
                    "gluon/contrib/rnn/conv_rnn_cell.py).")
    return Cell


Conv1DRNNCell = _make("rnn", 1, "NCW")
Conv2DRNNCell = _make("rnn", 2, "NCHW")
Conv3DRNNCell = _make("rnn", 3, "NCDHW")
Conv1DLSTMCell = _make("lstm", 1, "NCW")
Conv2DLSTMCell = _make("lstm", 2, "NCHW")
Conv3DLSTMCell = _make("lstm", 3, "NCDHW")
Conv1DGRUCell = _make("gru", 1, "NCW")
Conv2DGRUCell = _make("gru", 2, "NCHW")
Conv3DGRUCell = _make("gru", 3, "NCDHW")
