"""Contrib recurrent cells of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; reference
gluon/contrib/rnn/rnn_cell.py: VariationalDropoutCell)."""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, BidirectionalCell, \
    SequentialRNNCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (time-invariant) dropout around a base cell
    (reference gluon/contrib/rnn/rnn_cell.py:VariationalDropoutCell;
    Gal & Ghahramani 2015): one mask per sequence for inputs, outputs,
    and the first state channel, resampled on reset().  The masks come
    from the port's generator, so their bits differ from the JAX
    package's.
    """

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise ValueError(
                "BidirectionalCell doesn't support variational state "
                "dropout; wrap the inner cells instead.")
        if drop_states and isinstance(base_cell, SequentialRNNCell) and \
                getattr(base_cell, "_bidirectional", False):
            raise ValueError(
                "Bidirectional SequentialRNNCell doesn't support "
                "variational state dropout; wrap the inner cells instead.")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_mask(self, F, name, data, rate):
        """Bernoulli keep-mask scaled by 1/(1-p), same shape as data."""
        return F.Dropout(F.ones_like(data), p=rate)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        if self.drop_states:
            if self.drop_states_mask is None:
                self.drop_states_mask = self._initialize_mask(
                    F, "state", states[0], self.drop_states)
            states = [states[0] * self.drop_states_mask] + list(states[1:])
        if self.drop_inputs:
            if self.drop_inputs_mask is None:
                self.drop_inputs_mask = self._initialize_mask(
                    F, "input", inputs, self.drop_inputs)
            inputs = inputs * self.drop_inputs_mask
        output, states = cell(inputs, states)
        if self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = self._initialize_mask(
                    F, "output", output, self.drop_outputs)
            output = output * self.drop_outputs_mask
        return output, states

    def __repr__(self):
        return (f"VariationalDropoutCell(p_in={self.drop_inputs}, "
                f"p_state={self.drop_states}, p_out={self.drop_outputs}, "
                f"base={self.base_cell!r})")
