"""Recurrent layers and cells of the port's Gluon (counterpart of
``incubator_mxnet_tpu/gluon/rnn``; reference python/mxnet/gluon/rnn/)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell)

__all__ = ["BidirectionalCell", "DropoutCell", "GRU", "GRUCell", "LSTM",
           "LSTMCell", "ModifierCell", "RNN", "RNNCell", "RecurrentCell",
           "HybridRecurrentCell", "ResidualCell", "SequentialRNNCell",
           "ZoneoutCell"]
