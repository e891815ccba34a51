"""Gluon contrib of the port: the data helpers (``IntervalSampler``,
``text.WikiText2`` / ``WikiText103``), the layers (``nn.Concurrent``,
``nn.HybridConcurrent``, ``nn.Identity``) and the recurrent cells
(``rnn.VariationalDropoutCell``, the convolutional RNN / LSTM / GRU
cells)."""
from . import data, nn, rnn

__all__ = ["data", "nn", "rnn"]
