"""Gluon contrib of the port: the data helpers (``IntervalSampler``,
``text.WikiText2`` / ``WikiText103``) and the recurrent cells
(``rnn.VariationalDropoutCell``, the convolutional RNN / LSTM / GRU
cells).  The contrib layers (``contrib.nn``) of the JAX package are not
ported (ROADMAP A8)."""
from . import data, rnn

__all__ = ["data", "rnn"]
