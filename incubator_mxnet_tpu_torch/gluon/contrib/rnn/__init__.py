"""Contrib recurrent cells of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/rnn``; reference gluon/contrib/rnn/)."""
from .conv_rnn_cell import (Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
                            Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
                            Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
from .rnn_cell import VariationalDropoutCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell"]
