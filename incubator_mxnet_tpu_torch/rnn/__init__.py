"""Legacy ``mx.rnn`` of the port (counterpart of ``incubator_mxnet_tpu/rnn``;
reference python/mxnet/rnn/): the symbolic cells and the bucketing
sentence iterator."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BaseRNNCell", "BidirectionalCell", "BucketSentenceIter",
           "DropoutCell", "FusedRNNCell", "GRUCell", "LSTMCell",
           "ModifierCell", "RNNCell", "RNNParams", "ResidualCell",
           "SequentialRNNCell", "ZoneoutCell", "encode_sentences"]
