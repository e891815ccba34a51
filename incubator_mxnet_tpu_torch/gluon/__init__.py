"""Gluon of the port (counterpart of ``incubator_mxnet_tpu/gluon``;
reference python/mxnet/gluon/): ``Block`` / ``HybridBlock`` over
``NDArray``, ``Parameter`` / ``ParameterDict``, ``Trainer``, the
``nn`` layers, the losses, ``utils``, the model zoo and the decoder of
the generation server, ``data`` (datasets, samplers, the DataLoader,
vision datasets and transforms) with ``contrib.data``, and ``rnn`` (the
fused recurrent layers and the cells) with ``contrib.rnn``, and the
contrib layers ``contrib.nn``."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .decoder import DecoderLayer, TransformerDecoder
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "Constant", "DecoderLayer", "contrib", "data",
           "DeferredInitializationError", "HybridBlock", "Parameter",
           "ParameterDict", "SymbolBlock", "Trainer", "TransformerDecoder",
           "loss", "model_zoo", "nn", "rnn", "utils"]
