"""Gluon of the port (counterpart of ``incubator_mxnet_tpu/gluon``;
reference python/mxnet/gluon/): ``Block`` / ``HybridBlock`` over
``NDArray``, ``Parameter`` / ``ParameterDict``, ``Trainer``, the
``nn`` layers, the losses, ``utils``, the model zoo and the decoder of
the generation server."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock, SymbolBlock
from .decoder import DecoderLayer, TransformerDecoder
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "Constant", "DecoderLayer",
           "DeferredInitializationError", "HybridBlock", "Parameter",
           "ParameterDict", "SymbolBlock", "Trainer", "TransformerDecoder",
           "loss", "model_zoo", "nn", "utils"]
