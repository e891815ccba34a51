"""Gluon-style model building blocks of the port."""
from . import loss, model_zoo, nn
from .decoder import DecoderLayer, TransformerDecoder

__all__ = ["loss", "model_zoo", "nn", "DecoderLayer", "TransformerDecoder"]
