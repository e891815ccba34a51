"""Gluon-style model building blocks of the port."""
from . import model_zoo, nn
from .decoder import DecoderLayer, TransformerDecoder

__all__ = ["model_zoo", "nn", "DecoderLayer", "TransformerDecoder"]
