"""Gluon-style model building blocks of the port."""
from . import nn
from .decoder import DecoderLayer, TransformerDecoder

__all__ = ["nn", "DecoderLayer", "TransformerDecoder"]
