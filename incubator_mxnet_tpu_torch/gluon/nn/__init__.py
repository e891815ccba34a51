"""Neural-network layers of the port (``gluon.nn`` counterpart)."""
from .activations import Activation
from .basic_layers import (BatchNorm, BNReLU, Dense, Embedding, Flatten,
                           LayerNorm)
from .conv_layers import (Conv2D, FusedBNReLUConv2D, FusedBottleneckChain,
                          GlobalAvgPool2D, MaxPool2D)

__all__ = ["Activation", "BatchNorm", "BNReLU", "Conv2D", "Dense",
           "Embedding", "Flatten", "FusedBNReLUConv2D", "FusedBottleneckChain",
           "GlobalAvgPool2D", "LayerNorm", "MaxPool2D"]
