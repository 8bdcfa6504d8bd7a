"""Gluon layers of the port."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, GELU, HybridSequential, Identity,
                           LayerNorm, Sequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D,
                          SpaceToDepthStem)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "GELU", "HybridSequential", "Identity", "LayerNorm",
           "Sequential", "Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "SpaceToDepthStem"]
