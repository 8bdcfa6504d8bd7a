"""Gluon: the port's imperative model layer."""
from . import nn
from .block import Block, HybridBlock
from .fused_step import FusedTrainStep
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["nn", "Block", "HybridBlock", "Parameter", "Trainer",
           "FusedTrainStep"]
