"""Gluon: the port's imperative model layer."""
from . import data, loss, metric, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock
from .fused_step import FusedTrainStep
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["data", "nn", "rnn", "utils", "loss", "metric", "model_zoo", "Block",
           "HybridBlock", "Parameter", "Trainer", "FusedTrainStep"]
