"""Gluon: the port's imperative model layer."""
from . import nn
from .block import Block, HybridBlock
from .parameter import Parameter

__all__ = ["nn", "Block", "HybridBlock", "Parameter"]
