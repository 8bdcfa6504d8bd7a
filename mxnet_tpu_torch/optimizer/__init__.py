"""Optimizers (counterpart of `mxnet_tpu/optimizer/`): the base class
and registry, and the Adam family.  SGD, RMSProp, Adamax, Nadam and
LANS are not ported yet (ROADMAP queue A)."""
from .optimizer import Optimizer, create, register
from .adam import Adam, AdamW, LAMB

__all__ = ["Optimizer", "register", "create", "Adam", "AdamW", "LAMB"]
