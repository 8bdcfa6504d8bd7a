"""Optimizers (counterpart of `mxnet_tpu/optimizer/`): the base class
and registry, the Adam family and SGD.  The rest of the SGD family
(NAG, Signum, SGLD, LARS, DCASGD), RMSProp, Adamax, Nadam and LANS are
not ported yet (ROADMAP queue A).  `Updater` carries the states to and
from files."""
from .optimizer import Optimizer, Updater, create, register
from .adam import Adam, AdamW, LAMB
from .sgd import SGD

__all__ = ["Optimizer", "Updater", "register", "create", "Adam", "AdamW",
           "LAMB", "SGD"]
