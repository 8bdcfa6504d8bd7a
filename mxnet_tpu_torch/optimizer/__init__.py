"""Optimizers (counterpart of `mxnet_tpu/optimizer/`): the base class
and registry, the SGD family, the Adam family, RMSProp and its
relatives, and the reference's ``Test``.  `Updater` carries the states
to and from files."""
from .optimizer import (Optimizer, Test, Updater, create, get_updater,
                        register)
from .sgd import SGD, NAG, Signum, SGLD, LARS, DCASGD
from .adam import Adam, AdamW, Adamax, Nadam, LAMB, LANS
from .rmsprop import RMSProp, AdaGrad, AdaDelta, Ftrl, FTML

__all__ = [
    "Optimizer", "Updater", "get_updater", "register", "create", "Test",
    "SGD", "NAG", "Signum", "SGLD", "LARS", "DCASGD",
    "Adam", "AdamW", "Adamax", "Nadam", "LAMB", "LANS",
    "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "FTML",
]
