"""Contributed modules of the port (counterpart of `mxnet_tpu/contrib/`):
``text``'s tokenizer helpers and vocabulary."""
from . import text

__all__ = ["text"]
