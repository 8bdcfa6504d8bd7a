"""Exception classes (counterpart of `mxnet_tpu/error.py`): the root
error of the port, `MXNetError`."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["MXNetError"]
