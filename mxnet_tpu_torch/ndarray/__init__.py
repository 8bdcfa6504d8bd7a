"""The legacy ``mx.nd`` namespace (counterpart of the part of
`mxnet_tpu/ndarray/legacy.py` the port has): ``Custom``, the entry of
Python custom operators.  The rest of ``nd`` is ROADMAP queue A,
surface breadth; the port's arrays are torch tensors."""
from __future__ import annotations

from ..operator import invoke_custom

__all__ = ["Custom"]


def Custom(*data, op_type=None, **kwargs):  # noqa: N802 - reference name
    """Run the custom operator registered as ``op_type`` on ``data``
    (`operator.invoke_custom`)."""
    return invoke_custom(*data, op_type=op_type, **kwargs)
