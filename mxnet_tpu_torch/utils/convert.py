"""Carry weights across from the JAX package.

``load_reference_params(net, params)`` takes the arrays of the reference
block's ``collect_params()`` — a ``{dotted name: numpy array}`` dict, as
``{k: p.data().asnumpy() for k, p in ref.collect_params().items()}``
gives it — and writes them into the port's block of the same
architecture, which then computes the same function.  The layouts are
the same on both sides (Dense weights (out, in), embeddings
(vocab, units), conv weights (out, in, kh, kw)), so nothing is
transposed.  BatchNorm running statistics are parameters on both sides
and come across with the weights.  A parameter whose shape is still
deferred takes it from the array (no forward is needed first).
"""
from __future__ import annotations

import numpy as onp

__all__ = ["load_reference_params"]


def load_reference_params(net, params):
    """Set every parameter of ``net`` from ``params`` by name, keeping
    each parameter's dtype and device.  Raises ``KeyError`` on a name
    missing from either side and ``ValueError`` on a shape mismatch."""
    mine = net.collect_params()
    missing = sorted(set(mine) - set(params))
    extra = sorted(set(params) - set(mine))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, param in mine.items():
        param.set_data(onp.array(params[name], dtype=onp.float32))
    return net
