"""Carry weights across from the JAX package.

``load_reference_params(net, params)`` takes the arrays of the reference
block's ``collect_params()`` — a ``{dotted name: numpy array}`` dict, as
``{k: p.data().asnumpy() for k, p in ref.collect_params().items()}``
gives it — and writes them into the port's block of the same
architecture, which then computes the same function.  The layouts are
the same on both sides (Dense weights (out, in), embeddings
(vocab, units), conv weights (out, in, kh, kw), the RNN layers'
``l0_i2h_weight`` ... ``r1_h2h_bias`` with their gates stacked in the
reference's order), so nothing is transposed.  BatchNorm running statistics are parameters on both sides
and come across with the weights.  A parameter whose shape is still
deferred takes it from the array (no forward is needed first).
"""
from __future__ import annotations

import numpy as onp

__all__ = ["load_reference_params"]


def load_reference_params(net, params):
    """Set every parameter of ``net`` from ``params`` by name, keeping
    each parameter's dtype and device (`Block.load_dict`: a name missing
    from either side raises ``AssertionError``, a shape mismatch
    ``ValueError``)."""
    net.load_dict({k: onp.array(v, dtype=onp.float32)
                   for k, v in params.items()},
                  source="the reference's arrays")
    return net
