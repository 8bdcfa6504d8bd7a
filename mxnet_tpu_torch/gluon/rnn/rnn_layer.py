"""Fused multi-layer RNN/LSTM/GRU layers (counterpart of
`mxnet_tpu/gluon/rnn/rnn_layer.py`).

The reference runs the whole stack (layers x directions x time) as one
``lax.scan`` program of plain ops that XLA fuses; no Pallas kernel is
involved.  The port runs the same recurrence as plain torch ops in a
Python loop over time: a captured `gluon.FusedTrainStep` replays the
whole loop, forward and backward, as one CUDA graph.  As in the
reference, the input projection of all T steps is one product outside
the loop, so the sequential part is the h -> h product and the gates.

Parameter names and layouts are the reference's (``l0_i2h_weight`` ...
``r1_h2h_bias``, gates stacked [i, f, c, o] for LSTM and [r, z, n] for
GRU, with GRU's ``n = tanh(nx + r * (h W + b))``), so checkpoints map
one to one.  The reference may take the LSTM's ``unroll`` and
``gate_layout`` from its TPU autotune cache; the port never reads it and
takes the reference's documented static default (``unroll=1``,
``gate_layout="fused"``).  ``unroll`` (a scan-unrolling factor) changes
no result and does nothing in the port; ``gate_layout="split"`` (one
(H, H) product per gate) is kept as an explicit argument of
`run_single_direction`.

Training-mode dropout between layers draws one threefry key per forward
(`ops.seeds`, kind ``"rnn"``; the reference's ``_rng.new_key()``) and
masks layer ``l``'s output with ``jax.random.bernoulli(fold_in(key, l),
1 - p, shape)``, computed bit for bit on the data's device with torch's
integer ops (`ops.threefry`; the dropout kernel hashes its counters in
another layout).  Under a captured step the key comes from the step's
seed table, so every replay masks afresh.

``sequence_length`` is accepted and ignored, and ``use_sequence_length``
only stored, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...initializer import resolve as _resolve_init
from ...ops import threefry
from ...ops.invoke import is_training
from ...ops.seeds import draw_seed
from ..block import HybridBlock
from ..parameter import Parameter, to_torch_dtype

__all__ = ["RNN", "LSTM", "GRU", "cell_step", "run_single_direction",
           "inter_layer_mask"]


def _promote(*ts):
    """The tensors in their common dtype, as jax's promotion gives it (an
    f32 state against bf16 weights computes in f32); None passes."""
    dtype = None
    for t in ts:
        if t is not None:
            dtype = t.dtype if dtype is None else \
                torch.promote_types(dtype, t.dtype)
    return [t if t is None or t.dtype == dtype else t.to(dtype) for t in ts]


def cell_step(mode, x_proj, h, c, h2h_w, h2h_b=None, gate_layout="fused"):
    """One timestep; ``x_proj`` is the precomputed input projection
    (with its bias).  ``h2h_b=None``: the recurrent bias is already in
    ``x_proj`` (not for GRU, whose reset gate multiplies it, nor for
    ``"split"``).  ``gate_layout="fused"`` computes all gates as one
    (H, 4H) product then splits; ``"split"`` issues one (H, H) product
    per gate (LSTM only)."""
    x_proj, h, h2h_w, h2h_b = _promote(x_proj, h, h2h_w, h2h_b)
    if mode == "lstm" and gate_layout == "split":
        xi, xf, xc, xo = x_proj.chunk(4, -1)
        wi, wf, wc, wo = h2h_w.chunk(4, 0)
        bi, bf, bc, bo = h2h_b.chunk(4)
        i = torch.sigmoid(xi + h @ wi.T + bi)
        f = torch.sigmoid(xf + h @ wf.T + bf)
        cc = torch.tanh(xc + h @ wc.T + bc)
        o = torch.sigmoid(xo + h @ wo.T + bo)
        nc = f * c + i * cc
        return o * torch.tanh(nc), nc
    if mode == "gru":
        rx, zx, nx = x_proj.chunk(3, -1)
        rh, zh, nh_ = torch.addmm(h2h_b, h, h2h_w.T).chunk(3, -1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh_)
        return (1 - z) * n + z * h, c
    g = torch.addmm(x_proj if h2h_b is None else x_proj + h2h_b, h,
                    h2h_w.T)
    if mode == "rnn_relu":
        return torch.relu(g), c
    if mode == "rnn_tanh":
        return torch.tanh(g), c
    if mode == "lstm":
        i, f, cc, o = g.chunk(4, -1)
        nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        return torch.sigmoid(o) * torch.tanh(nc), nc
    raise ValueError(mode)


def run_single_direction(mode, x_tnc, h0, c0, i2h_w, i2h_b, h2h_w, h2h_b,
                         reverse=False, unroll=1, gate_layout="fused"):
    """One layer and direction over time; x: (T, N, C).  Returns the
    outputs (T, N, H) and the last h and c.  ``unroll`` changes nothing
    (the reference's scan-unrolling factor)."""
    if reverse:
        x_tnc = torch.flip(x_tnc, dims=(0,))
    x_tnc, i2h_w, i2h_b = _promote(x_tnc, i2h_w, i2h_b)
    # the input projection of every step as one product
    x_proj = F.linear(x_tnc, i2h_w, i2h_b)
    if mode != "gru" and gate_layout != "split":
        # the recurrent bias added once: each step is one addmm
        x_proj, h2h_b = x_proj + h2h_b.to(x_proj.dtype), None
    h, c = h0, c0
    outs = []
    for xp in x_proj.unbind(0):
        h, c = cell_step(mode, xp, h, c, h2h_w, h2h_b, gate_layout)
        outs.append(h)
    out = torch.stack(outs, dim=0)
    if reverse:
        out = torch.flip(out, dims=(0,))
    return out, h, c


def inter_layer_mask(key, layer, keep, shape):
    """The keep mask after layer ``layer``: ``jax.random.bernoulli(
    jax.random.fold_in(key, layer), keep, shape)`` bit for bit, on the
    key's device.  ``key``: two uint32 words (an int32 (2,) tensor as
    `ops.seeds` hands them out, or two ints)."""
    return threefry.bernoulli(threefry.fold_in(threefry.key_of(key), layer),
                              keep, shape)


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dtype="float32",
                 use_sequence_length=False, **kwargs):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"layout must be TNC or NTC; got {layout!r}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = to_torch_dtype(dtype)
        self._use_sequence_length = use_sequence_length
        ng = _gates(mode)
        for layer in range(num_layers):
            for d in range(self._dir):
                suffix = ["l", "r"][d] + str(layer)
                in_sz = input_size if layer == 0 else hidden_size * self._dir
                self._register_param(
                    f"{suffix}_i2h_weight", (ng * hidden_size, in_sz),
                    i2h_weight_initializer, dtype)
                self._register_param(
                    f"{suffix}_h2h_weight", (ng * hidden_size, hidden_size),
                    h2h_weight_initializer, dtype)
                self._register_param(
                    f"{suffix}_i2h_bias", (ng * hidden_size,),
                    i2h_bias_initializer, dtype)
                self._register_param(
                    f"{suffix}_h2h_bias", (ng * hidden_size,),
                    h2h_bias_initializer, dtype)

    def _register_param(self, name, shape, init, dtype):
        setattr(self, name, Parameter(name, shape=shape,
                                      init=_resolve_init(init),
                                      allow_deferred_init=True, dtype=dtype))

    def cast(self, dtype):
        """Cast the parameters and the dtype of the initial states: without
        the second, `begin_state` would keep making f32 states, every gate
        would promote to f32 and the layers after the first would compute
        in f32 (the reference's fix, kept)."""
        super().cast(dtype)
        self._dtype = to_torch_dtype(dtype)
        return self

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero initial states, (layers x directions, N, H) each, in the
        layer's dtype on ``ctx`` (None: the card): [h, c] for LSTM, [h]
        otherwise."""
        from ... import numpy as mxnp
        return [mxnp.zeros((self._num_layers * self._dir, batch_size,
                            self._hidden_size), ctx=ctx, dtype=self._dtype)
                for _ in range(2 if self._mode == "lstm" else 1)]

    def _finish_deferred(self, in_sz0):
        ng = _gates(self._mode)
        for layer in range(self._num_layers):
            for d in range(self._dir):
                suffix = ["l", "r"][d] + str(layer)
                in_sz = in_sz0 if layer == 0 else self._hidden_size * self._dir
                w = getattr(self, f"{suffix}_i2h_weight")
                if w.shape[1] == 0:
                    w.shape = (ng * self._hidden_size, in_sz)
                for pname in ("i2h_weight", "h2h_weight", "i2h_bias",
                              "h2h_bias"):
                    p = getattr(self, f"{suffix}_{pname}")
                    if p._data is None:
                        p.finish_deferred_init()

    def forward(self, inputs, states=None, sequence_length=None):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        t, n, c = inputs.shape
        self._finish_deferred(c)
        explicit_states = states is not None
        if states is None:
            states = self.begin_state(batch_size=n, ctx=inputs.device)
        if isinstance(states, torch.Tensor):
            states = [states]
        mode, ndir = self._mode, self._dir
        dropout = self._dropout
        training = dropout and is_training()
        key = draw_seed("rnn", inputs.device, what="RNN dropout") \
            if training else None
        h0 = states[0]
        c0 = states[1] if mode == "lstm" else states[0]
        outs = inputs
        h_list, c_list = [], []
        for layer in range(self._num_layers):
            layer_outs = []
            for d in range(ndir):
                suffix = ["l", "r"][d] + str(layer)
                sidx = layer * ndir + d
                out, h_t, c_t = run_single_direction(
                    mode, outs, h0[sidx], c0[sidx],
                    getattr(self, f"{suffix}_i2h_weight").data(),
                    getattr(self, f"{suffix}_i2h_bias").data(),
                    getattr(self, f"{suffix}_h2h_weight").data(),
                    getattr(self, f"{suffix}_h2h_bias").data(),
                    reverse=(d == 1))
                layer_outs.append(out)
                h_list.append(h_t)
                c_list.append(c_t)
            outs = layer_outs[0] if ndir == 1 else torch.cat(layer_outs, -1)
            if training and layer < self._num_layers - 1:
                keep = 1.0 - dropout
                mask = inter_layer_mask(key, layer, keep, outs.shape)
                outs = torch.where(mask, outs / keep, 0).to(outs.dtype)
        hn, cn = torch.stack(h_list), torch.stack(c_list)
        if self._layout == "NTC":
            outs = outs.swapaxes(0, 1)
        if not explicit_states:
            return outs
        if mode == "lstm":
            return outs, [hn, cn]
        return outs, hn

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__("rnn_relu" if activation == "relu" else "rnn_tanh",
                         hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, **kwargs)
