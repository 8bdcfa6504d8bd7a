"""RNN cells, steppable one timestep at a time (counterpart of
`mxnet_tpu/gluon/rnn/rnn_cell.py`).

`RecurrentCell.unroll` runs the cell over a sequence in a Python loop
of torch ops (a captured `gluon.FusedTrainStep` replays it as one CUDA
graph); the fused layers of `rnn_layer` are the faster path for long
sequences.  The modifier cells' random draws (`DropoutCell`,
`ZoneoutCell`, `VariationalDropoutCell`) go through `npx.dropout`, so
they take their seed words from the scope's generator like every other
train-mode draw of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import numpy as mxnp
from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ...ops.invoke import is_training
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "LSTMPCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "VariationalDropoutCell",
           "BidirectionalCell"]


class RecurrentCell(HybridBlock):
    def __init__(self):
        super().__init__()
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero f32 states of `state_info`'s shapes on ``ctx`` (None: the
        card)."""
        return [mxnp.zeros(info["shape"], ctx=ctx)
                for info in self.state_info(batch_size)]

    def reset(self):
        """Clear per-sequence state, in the child cells too."""
        for child in self.children():
            if isinstance(child, RecurrentCell):
                child.reset()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` (a tensor in
        ``layout``, or a list of per-step (N, ...) tensors), from
        ``begin_state`` (zeros by default).  Steps at or past a
        sequence's ``valid_length`` output zeros.  Returns the outputs
        (stacked along the time axis if ``merge_outputs``; by default as
        the inputs came) and the last states.  Per-sequence state (the
        locked dropout masks) is reset first."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != length:
                raise ValueError(f"unroll length {length} != len(inputs) "
                                 f"{len(inputs)}")
            steps = list(inputs)
            batch_size = steps[0].shape[0]
            device = steps[0].device
        else:
            batch_size = inputs.shape[layout.find("N")]
            device = inputs.device
            steps = list(inputs.unbind(axis))[:length]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=device)
        states = begin_state
        outputs = []
        for step_input in steps:
            out, states = self(step_input, states)
            outputs.append(out)
        if valid_length is not None:
            stacked = npx.sequence_mask(mxnp.stack(outputs, axis=0),
                                        valid_length,
                                        use_sequence_length=True, axis=0)
            outputs = list(stacked.unbind(0))
        merge = merge_outputs if merge_outputs is not None else \
            not isinstance(inputs, (list, tuple))
        if merge:
            return mxnp.stack(outputs, axis=axis), states
        return outputs, states


class _BaseRNNCell(RecurrentCell):
    def __init__(self, hidden_size, num_gates, input_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = num_gates
        self.i2h_weight = Parameter(
            "i2h_weight", shape=(ng * hidden_size, input_size),
            init=_resolve_init(i2h_weight_initializer),
            allow_deferred_init=True)
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(ng * hidden_size, hidden_size),
            init=_resolve_init(h2h_weight_initializer),
            allow_deferred_init=True)
        self.i2h_bias = Parameter(
            "i2h_bias", shape=(ng * hidden_size,),
            init=_resolve_init(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = Parameter(
            "h2h_bias", shape=(ng * hidden_size,),
            init=_resolve_init(h2h_bias_initializer),
            allow_deferred_init=True)
        self._ng = ng

    def _finish(self, x):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._ng * self._hidden_size,
                                     x.shape[-1])
        for p in (self.i2h_weight, self.h2h_weight, self.i2h_bias,
                  self.h2h_bias):
            if p._data is None:
                p.finish_deferred_init()

    def _proj(self, x, states):
        self._finish(x)
        i2h = F.linear(x, self.i2h_weight.data(), self.i2h_bias.data())
        h2h = F.linear(states[0], self.h2h_weight.data(),
                       self.h2h_bias.data())
        return i2h, h2h


def _activate(x, activation):
    if activation in ("relu", "tanh", "sigmoid", "softrelu"):
        return npx.activation(x, act_type=activation)
    return getattr(npx, activation)(x)


class RNNCell(_BaseRNNCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__(hidden_size, 1, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        out = _activate(i2h + h2h, self._activation)
        return out, [out]


class LSTMCell(_BaseRNNCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation="tanh", recurrent_activation="sigmoid"):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        i, f, c_in, o = (i2h + h2h).chunk(4, -1)
        next_c = torch.sigmoid(f) * states[1] + \
            torch.sigmoid(i) * torch.tanh(c_in)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseRNNCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__(hidden_size, 3, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        rx, zx, nx = i2h.chunk(3, -1)
        rh, zh, nh = h2h.chunk(3, -1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        next_h = (1 - z) * n + z * states[0]
        return next_h, [next_h]


class LSTMPCell(_BaseRNNCell):
    """LSTM with a projected hidden state (Sak et al. 2014): states are
    [h (projection_size,), c (hidden_size,)] and h = (o * tanh(c'))
    W_h2r^T."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer)
        self._projection_size = projection_size
        # h2h takes the projected state
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=_resolve_init(h2h_weight_initializer),
            allow_deferred_init=True)
        self.h2r_weight = Parameter(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=_resolve_init(h2r_weight_initializer),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        if self.h2r_weight._data is None:
            self.h2r_weight.finish_deferred_init()
        i, f, c_in, o = (i2h + h2h).chunk(4, -1)
        next_c = torch.sigmoid(f) * states[1] + \
            torch.sigmoid(i) * torch.tanh(c_in)
        hidden = torch.sigmoid(o) * torch.tanh(next_c)
        next_h = F.linear(hidden, self.h2r_weight.data())
        return next_h, [next_h, next_c]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each cell's output is the next one's input; the
    states are the cells' states concatenated."""

    def __init__(self):
        super().__init__()
        self._cells = []

    def add(self, cell):
        setattr(self, str(len(self._cells)), cell)
        self._cells.append(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._cells
                for info in cell.state_info(batch_size)]

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)


class DropoutCell(RecurrentCell):
    """Dropout of the inputs at rate ``rate`` in train mode (``axes``:
    as `npx.dropout`'s); no state."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = npx.dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """In train mode, each element of the output (the states) keeps its
    previous value with probability ``zoneout_outputs``
    (``zoneout_states``) instead of taking the new one."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not is_training():
            return next_output, next_states
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = mxnp.zeros_like(next_output)

        def zone(new, old, rate):
            if rate == 0.0:
                return new
            # 1 (keep the previous value) with probability ``rate``: the
            # elements dropout keeps at rate 1 - rate
            mask = (npx.dropout(mxnp.ones_like(new), p=1.0 - rate,
                                mode="always") != 0).to(new.dtype)
            return mask * old + (1 - mask) * new

        output = zone(next_output, prev_output, self._zoneout_outputs)
        new_states = [zone(ns, os, self._zoneout_states)
                      for ns, os in zip(next_states, states)]
        self._prev_output = output
        return output, new_states


class ResidualCell(_ModifierCell):
    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed
    (each sequence within its ``valid_length``), outputs concatenated
    along the last axis; `unroll` only."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def forward(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell supports unroll() only (step direction is "
            "ambiguous), as in the reference")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            inputs = mxnp.stack(list(inputs), axis=axis)
            if merge_outputs is None:
                merge_outputs = False
        batch_size = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=inputs.device)
        n_l = len(self.l_cell.state_info())
        with_lengths = valid_length is not None
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, True, valid_length)
        rev = npx.sequence_reverse(inputs.swapaxes(0, axis), valid_length,
                                   use_sequence_length=with_lengths, axis=0)
        r_out, r_states = self.r_cell.unroll(
            length, rev.swapaxes(0, axis), begin_state[n_l:], layout, True,
            valid_length)
        r_out = npx.sequence_reverse(r_out.swapaxes(0, axis), valid_length,
                                     use_sequence_length=with_lengths,
                                     axis=0).swapaxes(0, axis)
        out = mxnp.concatenate([l_out, r_out], axis=-1)
        if merge_outputs is False:
            out = list(out.unbind(axis))
        return out, l_states + r_states


class VariationalDropoutCell(_ModifierCell):
    """Variational (locked) dropout over a base cell (Gal & Ghahramani
    2016): one mask per sequence for the inputs, the first state and the
    outputs, the same at every step until `reset` (which `unroll` calls)
    draws new ones."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise ValueError(
                "BidirectionalCell doesn't support variational state "
                "dropout; wrap the cells underneath instead")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._mask_in = None
        self._mask_st = None
        self._mask_out = None

    def reset(self):
        super().reset()
        self._mask_in = self._mask_st = self._mask_out = None

    @staticmethod
    def _mask(like, rate):
        # inverted-dropout mask, scaled as dropout scales
        return npx.dropout(mxnp.ones_like(like), p=rate, mode="always")

    def forward(self, inputs, states):
        training = is_training()
        if training:
            if self.drop_inputs:
                if self._mask_in is None:
                    self._mask_in = self._mask(inputs, self.drop_inputs)
                inputs = inputs * self._mask_in
            if self.drop_states:
                if self._mask_st is None:
                    self._mask_st = self._mask(states[0], self.drop_states)
                states = [states[0] * self._mask_st] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if training and self.drop_outputs:
            if self._mask_out is None:
                self._mask_out = self._mask(output, self.drop_outputs)
            output = output * self._mask_out
        return output, next_states


# the reference's class names: every cell here is hybrid-capable, so the
# Hybrid* variants and the modifier base are the same classes
HybridRecurrentCell = RecurrentCell
HybridSequentialRNNCell = SequentialRNNCell
ModifierCell = _ModifierCell
