"""LSTM language model, BASELINE config 5 (counterpart of
`mxnet_tpu/models/rnn_lm.py`; the reference's ``example/rnn/word_lm``).

The classic word LM: Embedding -> dropout -> stacked recurrent layer
(`gluon.rnn`) -> dropout -> a Dense decoder over the vocabulary, or with
``tie_weights`` the embedding matrix transposed; the Dense decoder takes
its input width at the first forward, as the reference's.  The
parameter names are the reference's.
"""
from __future__ import annotations

from .. import numpy as np
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["RNNModel"]


class RNNModel(HybridBlock):
    """Word-level RNN language model: ``mode`` in {'rnn_relu',
    'rnn_tanh', 'lstm', 'gru'}; ``tie_weights`` decodes through the
    embedding (requires ``num_hidden == num_embed``)."""

    def __init__(self, vocab_size, num_embed=200, num_hidden=200,
                 num_layers=2, mode="lstm", dropout=0.5, tie_weights=False):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_hidden = num_hidden
        self.tie_weights = tie_weights
        self.drop = nn.Dropout(dropout)
        self.encoder = nn.Embedding(vocab_size, num_embed)
        if mode == "lstm":
            self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                input_size=num_embed)
        elif mode == "gru":
            self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                               input_size=num_embed)
        elif mode in ("rnn_relu", "rnn_tanh"):
            self.rnn = rnn.RNN(num_hidden, num_layers,
                               activation=mode.split("_")[1], dropout=dropout,
                               input_size=num_embed)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if tie_weights:
            if num_hidden != num_embed:
                raise ValueError("tie_weights requires num_hidden==num_embed")
            self.decoder = None
        else:
            self.decoder = nn.Dense(vocab_size, flatten=False)

    def begin_state(self, batch_size, ctx=None):
        return self.rnn.begin_state(batch_size, ctx=ctx)

    def forward(self, inputs, state=None):
        """inputs: (T, N) int tokens -> logits (T, N, V), and the new
        state when ``state`` is given."""
        emb = self.drop(self.encoder(inputs))
        if state is None:
            output = self.rnn(emb)
        else:
            output, state = self.rnn(emb, state)
        output = self.drop(output)
        if self.tie_weights:
            logits = np.matmul(output, self.encoder.weight.data().T)
        else:
            logits = self.decoder(output)
        return (logits, state) if state is not None else logits
