"""Recurrent layers and cells of the port (counterpart of
`mxnet_tpu/gluon/rnn/`)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (
    RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell, LSTMPCell,
    GRUCell, SequentialRNNCell, HybridSequentialRNNCell, DropoutCell,
    ModifierCell, ZoneoutCell, ResidualCell, VariationalDropoutCell,
    BidirectionalCell,
)
from .conv_rnn_cell import (
    ConvRNNCell, ConvLSTMCell, ConvGRUCell,
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell,
)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "LSTMPCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "VariationalDropoutCell", "BidirectionalCell", "ConvRNNCell",
           "ConvLSTMCell", "ConvGRUCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]
