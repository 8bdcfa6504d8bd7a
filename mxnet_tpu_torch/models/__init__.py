"""Model families of the port."""
from .rnn_lm import RNNModel
from .transformer import (BertForPretraining, BertModel, MultiHeadAttention,
                          PositionwiseFFN, TransformerEncoder,
                          TransformerEncoderLayer, bert_base, bert_large)

__all__ = ["BertModel", "BertForPretraining", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoder", "TransformerEncoderLayer",
           "bert_base", "bert_large", "RNNModel"]
