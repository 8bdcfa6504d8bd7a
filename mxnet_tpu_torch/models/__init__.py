"""Model families of the port."""
from .transformer import (BertModel, MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer,
                          bert_base, bert_large)

__all__ = ["BertModel", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoder", "TransformerEncoderLayer", "bert_base",
           "bert_large"]
