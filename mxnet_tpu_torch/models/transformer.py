"""Transformer / BERT encoder (counterpart of
`mxnet_tpu/models/transformer.py`).

The same architecture, parameter names and layouts as the reference:
activations are (batch, seq, units), attention runs on (B, H, T, D),
Dense weights are stored (out, in).  ``use_flash=True`` routes attention
through the flash kernels (`ops/flash_attention.py`: B3 forward, B4/B5
backward on the card), which apply the (B, T) key-padding mask and
attention dropout in-kernel; ``False`` takes the dense path (two batched
products and a softmax); ``"auto"`` takes flash on a CUDA tensor once T
reaches the crossover, where the kernels take the dtype and head dim
(`flash_auto`).  `BertForPretraining` adds the MLM and NSP heads.
The dense attention's two products and the MLM head's product go
through ``mx.np`` (``np.einsum``, ``np.matmul``), and the Dense layers
through ``npx.fully_connected``, so that ``amp.init`` reaches them as it
reaches the reference's.  ``remat=True`` puts an `npx.remat` boundary
around every encoder layer: the backward recomputes each layer from its
input, drawing the dropout and attention-dropout bits its forward drew.

Not ported yet: the sequence-parallel ring (`bind_sp_mesh`) and the
tensor-parallel partition rules.
"""
from __future__ import annotations

import math

import torch

from .. import initializer as init
from .. import numpy as np
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from .. import numpy_extension as npx
from ..ops.flash_attention import flash_supported
from ..ops.invoke import is_backward_expected, is_training

__all__ = [
    "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderLayer",
    "TransformerEncoder", "BertModel", "BertForPretraining", "bert_base",
    "bert_large", "flash_auto",
]

# The flash-vs-dense crossovers of the auto policy: the smallest T from
# which flash beats the model's dense attention at head dims 64 and 256
# alike, on an H100 with BERT's key-padding mask (`chip_smoke.py` phase
# 3d, ``flash_crossover_policy:``).  The forward wins at D = 64 from
# T = 128-256 but at D = 256 only at 2048.  Forward plus backward with
# dropout 0.1 wins at D = 64 from 1024 and at D = 256 at no T up to
# 2048 (B4/B5 past 128 are several times SDPA's backward), so the
# training constant stays the reference's 1024, which D = 64 confirms.
FLASH_AUTO_MIN_T = 2048           # fwd-only (inference) crossover
FLASH_AUTO_MIN_T_TRAINING = 1024  # fwd+bwd crossover


def _flash_shape_ok(t):
    """The shape contract of the auto policy: T <= 128 or a multiple of
    128, as in the reference."""
    return t <= 128 or t % 128 == 0


def flash_auto(device_type, dtype, head_dim, batch_heads, t, mask_ndim,
               backward):
    """The ``use_flash="auto"`` policy for one call: flash only on a CUDA
    tensor (the CPU runs the kernels' plain versions, which save
    nothing), with no mask or a (batch, seq) key-padding mask
    (``mask_ndim`` None or 2), at T past the crossover (the training one
    when a backward is expected) and within the shape contract, and only
    for what the kernels take (`flash_supported`: dtype, head dim,
    batch*heads)."""
    min_t = FLASH_AUTO_MIN_T_TRAINING if backward else FLASH_AUTO_MIN_T
    return (device_type == "cuda" and mask_ndim in (None, 2) and
            t >= min_t and _flash_shape_ok(t) and
            flash_supported(dtype, head_dim, batch_heads))


class MultiHeadAttention(HybridBlock):
    """Scaled dot-product multi-head attention over (batch, seq, units)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 dtype="float32", use_flash="auto"):
        super().__init__()
        if units % num_heads:
            raise ValueError("num_heads must divide units")
        if not (use_flash is True or use_flash is False or
                use_flash == "auto"):
            raise ValueError(
                f"use_flash must be True, False, or 'auto'; got "
                f"{use_flash!r}")
        self._units = units
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._use_flash = use_flash
        self._attn_dropout_rate = dropout
        std = init.Normal(0.02)
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, nn.Dense(
                units, flatten=False, use_bias=use_bias,
                weight_initializer=std, dtype=dtype, in_units=units))
        self.attn_dropout = nn.Dropout(dropout)

    def _flash_now(self, q, mask):
        """The use_flash policy for this call, on q (B, T, H, D):
        `flash_auto` for "auto", else the forced choice."""
        if self._use_flash == "auto":
            b, t, h, d = q.shape
            return flash_auto(q.device.type, q.dtype, d, b * h, t,
                              None if mask is None else mask.ndim,
                              is_backward_expected())
        return self._use_flash

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        h, d = self._num_heads, self._head_dim
        q = self.query(x).reshape(b, t, h, d)
        k = self.key(x).reshape(b, t, h, d)
        v = self.value(x).reshape(b, t, h, d)
        if self._flash_now(q, mask):
            if mask is not None and mask.ndim != 2:
                raise ValueError(
                    "use_flash runs key-padding (batch, seq) masks "
                    "in-kernel; full (b, t, s) attention masks take the "
                    "dense path (use_flash=False)")
            drop = self._attn_dropout_rate if is_training() else 0.0
            out = npx.flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), mask=mask, dropout=drop)
            out = out.transpose(1, 2).reshape(b, t, h * d)
            return self.proj(out)
        scores = np.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
        if mask is not None:
            # (b, s) valid-token mask or (b, t, s) attention mask
            mask = mask.reshape(b, 1, 1, t) if mask.ndim == 2 else \
                mask.reshape(b, 1, t, t)
            # -1e9 in the scores' dtype, as the reference's full_like
            # rounds it (f16: -inf)
            fill = torch.tensor(-1e9).to(scores.dtype)
            scores = scores.masked_fill(mask == 0, fill)
        attn = npx.softmax(scores, axis=-1)
        attn = self.attn_dropout(attn)
        out = np.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, h * d)
        return self.proj(out)


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32"):
        super().__init__()
        std = init.Normal(0.02)
        self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                              weight_initializer=std, dtype=dtype,
                              in_units=units)
        self.act = nn.GELU() if activation == "gelu" else \
            nn.Activation(activation)
        self.ffn_2 = nn.Dense(units, flatten=False, weight_initializer=std,
                              dtype=dtype, in_units=hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ffn_2(self.act(self.ffn_1(x))))


class TransformerEncoderLayer(HybridBlock):
    """Post-norm (BERT-style) encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 layer_norm_eps=1e-12, dtype="float32", use_flash="auto"):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=dropout, dtype=dtype,
                                            use_flash=use_flash)
        self.attn_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   dtype=dtype)
        self.ffn_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        x = self.attn_ln(x + self.dropout(self.attention(x, mask)))
        return self.ffn_ln(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """``num_layers`` encoder layers; ``remat=True`` runs each through an
    `npx.remat` boundary, so the backward keeps a layer's input instead
    of its intermediates and recomputes them."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, layer_norm_eps=1e-12, dtype="float32",
                 use_flash="auto", remat=False):
        super().__init__()
        self._num_layers = num_layers
        self._remat = remat
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    TransformerEncoderLayer(units, hidden_size, num_heads,
                                            dropout=dropout,
                                            layer_norm_eps=layer_norm_eps,
                                            dtype=dtype,
                                            use_flash=use_flash))

    def forward(self, x, mask=None):
        for i in range(self._num_layers):
            layer = getattr(self, f"layer{i}")
            x = npx.remat(layer)(x, mask) if self._remat else layer(x, mask)
        return x


class BertModel(HybridBlock):
    """BERT encoder: token + segment + position embeddings -> encoder ->
    (sequence output, pooled output)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 num_segments=2, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", use_flash="auto", remat=False):
        super().__init__()
        self._units = units
        std = init.Normal(0.02)
        self.word_embed = nn.Embedding(vocab_size, units,
                                       weight_initializer=std, dtype=dtype)
        self.segment_embed = nn.Embedding(num_segments, units,
                                          weight_initializer=std, dtype=dtype)
        self.position_embed = Parameter("position_embed",
                                        shape=(max_length, units),
                                        init=std, dtype=dtype)
        self.embed_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout=dropout,
                                          layer_norm_eps=layer_norm_eps,
                                          dtype=dtype, use_flash=use_flash,
                                          remat=remat)
        self.pooler = nn.Dense(units, flatten=False, activation="tanh",
                               weight_initializer=std, dtype=dtype,
                               in_units=units)

    def forward(self, tokens, segments=None, valid_mask=None):
        b, t = tokens.shape
        x = self.word_embed(tokens)
        if segments is not None:
            x = x + self.segment_embed(segments)
        x = x + self.position_embed.data()[:t]
        x = self.embed_dropout(self.embed_ln(x))
        seq = self.encoder(x, valid_mask)
        pooled = self.pooler(seq[:, 0, :])
        return seq, pooled


class BertForPretraining(HybridBlock):
    """MLM + next-sentence heads over BertModel (the pretraining step of
    the repo's BERT benchmark).  The MLM decoder is tied to the word
    embedding: ``bert.word_embed.weight`` is one parameter that gets
    gradient from the gather and from the vocab product."""

    def __init__(self, **kwargs):
        super().__init__()
        self.bert = BertModel(**kwargs)
        units = self.bert._units
        std = init.Normal(0.02)
        self.mlm_transform = nn.Dense(units, flatten=False, activation=None,
                                      weight_initializer=std, in_units=units)
        self.mlm_act = nn.GELU()
        # the LayerNorm default eps (1e-5), not the encoder's 1e-12
        self.mlm_ln = nn.LayerNorm(in_channels=units)
        # decoder bias; the kernel is tied to the word embedding
        self.mlm_bias = Parameter("mlm_bias",
                                  shape=(self.bert.word_embed._input_dim,),
                                  init=init.Zero())
        self.nsp = nn.Dense(2, flatten=False, weight_initializer=std,
                            in_units=units)

    def forward(self, tokens, segments=None, valid_mask=None):
        seq, pooled = self.bert(tokens, segments, valid_mask)
        h = self.mlm_ln(self.mlm_act(self.mlm_transform(seq)))
        embed_w = self.bert.word_embed.weight.data()     # (vocab, units)
        mlm_logits = np.matmul(h, embed_w.t()) + self.mlm_bias.data()
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits


def bert_base(**kwargs):
    cfg = dict(vocab_size=30522, units=768, hidden_size=3072, num_layers=12,
               num_heads=12)
    cfg.update(kwargs)
    return BertModel(**cfg)


def bert_large(**kwargs):
    cfg = dict(vocab_size=30522, units=1024, hidden_size=4096, num_layers=24,
               num_heads=16)
    cfg.update(kwargs)
    return BertModel(**cfg)
