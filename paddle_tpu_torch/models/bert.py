"""BERT encoder family (counterpart of ``paddle_tpu/models/bert.py``;
ERNIE-3.0 builds on it in :mod:`paddle_tpu_torch.models.ernie`).

The reference's configuration, module names and weight layouts, so a
state dict crosses between the two packages by name
(:mod:`paddle_tpu_torch.framework.io`). The fused qkv projection's
columns are laid out ``[head, 3 * head_dim]`` (reshaped to ``[b, s, h, 3
hd]`` and split on the last axis), a 2-D padding mask becomes the
additive ``(1 - m) * -1e4`` bias ``[b, 1, 1, s]``, and the blocks are
post-LN. The LM head is tied to the word embedding: it reads that
weight without registering it, so the state dict holds it once, under
``bert.embeddings.word_embeddings.weight``, as the reference's does.
Without a mask and without dropout, attention runs the flash kernels at
head_dim 64 (:func:`~paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`). Weights are drawn with one explicit
``torch.Generator`` in construction order: ``Normal(0,
initializer_range)`` for the embeddings and the encoder's projections,
the port's Linear default for the pooler and the heads.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import model_factory
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import (Dropout, Embedding, LayerList,
                                       LayerNorm, Linear)

__all__ = ["BertConfig", "BertEmbeddings", "BertForPretraining",
           "BertForSequenceClassification", "BertLMHead", "BertLayer",
           "BertModel", "BertPooler", "BertPretrainingCriterion",
           "BertSelfAttention", "bert_base", "bert_large", "bert_tiny"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_position=512,
                 type_vocab_size=2, dropout=0.1, attention_dropout=0.1,
                 initializer_range=0.02, layer_norm_epsilon=1e-12,
                 pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.pad_token_id = pad_token_id


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16)
    cfg.update(kw)
    return BertConfig(**cfg)


def bert_tiny(**kw):
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position=128, dropout=0.0, attention_dropout=0.0)
    cfg.update(kw)
    return BertConfig(**cfg)


def _init(config, factory):
    return dict(std=config.initializer_range, **factory)


def _ln(config, factory):
    return LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon,
                     device=factory.get("device"), dtype=factory.get("dtype"))


class BertEmbeddings(nn.Module):
    def __init__(self, config, **factory):
        super().__init__()
        init = _init(config, factory)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **init)
        self.position_embeddings = Embedding(
            config.max_position, config.hidden_size, **init)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, **init)
        self.layer_norm = _ln(config, factory)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertSelfAttention(nn.Module):
    """Bidirectional attention over a fused qkv projection."""

    def __init__(self, config, **factory):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        init = _init(config, factory)
        self.qkv_proj = ColumnParallelLinear(
            config.hidden_size, 3 * config.hidden_size, gather_output=False,
            **init)
        self.out_proj = RowParallelLinear(
            config.hidden_size, config.hidden_size, input_is_parallel=True,
            **init)
        self.attn_dropout_p = config.attention_dropout

    def forward(self, hidden, attn_mask=None):
        b, s = hidden.shape[0], hidden.shape[1]
        qkv = self.qkv_proj(hidden).reshape(b, s, self.num_heads,
                                            3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_p if self.training else 0.0,
            training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    """Post-LN encoder block (the original BERT's residual placement)."""

    def __init__(self, config, **factory):
        super().__init__()
        init = _init(config, factory)
        self.attention = BertSelfAttention(config, **factory)
        self.ln1 = _ln(config, factory)
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.ffn_hidden_size, gather_output=False,
            **init)
        self.fc2 = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size,
            input_is_parallel=True, **init)
        self.ln2 = _ln(config, factory)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attention(x, attn_mask)))
        return self.ln2(x + self.dropout(self.fc2(F.gelu(self.fc1(x)))))


class BertPooler(nn.Module):
    def __init__(self, config, **factory):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            **factory)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _padding_bias(attention_mask):
    """A 2-D ``[b, s]`` padding mask (1 keeps) as the additive logits bias
    ``[b, 1, 1, s]``; any other mask as it is."""
    if attention_mask is not None and attention_mask.dim() == 2:
        m = (1.0 - attention_mask.float()) * -1e4
        return m[:, None, None, :]
    return attention_mask


class BertModel(nn.Module):
    def __init__(self, config, **factory):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, **factory)
        self.encoder = LayerList(
            [BertLayer(config, **factory) for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, **factory)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        attention_mask = _padding_bias(attention_mask)
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            h = layer(h, attention_mask)
        return h, self.pooler(h)


class BertLMHead(nn.Module):
    """transform -> gelu -> LayerNorm -> ``h @ W_emb^T + decoder_bias``,
    with ``W_emb`` the word embedding's weight, read and not registered
    (``decoder_weight``)."""

    def __init__(self, config, embedding_weight, **factory):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                **factory)
        self.layer_norm = _ln(config, factory)
        # tied [vocab, hidden]: an attribute torch does not register, so
        # the state dict and parameters() hold the weight once
        object.__setattr__(self, "decoder_weight", embedding_weight)
        self.decoder_bias = nn.Parameter(torch.zeros(
            config.vocab_size, device=factory.get("device"),
            dtype=factory.get("dtype")))

    def forward(self, h):
        h = self.layer_norm(F.gelu(self.transform(h)))
        return F.matmul(h, self.decoder_weight, transpose_y=True) \
            + self.decoder_bias


class BertForPretraining(nn.Module):
    """MLM and NSP heads over :class:`BertModel`. Built on ``device``
    (default CUDA; RuntimeError without it unless ``device="cpu"``)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.bert = BertModel(config, **factory)
        self.cls = BertLMHead(
            config, self.bert.embeddings.word_embeddings.weight, **factory)
        self.nsp = Linear(config.hidden_size, 2, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.cls(h), self.nsp(pooled)


class BertForSequenceClassification(nn.Module):
    def __init__(self, config, num_classes=2, device=None, dtype=None,
                 generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.bert = BertModel(config, **factory)
        self.dropout = Dropout(config.dropout)
        self.classifier = Linear(config.hidden_size, num_classes, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


class BertPretrainingCriterion(nn.Module):
    """Masked LM loss (labels -100 ignored) averaged over every position,
    or over ``masked_lm_weights``; plus the NSP loss when its labels are
    given."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None,
                masked_lm_weights=None):
        mlm = F.cross_entropy(prediction_scores, masked_lm_labels,
                              reduction="none", ignore_index=-100)
        if masked_lm_weights is not None:
            w = masked_lm_weights.reshape(mlm.shape).to(mlm.dtype)
            mlm = (mlm * w).sum() / w.sum().clamp(min=1.0)
        else:
            mlm = mlm.mean()
        if next_sentence_labels is None:
            return mlm
        return mlm + F.cross_entropy(seq_relationship_score,
                                     next_sentence_labels)
