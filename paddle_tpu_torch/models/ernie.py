"""ERNIE-3.0 (counterpart of ``paddle_tpu/models/ernie.py``): a BERT
encoder (:mod:`paddle_tpu_torch.models.bert`) with a task-type embedding
added to the embeddings' output, a 40,000-token vocabulary and LayerNorm
epsilon 1e-5; the same names and layouts as the reference."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.core.device import model_factory
from paddle_tpu_torch.models.bert import (BertConfig, BertLMHead, BertModel,
                                          BertPretrainingCriterion,
                                          _padding_bias)
from paddle_tpu_torch.nn.layer import Dropout, Embedding, Linear

__all__ = ["ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieModel",
           "ErniePretrainingCriterion", "ernie_3_0_base", "ernie_3_0_medium",
           "ernie_tiny"]


class ErnieConfig(BertConfig):
    def __init__(self, task_type_vocab_size=3, use_task_id=True, **kw):
        kw.setdefault("vocab_size", 40000)
        kw.setdefault("layer_norm_epsilon", 1e-5)
        super().__init__(**kw)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id


def ernie_3_0_base(**kw):
    cfg = dict(hidden_size=768, num_layers=12, num_heads=12)
    cfg.update(kw)
    return ErnieConfig(**cfg)


def ernie_3_0_medium(**kw):
    cfg = dict(hidden_size=768, num_layers=6, num_heads=12)
    cfg.update(kw)
    return ErnieConfig(**cfg)


def ernie_tiny(**kw):
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position=128, dropout=0.0, attention_dropout=0.0)
    cfg.update(kw)
    return ErnieConfig(**cfg)


class ErnieModel(BertModel):
    """BERT's encoder plus ``task_type_embeddings`` (with
    ``use_task_id``), added when ``task_type_ids`` are given."""

    def __init__(self, config, **factory):
        super().__init__(config, **factory)
        if config.use_task_id:
            self.task_type_embeddings = Embedding(
                config.task_type_vocab_size, config.hidden_size,
                std=config.initializer_range, **factory)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        attention_mask = _padding_bias(attention_mask)
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        if self.config.use_task_id and task_type_ids is not None:
            h = h + self.task_type_embeddings(task_type_ids)
        for layer in self.encoder:
            h = layer(h, attention_mask)
        return h, self.pooler(h)


class ErnieForPretraining(nn.Module):
    """The MLM head over :class:`ErnieModel`, tied to its word embedding.
    Built on ``device`` (default CUDA)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.ernie = ErnieModel(config, **factory)
        self.cls = BertLMHead(
            config, self.ernie.embeddings.word_embeddings.weight, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        h, _ = self.ernie(input_ids, token_type_ids,
                          attention_mask=attention_mask,
                          task_type_ids=task_type_ids)
        return self.cls(h)


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, config, num_classes=2, device=None, dtype=None,
                 generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.ernie = ErnieModel(config, **factory)
        self.dropout = Dropout(config.dropout)
        self.classifier = Linear(config.hidden_size, num_classes, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


ErniePretrainingCriterion = BertPretrainingCriterion
