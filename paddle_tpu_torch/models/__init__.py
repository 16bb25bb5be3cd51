"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from paddle_tpu_torch.models import bert, ernie, gpt, vit  # noqa: F401
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertForSequenceClassification,
                                          BertModel,
                                          BertPretrainingCriterion,
                                          bert_base, bert_large, bert_tiny)
from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieForPretraining,
                                           ErnieForSequenceClassification,
                                           ErnieModel, ernie_3_0_base,
                                           ernie_3_0_medium, ernie_tiny)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTModel, GPTPretrainingCriterion,
                                         gpt3_1p3b, gpt3_tiny)
from paddle_tpu_torch.models.vit import (ViT, ViTConfig, VisionTransformer,
                                         vit_b_16, vit_l_16, vit_tiny)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "BertPretrainingCriterion", "ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion", "ViT",
           "ViTConfig", "VisionTransformer", "bert", "bert_base",
           "bert_large", "bert_tiny", "ernie", "ernie_3_0_base",
           "ernie_3_0_medium", "ernie_tiny", "gpt", "gpt3_1p3b", "gpt3_tiny",
           "vit", "vit_b_16", "vit_l_16", "vit_tiny"]
