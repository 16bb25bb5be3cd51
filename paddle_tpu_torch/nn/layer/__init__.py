"""Layers of the port (``paddle_tpu_torch.nn.layer``)."""
from paddle_tpu_torch.nn.layer.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm"]
