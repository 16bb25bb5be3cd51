"""Neural-network layers and functionals of the port."""
from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                                      RMSNorm)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm",
           "functional"]
