"""Layers of the port (``paddle_tpu_torch.nn.layer``)."""
from paddle_tpu_torch.nn.layer.activation import (ELU, GELU, Hardswish,
                                                  LeakyReLU, ReLU, ReLU6,
                                                  Sigmoid, Silu, Softmax,
                                                  Tanh)
from paddle_tpu_torch.nn.layer.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layer.container import (LayerDict, LayerList,
                                                 ParameterList, Sequential)
from paddle_tpu_torch.nn.layer.conv import Conv1D, Conv2D, Conv3D
from paddle_tpu_torch.nn.layer.norm import (BatchNorm, BatchNorm1D,
                                            BatchNorm2D, BatchNorm3D,
                                            LayerNorm, RMSNorm)
from paddle_tpu_torch.nn.layer.pooling import (AdaptiveAvgPool1D,
                                               AdaptiveAvgPool2D,
                                               AdaptiveAvgPool3D, AvgPool1D,
                                               AvgPool2D, AvgPool3D,
                                               MaxPool1D, MaxPool2D,
                                               MaxPool3D)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "Conv1D", "Conv2D", "Conv3D", "Dropout", "ELU", "Embedding",
           "GELU", "Hardswish", "LayerDict", "LayerList", "LayerNorm",
           "LeakyReLU", "Linear", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "ParameterList", "RMSNorm", "ReLU", "ReLU6", "Sequential",
           "Sigmoid", "Silu", "Softmax", "Tanh"]
