"""Layers of the port (``paddle_tpu_torch.nn.layer``)."""
from paddle_tpu_torch.nn.layer import (activation, common, distance, loss,
                                       rnn, transformer)
from paddle_tpu_torch.nn.layer.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer.container import (LayerDict, LayerList,
                                                 ParameterList, Sequential)
from paddle_tpu_torch.nn.layer.conv import Conv1D, Conv2D, Conv3D
from paddle_tpu_torch.nn.layer.distance import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer.norm import (BatchNorm, BatchNorm1D,
                                            BatchNorm2D, BatchNorm3D,
                                            LayerNorm, RMSNorm)
from paddle_tpu_torch.nn.layer.pooling import (AdaptiveAvgPool1D,
                                               AdaptiveAvgPool2D,
                                               AdaptiveAvgPool3D, AvgPool1D,
                                               AvgPool2D, AvgPool3D,
                                               MaxPool1D, MaxPool2D,
                                               MaxPool3D)
from paddle_tpu_torch.nn.layer.rnn import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer.transformer import *  # noqa: F401,F403

__all__ = sorted(
    activation.__all__ + [n for n in common.__all__
                          if n != "normal_parameter"]
    + distance.__all__ + loss.__all__ + rnn.__all__ + transformer.__all__
    + ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
       "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
       "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv2D", "Conv3D",
       "LayerDict", "LayerList", "LayerNorm", "MaxPool1D", "MaxPool2D",
       "MaxPool3D", "ParameterList", "RMSNorm", "Sequential"])
