"""Functionals of the port (``paddle_tpu_torch.nn.functional``)."""
from paddle_tpu_torch.nn.functional.activation import (elu, gelu, hardswish,
                                                       leaky_relu, relu,
                                                       relu6, sigmoid, silu,
                                                       softmax, tanh)
from paddle_tpu_torch.nn.functional.common import (alpha_dropout, dropout,
                                                   dropout2d, dropout3d,
                                                   linear, matmul)
from paddle_tpu_torch.nn.functional.conv import conv1d, conv2d, conv3d
from paddle_tpu_torch.nn.functional.input import embedding, one_hot
from paddle_tpu_torch.nn.functional.loss import (cross_entropy,
                                                 fused_linear_cross_entropy)
from paddle_tpu_torch.nn.functional.norm import (batch_norm,
                                                 fused_ln_residual,
                                                 layer_norm, rms_norm)
from paddle_tpu_torch.nn.functional.pooling import (adaptive_avg_pool1d,
                                                    adaptive_avg_pool2d,
                                                    adaptive_avg_pool3d,
                                                    avg_pool1d, avg_pool2d,
                                                    avg_pool3d, max_pool1d,
                                                    max_pool2d, max_pool3d)
from paddle_tpu_torch.nn.functional.transformer import (
    scaled_dot_product_attention, sparse_attention)

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "alpha_dropout",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm", "conv1d",
           "conv2d", "conv3d", "cross_entropy", "dropout", "dropout2d",
           "dropout3d", "elu", "embedding", "fused_linear_cross_entropy",
           "fused_ln_residual", "gelu", "hardswish", "layer_norm",
           "leaky_relu", "linear", "matmul", "max_pool1d", "max_pool2d",
           "max_pool3d", "one_hot", "relu", "relu6", "rms_norm",
           "scaled_dot_product_attention", "sigmoid", "silu", "softmax",
           "sparse_attention", "tanh"]
