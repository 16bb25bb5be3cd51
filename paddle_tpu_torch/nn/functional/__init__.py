"""Functionals of the port (``paddle_tpu_torch.nn.functional``)."""
from paddle_tpu_torch.nn.functional.activation import gelu, softmax
from paddle_tpu_torch.nn.functional.common import (alpha_dropout, dropout,
                                                   dropout2d, dropout3d,
                                                   linear, matmul)
from paddle_tpu_torch.nn.functional.input import one_hot
from paddle_tpu_torch.nn.functional.loss import (cross_entropy,
                                                 fused_linear_cross_entropy)
from paddle_tpu_torch.nn.functional.norm import (fused_ln_residual,
                                                 layer_norm, rms_norm)
from paddle_tpu_torch.nn.functional.transformer import (
    scaled_dot_product_attention, sparse_attention)

__all__ = ["alpha_dropout", "cross_entropy", "dropout", "dropout2d",
           "dropout3d", "fused_linear_cross_entropy", "fused_ln_residual",
           "gelu", "layer_norm", "linear", "matmul", "one_hot", "rms_norm",
           "scaled_dot_product_attention", "softmax", "sparse_attention"]
