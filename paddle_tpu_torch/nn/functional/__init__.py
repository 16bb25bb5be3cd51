"""Functionals of the port (``paddle_tpu_torch.nn.functional``)."""
from paddle_tpu_torch.nn.functional.activation import gelu
from paddle_tpu_torch.nn.functional.common import dropout, linear, matmul
from paddle_tpu_torch.nn.functional.loss import cross_entropy
from paddle_tpu_torch.nn.functional.norm import (fused_ln_residual,
                                                 layer_norm, rms_norm)
from paddle_tpu_torch.nn.functional.transformer import (
    scaled_dot_product_attention, sparse_attention)

__all__ = ["cross_entropy", "dropout", "fused_ln_residual", "gelu",
           "layer_norm", "linear", "matmul", "rms_norm",
           "scaled_dot_product_attention", "sparse_attention"]
