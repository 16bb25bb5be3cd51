"""Functionals of the port (``paddle_tpu_torch.nn.functional``)."""
from paddle_tpu_torch.nn.functional import (activation, common, distance,
                                            extension, loss)
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.conv import conv1d, conv2d, conv3d
from paddle_tpu_torch.nn.functional.distance import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.extension import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.input import embedding, one_hot
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import (batch_norm,
                                                 fused_add_layer_norm,
                                                 fused_ln_residual,
                                                 fused_norm_enabled,
                                                 layer_norm, normalize,
                                                 rms_norm, set_fused_norm)
from paddle_tpu_torch.nn.functional.pooling import (adaptive_avg_pool1d,
                                                    adaptive_avg_pool2d,
                                                    adaptive_avg_pool3d,
                                                    avg_pool1d, avg_pool2d,
                                                    avg_pool3d, max_pool1d,
                                                    max_pool2d, max_pool3d)
from paddle_tpu_torch.nn.functional.transformer import (
    scaled_dot_product_attention, sparse_attention)

__all__ = sorted(
    activation.__all__ + common.__all__ + distance.__all__
    + extension.__all__ + loss.__all__
    + ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
       "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm", "conv1d",
       "conv2d", "conv3d", "embedding", "fused_add_layer_norm",
       "fused_ln_residual", "fused_norm_enabled", "layer_norm",
       "max_pool1d", "max_pool2d", "max_pool3d", "normalize", "one_hot",
       "rms_norm", "scaled_dot_product_attention", "set_fused_norm",
       "sparse_attention"])
