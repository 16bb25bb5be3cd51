"""LayerNorm and RMSNorm layers (counterparts of
``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import norm as F_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes with
    ``weight`` (ones) and ``bias`` (zeros). ``fused`` as in
    :func:`paddle_tpu_torch.nn.functional.layer_norm`: None picks the
    kernel for CUDA tensors."""

    def __init__(self, normalized_shape, epsilon=1e-5, fused=None,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = float(epsilon)
        self._fused = fused
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F_norm.layer_norm(x, self._normalized_shape, self.weight,
                                 self.bias, self._epsilon, fused=self._fused)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with ``weight`` (ones, the reference's
    name, so a ``paddle_tpu`` state dict loads by name). ``fused`` as in
    :func:`paddle_tpu_torch.nn.functional.rms_norm`: None picks the
    kernel for CUDA tensors."""

    def __init__(self, hidden_size, epsilon=1e-6, fused=None, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        self._fused = fused
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F_norm.rms_norm(x, self.weight, self._epsilon,
                               fused=self._fused)
