"""BatchNorm, LayerNorm and RMSNorm layers (counterparts of
``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.framework.state import register_state_tensor, state_init
from paddle_tpu_torch.nn.functional import activation as F_act
from paddle_tpu_torch.nn.functional import norm as F_norm

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm"]


class _BatchNormBase(nn.Module):
    """``weight`` (ones) and ``bias`` (zeros) unless ``weight_attr`` /
    ``bias_attr`` is False, and the running statistics as the buffers
    ``_mean`` (zeros) and ``_variance`` (ones), the reference's names.
    A training step changes those buffers in place, so they are
    registered state tensors (:mod:`paddle_tpu_torch.framework.state`):
    ``to_static`` restores them after its warm-up calls, as it restores
    the weights, and its captured step then starts from the same
    statistics as an eager one. A buffer replaced by ``Module.to`` is
    registered at its next forward."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        factory = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **factory))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **factory))
        self.register_buffer("_mean", torch.zeros(num_features, **factory))
        self.register_buffer("_variance", torch.ones(num_features, **factory))
        self._register_stats()

    def _register_stats(self):
        register_state_tensor(self._mean, init=0.0)
        register_state_tensor(self._variance, init=1.0)

    def forward(self, input):
        if state_init(self._mean) is None \
                or state_init(self._variance) is None:
            self._register_stats()
        return F_norm.batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm: BatchNorm2D with an optional activation
    (``act``, the name of a functional such as ``"relu"``)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 data_format="NCHW", **factory):
        super().__init__(num_channels, momentum, epsilon,
                         data_format=data_format, **factory)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(F_act, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, **kw)


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
