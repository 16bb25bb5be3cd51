"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each calls its functional with the arguments it was built with, by
position or by name, as the reference's ``_simple`` layers do."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import activation as F_act
from paddle_tpu_torch.nn.layer.common import param_attrs

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softmax2D", "Softplus",
           "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
           "ThresholdedReLU"]


def _simple(fname, **defaults):
    class _Act(nn.Module):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            merged = dict(defaults)
            merged.update(zip(defaults, args))
            merged.update({k: v for k, v in kwargs.items() if k in merged})
            self._kwargs = merged

        def forward(self, x):
            return getattr(F_act, fname)(x, **self._kwargs)

    return _Act


ReLU = _simple("relu")
ReLU6 = _simple("relu6")
GELU = _simple("gelu", approximate=False)
Sigmoid = _simple("sigmoid")
Tanh = _simple("tanh")
LogSigmoid = _simple("log_sigmoid")
Hardsigmoid = _simple("hardsigmoid")
Hardswish = _simple("hardswish")
Hardtanh = _simple("hardtanh", min=-1.0, max=1.0)
ELU = _simple("elu", alpha=1.0)
CELU = _simple("celu", alpha=1.0)
SELU = _simple("selu", scale=1.0507009873554805, alpha=1.6732632423543772)
LeakyReLU = _simple("leaky_relu", negative_slope=0.01)
Hardshrink = _simple("hardshrink", threshold=0.5)
Softshrink = _simple("softshrink", threshold=0.5)
Tanhshrink = _simple("tanhshrink")
Softplus = _simple("softplus", beta=1, threshold=20)
Softsign = _simple("softsign")
Swish = _simple("swish")
Silu = _simple("silu")
Mish = _simple("mish")
ThresholdedReLU = _simple("thresholded_relu", threshold=1.0)
GLU = _simple("glu", axis=-1)
RReLU = _simple("rrelu", lower=0.125, upper=1.0 / 3.0)
Softmax = _simple("softmax", axis=-1)
LogSoftmax = _simple("log_softmax", axis=-1)


class PReLU(nn.Module):
    """``weight`` ``[num_parameters]`` filled with ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        param_attrs("PReLU", weight_attr=weight_attr)
        self._data_format = data_format
        self.weight = nn.Parameter(torch.full((num_parameters,), init,
                                              device=device, dtype=dtype))

    def forward(self, x):
        return F_act.prelu(x, self.weight, self._data_format)


class Maxout(nn.Module):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F_act.maxout(x, self.groups, self.axis)


class Softmax2D(nn.Module):
    """Softmax over the channel axis of ``[C, H, W]`` or ``[N, C, H, W]``
    inputs."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects 3-D or 4-D input")
        return F_act.softmax(x, axis=-3)
