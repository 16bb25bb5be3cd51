"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["elu", "gelu", "hardswish", "leaky_relu", "relu", "relu6",
           "sigmoid", "silu", "softmax", "tanh"]


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0):
    return torch.nn.functional.elu(x, alpha)


def leaky_relu(x, negative_slope=0.01):
    return torch.nn.functional.leaky_relu(x, negative_slope)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def silu(x):
    return torch.nn.functional.silu(x)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softmax(x, axis=-1, dtype=None):
    """Softmax along ``axis``, in ``dtype`` when given; else under
    autocast a narrow-float input is raised to f32 first (``softmax`` is
    on the reference's black list)."""
    if dtype is not None:
        x = x.to(dtype)
    else:
        (x,) = downcast_inputs(x, opname="softmax")
    return torch.softmax(x, dim=axis)
