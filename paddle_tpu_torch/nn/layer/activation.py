"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each calls its functional with the arguments it was built with, by
position or by name, as the reference's ``_simple`` layers do."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn.functional import activation as F_act

__all__ = ["ELU", "GELU", "Hardswish", "LeakyReLU", "ReLU", "ReLU6",
           "Sigmoid", "Silu", "Softmax", "Tanh"]


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
ELU = _simple("elu", alpha=1.0)
LeakyReLU = _simple("leaky_relu", negative_slope=0.01)
Silu = _simple("silu")
Hardswish = _simple("hardswish")
Softmax = _simple("softmax", axis=-1)
