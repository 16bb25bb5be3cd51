"""Linear, Embedding and Dropout layers (counterpart of
``paddle_tpu/nn/layer/common.py``).

Weights keep the reference's layout and names: Linear holds
``weight [in, out]`` and ``bias [out]``, Embedding ``weight
[num, dim]``. Weights are drawn from ``Normal(0, std)`` with an explicit
``torch.Generator``; biases start at zero. Dropout draws from the global
key (:mod:`paddle_tpu_torch.framework.state`), as the reference's does.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["Dropout", "Embedding", "Linear", "normal_parameter"]


def normal_parameter(shape, std, device=None, dtype=None, generator=None):
    """A parameter drawn from Normal(0, std); ``generator`` must live on
    ``device`` (None: a fresh one seeded 0)."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=t.device).manual_seed(0)
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, std=0.02, has_bias=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.weight = normal_parameter((in_features, out_features), std,
                                       device, dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, std=0.02, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, embedding_dim), std,
                                       device, dtype, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Dropout (see :func:`paddle_tpu_torch.nn.functional.dropout`): its
    masks come from the global key. A no-op in eval mode, which is how
    serving runs it."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)
