"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch

__all__ = ["dropout", "linear"]


def linear(x, weight, bias=None):
    """``y = x @ W + b`` with W laid out ``[in, out]``, as in the
    reference."""
    return torch.nn.functional.linear(x, weight.t(), bias)


def dropout(x, p=0.5, training=True, generator=None):
    """Inverted dropout drawing its mask from ``generator`` (a
    ``torch.Generator`` on x's device; None: a fresh one seeded 0)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)
