"""Input functionals (counterpart of
``paddle_tpu/nn/functional/input.py``)."""
from __future__ import annotations

import torch

__all__ = ["one_hot"]


def one_hot(x, num_classes, dtype=torch.float32):
    """``jax.nn.one_hot``: ``[..., num_classes]`` in ``dtype`` (f32 by
    default, as the reference's), an index outside ``[0, num_classes)``
    all zeros. A comparison with ``arange``, so no host read checks the
    indices (``torch.nn.functional.one_hot`` makes one) and a CUDA
    graph can capture it."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(dtype)
