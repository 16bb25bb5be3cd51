"""Top-k (counterpart of ``paddle_tpu/tensor/search.py``)."""
from __future__ import annotations

import torch

__all__ = ["topk"]


def topk(x, k, axis=-1, largest=True):
    """The ``k`` largest (``largest=False``: smallest) values along
    ``axis`` and their int64 indices, in order, ties to the lower index
    as ``jax.lax.top_k`` breaks them (``torch.topk`` does not): a stable
    sort. Differentiable in ``x`` through the values."""
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
