"""Distance functionals (counterpart of
``paddle_tpu/nn/functional/distance.py``)."""
from __future__ import annotations

import torch

__all__ = ["cdist", "pairwise_distance", "pdist"]


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """``||x - y + epsilon||_p`` over the last axis."""
    d = (x - y + epsilon).abs()
    return (d ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def pdist(x, p=2.0):
    """The p-norm distances of the rows of ``[N, M]`` x, for each pair
    ``i < j`` in row-major order."""
    n = x.shape[0]
    dm = ((x[:, None, :] - x[None, :, :]).abs() ** p).sum(dim=-1) \
        ** (1.0 / p)
    i, j = torch.triu_indices(n, n, offset=1, device=x.device)
    return dm[i, j]


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """p-norm distances between the rows of x ``[..., P, M]`` and y
    ``[..., R, M]``. At p = 2 a ``"use_mm..."`` mode takes the matrix
    product form ``sqrt(max(|x|^2 + |y|^2 - 2 x y^T, 0))``, as the
    reference does."""
    if p == 2.0 and "use_mm" in compute_mode:
        x2 = (x * x).sum(dim=-1, keepdim=True)
        y2 = (y * y).sum(dim=-1, keepdim=True)
        d2 = x2 + y2.transpose(-1, -2) - 2 * (x @ y.transpose(-1, -2))
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    diff = (x[..., :, None, :] - y[..., None, :, :]).abs()
    return (diff ** p).sum(dim=-1) ** (1.0 / p)
