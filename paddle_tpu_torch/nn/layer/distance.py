"""Distance layers (counterpart of ``paddle_tpu/nn/layer/distance.py``)."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn.functional import distance as F_dist

__all__ = ["PairwiseDistance"]


class PairwiseDistance(nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F_dist.pairwise_distance(x, y, self.p, self.epsilon,
                                        self.keepdim)
