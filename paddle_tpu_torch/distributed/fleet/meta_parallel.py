"""Tensor-parallel layers as plain single-device layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel.py``).

The reference holds each full weight and lets XLA shard it over the
``tp`` mesh axis. On one device the sharding is absent, so the layers
are Linear and Embedding with the reference's names, layouts and
constructor arguments.
"""
from __future__ import annotations

from paddle_tpu_torch.nn.layer.common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(Linear):
    """W ``[in, out]``; the reference shards its OUT (column) axis."""

    def __init__(self, in_features, out_features, std=0.02, has_bias=True,
                 gather_output=True, device=None, dtype=None,
                 generator=None):
        super().__init__(in_features, out_features, std, has_bias, device,
                         dtype, generator)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """W ``[in, out]``; the reference shards its IN (row) axis."""

    def __init__(self, in_features, out_features, std=0.02, has_bias=True,
                 input_is_parallel=False, device=None, dtype=None,
                 generator=None):
        super().__init__(in_features, out_features, std, has_bias, device,
                         dtype, generator)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding table ``[vocab, dim]``; the reference shards the vocab
    axis."""
