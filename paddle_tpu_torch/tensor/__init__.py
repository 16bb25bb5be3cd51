"""Tensor functions of the port that its modules need (counterpart of
``paddle_tpu/tensor/``): :func:`rand` on the global key, :func:`topk` in
jax's tie order, and :func:`einsum` under autocast."""
from paddle_tpu_torch.tensor.einsum import einsum
from paddle_tpu_torch.tensor.random import rand
from paddle_tpu_torch.tensor.search import topk

__all__ = ["einsum", "rand", "topk"]
