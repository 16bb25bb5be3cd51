"""Input functionals (counterpart of
``paddle_tpu/nn/functional/input.py``)."""
from __future__ import annotations

import torch

__all__ = ["embedding", "one_hot"]


# a table of at most this many rows (a token-type or task table, where
# thousands of positions share each row) takes its gradient as one
# product with the ids' one-hot matrix; index_put_ would walk a row's
# thousands of contributions in one warp (on an H100, ERNIE-3.0-base's
# step at 16 x 512 tokens took 45.6 ms with index_put_ for every table,
# ~36 with the product for its two small ones). Word and position tables
# repeat a row a few times at most, and take index_put_.
ONE_HOT_ROWS = 16


class _Embedding(torch.autograd.Function):
    """Rows of ``weight`` by ``ids``, with a gradient summed in a fixed
    order: as ``one_hot(ids)^T @ grad`` for a table of at most
    ``ONE_HOT_ROWS`` rows, else by ``index_put_(accumulate=True)``, which
    sorts the ids first on CUDA. Torch's own embedding backward adds
    the rows with atomics there, so an id that many positions share
    gets a gradient whose last bits change from run to run, and a
    captured step could not equal its eager twin."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.weight_shape = weight.shape
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows, dim = ctx.weight_shape
        ids, grad = ids.reshape(-1), grad.reshape(-1, dim)
        if rows <= ONE_HOT_ROWS:
            return None, one_hot(ids, rows, grad.dtype).t() @ grad
        dw = grad.new_zeros(ctx.weight_shape)
        dw.index_put_((ids,), grad, accumulate=True)
        return None, dw


def embedding(x, weight):
    """``weight[x]``: the rows of a ``[num, dim]`` table, with the same
    gradient on every run (:class:`_Embedding`)."""
    return _Embedding.apply(x, weight)


def one_hot(x, num_classes, dtype=torch.float32):
    """``jax.nn.one_hot``: ``[..., num_classes]`` in ``dtype`` (f32 by
    default, as the reference's), an index outside ``[0, num_classes)``
    all zeros. A comparison with ``arange``, so no host read checks the
    indices (``torch.nn.functional.one_hot`` makes one) and a CUDA
    graph can capture it."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(dtype)
