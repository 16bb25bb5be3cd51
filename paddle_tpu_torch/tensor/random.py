"""Random tensors from the global key (counterpart of
``paddle_tpu/tensor/random.py``)."""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.framework.random import (key_words, random_bits,
                                               uniform01)
from paddle_tpu_torch.framework.state import next_key

__all__ = ["rand"]


def rand(shape, dtype=None, device=None):
    """Uniforms in [0, 1) of ``shape`` from a fresh split of the global
    key: ``jax.random.uniform(next_key(), shape, float32)``'s values for
    the same seed (the reference's ``rand``). The key is a device
    tensor, so a captured step draws fresh values at every replay.
    ``device`` is the key's (default where it lies); f32 only."""
    if dtype not in (None, "float32", torch.float32):
        raise NotImplementedError(f"rand(dtype={dtype!r}): float32 only")
    shape = tuple(int(s) for s in shape)
    bits = random_bits(key_words(next_key(device)), math.prod(shape))
    return uniform01(bits).reshape(shape)
