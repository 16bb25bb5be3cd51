"""Dropout's keep-mask kernel (``csrc/random.cu``): wrapper, plain
version and launch count.

:func:`keep_mask` is one draw from the global key: it splits the key
(``new, sub = jax.random.split(key)``), writes ``new`` over the key in
place, and returns ``jax.random.bernoulli(sub, keep_prob, shape)`` as
1 where an element is kept and 0 where it is dropped, in the type asked
for (bool, f32, bf16 or f16), with ``sub``. It replaces no Pallas
kernel: it is the fusion the reference's dropout compiles to
(``paddle_tpu/nn/functional/common.py:141``,
``paddle_tpu/nn/functional/transformer.py:39-42``), bit for bit with
the installed jax, counter layout included.

A wrapper given a CPU key computes the plain version (the torch
threefry of :mod:`paddle_tpu_torch.framework.random`); given a CUDA key
it launches the kernel on the current stream, without synchronising,
or raises. The kernel reads the key words from device memory and the
wrapper copies the new key over the old one on the device, so a draw
reads nothing back to the host and a CUDA graph can capture it.
``LAUNCHES["keep_mask"]`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.framework import random as threefry
from paddle_tpu_torch.ops.cuda import cost, launch

__all__ = ["LAUNCHES", "keep_mask"]

LAUNCHES = launch.counts(("keep_mask",))
_OUT_TYPES = {torch.bool: 0, torch.float32: 1, torch.bfloat16: 2,
              torch.float16: 3}

_P = ctypes.c_void_p
_SIGNATURES = {"rng_keep_mask": [_P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float,
                                 ctypes.c_int, _P]}


def _keep_mask_ref(key, keep_prob, shape, dtype):
    """Plain version of :func:`keep_mask`."""
    k1, k2 = threefry.split(threefry.key_words(key))
    sub = (k1[1], k2[1])
    keep = threefry.bernoulli(sub, keep_prob, shape)
    key.copy_(torch.stack([k1[0], k2[0]]))
    return keep.to(dtype), torch.stack(sub)


@launch.booked(cost.keep_mask)
def keep_mask(key, keep_prob, shape, dtype=torch.bool):
    """One draw from ``key`` (the ``[2]`` int64 words of a threefry key,
    advanced in place to ``split(key)[0]``): ``(keep, sub)``, ``keep``
    the ``shape`` mask of ``bernoulli(sub, keep_prob)`` in ``dtype`` (1
    kept, 0 dropped), ``sub = split(key)[1]`` as ``[2]`` words. A shape
    with no element (``(0,)``) draws nothing but still splits the key."""
    if dtype not in _OUT_TYPES:
        raise TypeError(f"keep_mask: dtype {dtype} not supported "
                        f"({', '.join(map(str, _OUT_TYPES))})")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"keep_mask: the key must be 2 int64 words, got "
                         f"{key.dtype} {tuple(key.shape)}")
    shape = tuple(int(s) for s in shape)
    if launch.route("keep-mask", key) == "cpu":
        return _keep_mask_ref(key, keep_prob, shape, dtype)
    if not key.is_contiguous():
        raise ValueError("keep_mask: the key must be contiguous")
    dev = key.device
    n = math.prod(shape)
    words = torch.empty(4, dtype=torch.int64, device=dev)   # new key, sub
    out = torch.empty(shape, dtype=dtype, device=dev)
    rc = launch.bind(_SIGNATURES).rng_keep_mask(
        key.data_ptr(), words.data_ptr(), words[2:].data_ptr(),
        out.data_ptr() if n else None, _OUT_TYPES[dtype], n,
        float(keep_prob), dev.index, launch.stream(dev))
    launch.raise_on(rc, "rng_keep_mask")
    LAUNCHES["keep_mask"] += 1
    key.copy_(words[:2])
    return out, words[2:]
