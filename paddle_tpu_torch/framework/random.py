"""jax's threefry-2x32 random bits in torch integer ops: the port's one
copy, shared by the sampler (:mod:`paddle_tpu_torch.serving.sampler`)
and the global RNG key (:mod:`paddle_tpu_torch.framework.state`).

It follows the jax release the reference is tested with (0.9.0), where
``jax_threefry_partitionable`` is True:

- :func:`threefry2x32` is ``jax._src.prng._threefry2x32_lowering`` (20
  rounds, key schedule ``k1 ^ k2 ^ 0x1BD11BDA``);
- :func:`prng_key` is ``threefry_seed`` of a 32-bit seed: the seed is
  padded with a zero high word, ``(0, seed)``;
- :func:`fold_in` is ``threefry_fold_in``: the hash of the counter pair
  ``(0, data)`` under the key;
- :func:`split` is ``_threefry_split_foldlike``: key ``i`` of the split
  is both output words of the counter pair ``(0, i)``;
- :func:`random_bits` is ``_threefry_random_bits_partitionable``:
  counter words ``iota_2x32_shape`` (high, low) of the flat row-major
  index and 32-bit bits ``bits1 ^ bits2``;
- :func:`bernoulli` is ``random.bernoulli`` in its default mode
  ``"low"``: a uniform f32 in [0, 1) from the top 23 bits, below ``p``
  rounded to f32.

A key is a pair of word tensors ``(k1, k2)``. Every word is a uint32
value held in ``torch.int64`` (torch's uint32 lacks the ops), masked
with ``0xFFFFFFFF`` after each add and shift. Everything runs on the
keys' device with no host read, so a CUDA graph can capture it; the
keep-mask kernel (:mod:`paddle_tpu_torch.ops.cuda.random`) draws the
same bits on the card in one launch.
"""
from __future__ import annotations

import math

import torch

__all__ = ["bernoulli", "fold_in", "key_words", "prng_key", "random_bits",
           "split", "threefry2x32", "uniform01"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
MANTISSA_ONE = 0x3F800000          # the bits of 1.0f


def _u32(x, device=None):
    """Integers (or an integer tensor) as int64 uint32 words: the low 32
    bits, as an int32 cast followed by a bit cast to uint32 gives them."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key
    ``(k1, k2)``: int64 tensors of uint32 values that broadcast together.
    Returns the two output words.

    Only the word that is rotated must hold 32 clean bits; the other
    carries its sums' high bits (below 2^38 after all 20 rounds, far from
    overflow) until the end, which saves a mask a round."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a, b = x1 + ks[0], (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = (((b << r) | (b >> (32 - r))) ^ a) & M32
        a = a + ks[(i + 1) % 3]
        b = (b + (ks[(i + 2) % 3] + (i + 1))) & M32
    return a & M32, b


def prng_key(seed, device=None):
    """``PRNGKey(seed)`` of a 32-bit seed (an int or an integer tensor of
    any shape, cast to int32): the key words ``(0, seed)``."""
    k2 = _u32(seed, device)
    return torch.zeros_like(k2), k2


def key_words(t):
    """A key held as one ``[..., 2]`` word tensor (the global key's
    form, ``jax.random.key_data``'s layout) as the pair ``(k1, k2)``."""
    return t[..., 0], t[..., 1]


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key from a key and 32-bit
    data (broadcast together)."""
    k1, k2 = key
    d = _u32(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def split(key, num=2):
    """``jax.random.split(key, num)``: ``(k1, k2)`` words of shape
    ``[..., num]``; key ``i`` is ``(k1[..., i], k2[..., i])``."""
    k1, k2 = (k[..., None] for k in key)
    lo = torch.arange(num, dtype=torch.int64, device=k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)``: ``[..., n]`` uint32 words
    (int64) for keys of shape ``[...]``; the bits of a shape are those of
    its element count, in row-major order."""
    k1, k2 = (k[..., None] for k in key)
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, lo >> 32, lo & M32)
    return b1 ^ b2


def uniform01(bits):
    """The f32 uniforms in [0, 1) that jax makes of 32-bit words: the top
    23 bits as the mantissa of a float in [1, 2), minus 1 (exact)."""
    mant = (bits >> 9) | MANTISSA_ONE                    # < 2^31
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    a bool tensor, True where the uniform is below ``p`` as an f32."""
    n = math.prod(shape)
    u = uniform01(random_bits(key, n))
    return (u < torch.full((), p, dtype=torch.float32,
                           device=u.device)).reshape(shape)
