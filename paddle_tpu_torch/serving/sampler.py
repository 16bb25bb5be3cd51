"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
``paddle_tpu/serving/sampler.py``).

Determinism contract: the Gumbel noise of a draw is
``jax.random.gumbel(fold_in(PRNGKey(seed), position), (V,), float32)``,
where `position` is the ABSOLUTE index of the token being sampled. Batch
composition, slot assignment and eviction/replay history cannot change a
request's tokens. The noise is the reference's (its bits exactly, its
values within the bound below) and one function on every device, so
sampled tokens equal the reference's on the same logits.

The threefry-2x32 path (the key, ``fold_in`` and the bits) is
:mod:`paddle_tpu_torch.framework.random`, the port's one copy of jax's,
which the global RNG key shares; on top of it:

- :func:`uniform` is ``random._uniform`` for f32: the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled to [tiny, 1);
- :func:`gumbel` is ``random._gumbel`` in its default mode ``"low"``
  (``jax_high_dynamic_range_gumbel`` is False): ``-log(-log(u))``.

The keys, bits and uniforms are jax's bit for bit. The two logs are not:
each platform's f32 ``log`` rounds its own way (XLA's CPU log differs
from the correctly rounded one in about one value in nine), and near
``u = 1/e`` the outer log turns one ulp of the inner into many of the
result. The port takes the correctly rounded log (computed in f64), so
its noise is one function on every device, within 2 ulp of each log of
any faithful implementation: ``|dg| <= 2 ulp(g) + 2^-22``.

Every word is a uint32 value held in ``torch.int64`` (torch's uint32
lacks the ops), masked with ``0xFFFFFFFF`` after each add and shift.
:func:`sample_tokens` draws the ``[B, V]`` noise of all rows in one
vectorised pass on the logits' device from ``[B]`` keys folded there,
with no host generator and no host read, so the draw can live inside a
captured graph. Seeds and positions keep their low 32 bits, as the
reference's int32 cast does.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.random import (fold_in, prng_key,
                                               random_bits, threefry2x32,
                                               uniform01)

__all__ = ["fold_in", "gumbel", "gumbel_noise", "prng_key", "random_bits",
           "sample_tokens", "threefry2x32", "uniform"]

_NEG_INF = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny


# ------------------------------------------------------------ threefry
# the threefry path itself lives in framework/random.py, shared with
# the global RNG key; these names stay importable from here


def uniform(key, n):
    """``jax.random.uniform(key, (n,), float32, minval=tiny)``: f32 in
    [tiny, 1), ``[..., n]``."""
    f = uniform01(random_bits(key, n))
    # (maxval - minval) is 1.0 in f32, so the scale is exact
    return torch.clamp_min(f * 1.0 + _TINY, _TINY)


def _log(x):
    """The correctly rounded f32 log (computed in f64), the same on every
    device."""
    return torch.log(x.double()).float()


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low"): standard
    Gumbel draws ``[..., n]``, ``-log(-log(u))`` with both logs correctly
    rounded."""
    return -_log(-_log(uniform(key, n)))


def gumbel_noise(seed, position, vocab, device):
    """``[vocab]`` standard Gumbel draws of ``fold_in(PRNGKey(seed),
    position)``, the reference's noise for one row."""
    return gumbel(fold_in(prng_key(seed, device), position), vocab)


# ------------------------------------------------------------ sampling
def _sample_rows(logits, temperatures, top_ks, top_ps, noise):
    """logits ``[B, V]``; per-row knobs ``[B]`` tensors; noise ``[B, V]``
    -> token ids ``[B]`` int32."""
    logits = logits.float()
    V = logits.shape[-1]

    # temperature; <=0 means greedy (selected at the end)
    scaled = logits / temperatures.clamp(min=1e-6)[:, None]

    # top-k: mask everything below the k-th largest logit (k<=0: off)
    k = torch.where(top_ks <= 0, V, top_ks.clamp(1, V)).long()
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(1, (k - 1).clamp(min=0)[:, None])
    scaled = torch.where(scaled < kth, _NEG_INF, scaled)

    # top-p (nucleus) over the top-k-filtered distribution: keep the
    # smallest prefix of descending-prob tokens whose mass reaches p
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sp, dim=-1)
    keep = (cum - sp) < top_ps[:, None]   # mass BEFORE this token < p
    keep[:, 0] = True                     # never drop the argmax
    pmin = torch.where(keep, sp, torch.inf).min(dim=-1, keepdim=True).values
    log_probs = torch.where(probs >= pmin, torch.log(probs), _NEG_INF)

    # Gumbel-max draw from the filtered distribution
    sampled = torch.argmax(log_probs + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperatures <= 0.0, greedy, sampled).to(torch.int32)


def _sample_row(logits, seed, position, temperature, top_k, top_p,
                noise=None):
    """One row: logits ``[V]`` -> token id (int). ``noise`` (``[V]``)
    replaces the Gumbel draw of (seed, position)."""
    dev = logits.device
    if noise is None:
        noise = gumbel_noise(seed, position, logits.shape[-1], dev)
    out = _sample_rows(
        logits[None], torch.tensor([temperature], dtype=torch.float32,
                                   device=dev),
        torch.tensor([top_k], dtype=torch.int32, device=dev),
        torch.tensor([top_p], dtype=torch.float32, device=dev),
        torch.as_tensor(noise, dtype=torch.float32, device=dev)[None])
    return int(out[0])


def sample_tokens(logits, seeds, positions, temperatures, top_ks, top_ps,
                  noise=None):
    """Batched sampling.

    logits ``[B, V]`` (a tensor on the sampling device); the per-row
    seeds/positions/top_ks (ints) and temperatures/top_ps (floats) are
    sequences, arrays or tensors on any device -> token ids ``[B]``
    int32 on logits' device. ``noise`` (``[B, V]``) replaces the Gumbel
    draws, which otherwise come from (seed, position) for every row in
    one pass on the logits' device, greedy rows too (they ignore
    theirs), as the reference's traced sampler draws them. Given tensors
    on the logits' device it reads nothing back to the host, so a CUDA
    graph can capture it.
    """
    dev = logits.device

    def on_dev(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if noise is None:
        key = fold_in(prng_key(on_dev(seeds, torch.int64)),
                      on_dev(positions, torch.int64))
        noise = gumbel(key, logits.shape[-1])
    return _sample_rows(
        logits, on_dev(temperatures, torch.float32),
        on_dev(top_ks, torch.int32), on_dev(top_ps, torch.float32),
        on_dev(noise, torch.float32))
