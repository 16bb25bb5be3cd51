"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
``paddle_tpu/serving/sampler.py``).

Determinism contract: the Gumbel noise of a draw comes from a
``torch.Generator`` seeded from ``(seed, position)``, where `position`
is the ABSOLUTE index of the token being sampled. Batch composition,
slot assignment and eviction/replay history cannot change a request's
tokens. The bits are not the reference's threefry bits, so sampled
tokens match the reference only when both are fed the same noise
(``noise=``); greedy tokens match it exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gumbel_noise", "sample_tokens"]

_NEG_INF = torch.finfo(torch.float32).min
_M64 = (1 << 64) - 1


def _mix(seed, position):
    """splitmix64 of (seed, position): one generator seed per draw."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def gumbel_noise(seed, position, vocab, device):
    """``[vocab]`` standard Gumbel draws determined by (seed, position)."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, position))
    u = torch.rand(vocab, generator=g, device=device, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


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
    host sequences -> token ids ``[B]`` int32 on logits' device.
    ``noise`` (``[B, V]``) replaces the Gumbel draws; otherwise greedy
    rows draw none.
    """
    dev = logits.device
    B, V = logits.shape
    temps = np.asarray(temperatures, np.float32)
    if noise is None:
        noise = torch.zeros(B, V, dtype=torch.float32, device=dev)
        for i in range(B):
            if temps[i] > 0.0:
                noise[i] = gumbel_noise(seeds[i], positions[i], V, dev)
    return _sample_rows(
        logits, torch.as_tensor(temps, device=dev),
        torch.as_tensor(np.asarray(top_ks, np.int32), device=dev),
        torch.as_tensor(np.asarray(top_ps, np.float32), device=dev),
        torch.as_tensor(noise, dtype=torch.float32, device=dev))
